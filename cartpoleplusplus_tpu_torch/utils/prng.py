"""Counter-based stateless PRNG — cartpoleplusplus_tpu/utils/prng.py, bit
for bit.

Every env and exploration draw is a pure function of integer words (env
seed, episode, step, repeat, stream tag), so the plain torch path, the
CUDA kernels (csrc/cartpole_env.cuh) and the JAX reference produce the
identical sequence.

torch has no uint32 `>>` or `+` on the CPU, so a word is carried as an
int64 tensor (or a Python int) holding a value in [0, 2**32), and every
multiply and add is masked back to 32 bits. The int64 product of two
32-bit values may wrap, but its low 32 bits stay right.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_TWO_PI_F32 = float(np.float32(2.0 * np.pi))


def as_words(x, device=None) -> torch.Tensor:
    """Integers (Python, numpy or any torch integer dtype) -> int64 words
    in [0, 2**32), wrapping negatives the way a uint32 cast does."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _M32


def triple32(x):
    """Bijective 32-bit mixer on words (int64 tensor or Python int)."""
    x = x & _M32
    x = x ^ (x >> 17)
    x = (x * 0xED5AD4BB) & _M32
    x = x ^ (x >> 11)
    x = (x * 0xAC4C1B51) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x31848BAB) & _M32
    x = x ^ (x >> 14)
    return x


def hash_words(*words):
    """Combine integer words (broadcast together) into one 32-bit word.
    Tensor words of any integer dtype are widened to int64 first (int32
    step counters wrap like the reference's uint32 cast)."""
    h = 0x243F6A88  # pi fraction
    for w in words:
        if isinstance(w, torch.Tensor):
            w = w.to(torch.int64)
        h = triple32(((h + _GOLDEN) & _M32) ^ (w & _M32))
    return h


def uniform_from_bits(bits, lo=0.0, hi=1.0):
    """32-bit words -> float32 uniform in [lo, hi) from the top 24 bits."""
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return lo + u * (hi - lo)


def uniform(lo, hi, *words):
    """One uniform draw per element of the broadcast word tensors."""
    return uniform_from_bits(hash_words(*words), lo, hi)


def normal(*words):
    """One standard-normal draw per element: Box-Muller over two
    tag-salted counter streams (0xB0, 0xB1)."""
    u1 = uniform_from_bits(hash_words(*words, 0xB0), lo=2.0 ** -24, hi=1.0)
    u2 = uniform_from_bits(hash_words(*words, 0xB1))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI_F32 * u2)


def gumbel(*words):
    """One standard-Gumbel draw per element, -log(-log(u)), over the
    tag-salted stream 0xB2 with u in [2^-24, 1) so both logs are finite:
    argmax(logits + g) is an exact softmax sample."""
    u = uniform_from_bits(hash_words(*words, 0xB2), lo=2.0 ** -24, hi=1.0)
    return -torch.log(-torch.log(u))


# --- jax.random's key derivation, for the env reset seeds only -------------
#
# The reference resets its envs with seeds folded from split jax.random
# keys. These numpy functions reproduce that derivation (threefry2x32 with
# 20 rounds, `split` as jax_threefry_partitionable computes it), so the port
# resets the same envs at the same seed. Network init and replay draws stay
# the port's own torch.Generator streams.

_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under the
    key (k0, k1); uint32 numpy arrays in, the two output words out."""
    u32 = np.uint32
    k0, k1 = u32(key[0]), u32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ u32(0x1BD11BDA))
    x0 = np.asarray(x0, u32) + ks[0]
    x1 = np.asarray(x1, u32) + ks[1]
    for i in range(5):
        for r in _THREEFRY_ROT[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << u32(r)) | (x1 >> u32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + u32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) for an int32 seed: uint32 words (0, seed)."""
    return np.array([0, seed & _M32], np.uint32)


def split_key(key, num: int) -> np.ndarray:
    """jax.random.split(key, num) of a raw uint32[2] key: (num, 2) uint32,
    key i = threefry2x32(key, (0, i))."""
    with np.errstate(over="ignore"):
        hi, lo = threefry2x32(key, np.zeros(num, np.uint32),
                              np.arange(num, dtype=np.uint32))
    return np.stack([hi, lo], axis=-1)


def key_seed(key) -> int:
    """The reference's `to_seed` of a raw key: its words XOR-folded."""
    words = np.asarray(key, np.uint32).reshape(-1)
    return int(np.bitwise_xor.reduce(words))


def split_seed(seed: int, num: int, index: int) -> int:
    """to_seed(jax.random.split(PRNGKey(seed), num)[index]): the env reset
    seed the reference derives from the integer `seed`."""
    return key_seed(split_key(prng_key(seed), num)[index])
