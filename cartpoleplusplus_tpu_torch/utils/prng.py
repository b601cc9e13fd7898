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
