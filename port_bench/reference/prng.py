"""The counter-based PRNG of the cart-pole's env and exploration draws, and
the key derivation of the env reset seeds, in plain PyTorch and NumPy.

A frozen copy of the semantics the program documents: every draw is a pure
function of 32-bit words (env seed, episode, step, repeat, stream tag).
Words are int64 tensors holding values in [0, 2**32); every multiply and
add is masked back to 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_TWO_PI_F32 = float(np.float32(2.0 * np.pi))


def triple32(x):
    x = x & M32
    x = x ^ (x >> 17)
    x = (x * 0xED5AD4BB) & M32
    x = x ^ (x >> 11)
    x = (x * 0xAC4C1B51) & M32
    x = x ^ (x >> 15)
    x = (x * 0x31848BAB) & M32
    x = x ^ (x >> 14)
    return x


def hash_words(*words):
    h = 0x243F6A88
    for w in words:
        if isinstance(w, torch.Tensor):
            w = w.to(torch.int64)
        h = triple32(((h + _GOLDEN) & M32) ^ (w & M32))
    return h


def uniform_from_bits(bits, lo=0.0, hi=1.0):
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return lo + u * (hi - lo)


def uniform(lo, hi, *words):
    return uniform_from_bits(hash_words(*words), lo, hi)


def normal(*words):
    """Box-Muller over the tag-salted streams 0xB0 and 0xB1."""
    u1 = uniform_from_bits(hash_words(*words, 0xB0), lo=2.0 ** -24, hi=1.0)
    u2 = uniform_from_bits(hash_words(*words, 0xB1))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI_F32 * u2)


_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key, x0, x1):
    u32 = np.uint32
    k0, k1 = u32(key[0]), u32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ u32(0x1BD11BDA))
    x0 = np.asarray(x0, u32) + ks[0]
    x1 = np.asarray(x1, u32) + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << u32(r)) | (x1 >> u32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + u32(i + 1)
    return x0, x1


def split_seed(seed: int, num: int, index: int) -> int:
    """The XOR-folded words of key `index` of a threefry split into `num`
    of the key (0, seed mod 2**32): the env reset seed of a run's seed."""
    key = np.array([0, seed & M32], np.uint32)
    with np.errstate(over="ignore"):
        hi, lo = _threefry2x32(key, np.zeros(num, np.uint32),
                               np.arange(num, dtype=np.uint32))
    return int(hi[index] ^ lo[index])
