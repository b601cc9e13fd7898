"""The port's counter PRNG (cartpoleplusplus_tpu_torch/utils/prng.py)
against the literal fixtures of tests/test_prng.py and against the JAX
functions: triple32 and hash_words bit for bit, uniform and normal within
one float32 ulp."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu.utils import prng as jprng
from cartpoleplusplus_tpu_torch.utils import prng as tprng
from test_prng import (
    HASH_WORDS_TABLE,
    TRIPLE32_TABLE,
    _py_hash_words,
)

N = 100_000


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _words(seed, shape=(N,)):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def test_literals():
    for x, want in TRIPLE32_TABLE.items():
        assert int(tprng.triple32(tprng.as_words(x))) == want
        assert tprng.triple32(x) == want  # Python ints take the same path
    for words, want in HASH_WORDS_TABLE.items():
        got = tprng.hash_words(*[tprng.as_words(w) for w in words])
        assert int(got) == want, words
    got = float(tprng.uniform(0.0, 1.0, tprng.as_words(5), 6))
    assert got == (_py_hash_words(5, 6) >> 8) / (1 << 24)


@pytest.mark.parametrize("nwords", [1, 3, 5])
def test_bitwise_against_jax(nwords):
    ws = _words(nwords, (nwords, N))
    jx = [jnp.asarray(w) for w in ws]
    tx = [tprng.as_words(w.astype(np.int64)) for w in ws]
    np.testing.assert_array_equal(
        tprng.triple32(tx[0]).numpy(),
        np.asarray(jprng.triple32(jx[0])).astype(np.int64))
    np.testing.assert_array_equal(
        tprng.hash_words(*tx).numpy(),
        np.asarray(jprng.hash_words(*jx)).astype(np.int64))


def test_int32_words_wrap_like_uint32():
    """Negative int32 counters hash as their uint32 bit pattern."""
    w = np.array([-1, -7, 5, 2**31 - 1], np.int32)
    got = tprng.hash_words(torch.from_numpy(w), 0x21).numpy()
    want = np.asarray(jprng.hash_words(jnp.asarray(w).astype(jnp.uint32),
                                       np.uint32(0x21)))
    np.testing.assert_array_equal(got, want.astype(np.int64))


def _ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))


def test_uniform_bitwise_normal_within_ulps():
    """uniform is bit for bit. normal = sqrt(-2 log u1) * cos(2 pi u2):
    its uniforms are bit for bit, each factor is within 1 ulp (libm's
    log and cos differ from XLA's by that), so the product is held within
    3 ulps of its own magnitude."""
    ws = _words(11, (2, N))
    jx = [jnp.asarray(w) for w in ws]
    tx = [tprng.as_words(w.astype(np.int64)) for w in ws]
    for lo, hi in [(0.0, 1.0), (-1.0, 1.0), (0.2, 1.0),
                   (0.0, 2.0 * np.pi)]:
        got = tprng.uniform(lo, hi, *tx).numpy()
        want = np.asarray(jprng.uniform(lo, hi, *jx))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=str((lo, hi)))

    def factors(lib, p, words, tag):
        u1 = p.uniform_from_bits(p.hash_words(*words, tag, 0xB0),
                                 lo=np.float32(2.0 ** -24), hi=1.0)
        u2 = p.uniform_from_bits(p.hash_words(*words, tag, 0xB1))
        return (np.asarray(lib.sqrt(-2.0 * lib.log(u1))),
                np.asarray(lib.cos(np.float32(2.0 * np.pi) * u2)))

    t_r, t_c = factors(torch, tprng, tx, 0x41)
    j_r, j_c = factors(jnp, jprng, jx, np.uint32(0x41))
    assert _ulps(t_r, j_r).max() <= 1.0
    assert (np.abs(t_c - j_c) <= np.spacing(np.float32(1.0))).all()
    got = tprng.normal(*tx, 0x41).numpy()
    want = np.asarray(jprng.normal(*jx, np.uint32(0x41)))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_array_equal(got, t_r * t_c)
    assert _ulps(got, want).max() <= 3.0
