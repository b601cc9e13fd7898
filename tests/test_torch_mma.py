"""The tensor cores' products of B3 and B9 on the CPU: the modes that take
them, the tensor-core probe's plain version (`mma_chain`) and its operands
against exact arithmetic and against the JAX package's own dot, the probe's
wrapper, and B9's shared-memory plan at those modes (its packed weight
copies) over the torsos the reference's learner kernels take.

The kernels run only on the card (tests/test_torch_cuda.py holds them to
their twins there); here the host-side plan and the plain versions are
checked. Inputs come from numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu.ops import learner_kernel as jlk
from cartpoleplusplus_tpu_torch.ops import _native
from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk

F = 42
TC = [lk.BF16, lk.TF32, lk.X3, lk.X6, lk.F16]
TC_IDS = [lk.MODE_NAMES[m] for m in TC]
# Torsos of the reference's learner kernels: B9 takes any depth >= 1 and
# any width, B3 any depth >= 2 (the critic's action joins at layer 1).
TORSOS = [(1,), (3,), (8,), (64,), (139,), (140,), (2048,), (15, 17),
          (16, 16), (40, 72), (64, 64), (72, 40), (84, 84), (85, 85),
          (256, 256), (256, 300), (3,) * 12, (8,) * 5, (32, 48, 16),
          (72, 40, 24), (1024,) * 4]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _parts(x: np.ndarray, mode: int) -> list:
    """The operand as `mode` takes it: X3's and X6's bfloat16 parts, else
    the rounded operand (float64 arrays)."""
    t = torch.from_numpy(x)
    if mode in (lk.X3, lk.X6):
        return [p.numpy().astype(np.float64)
                for p in lk.split_operand(t, mode)]
    return [lk.round_operand(t, mode).numpy().astype(np.float64)]


def _passes(mode: int):
    return {lk.X3: ((1, 0), (0, 1), (0, 0)),
            lk.X6: ((1, 1), (2, 0), (0, 2), (1, 0), (0, 1),
                    (0, 0))}.get(mode, ((0, 0),))


def test_tensor_core_modes_and_ids():
    """bfloat16, TF32, X3, X6 and F16 run on the tensor cores in B9,
    bfloat16, X3 and F16 in B3 (mm_tc in csrc/learner_stages.cuh, kTcMode
    in csrc/ddpg_update.cu); float32 and F64 keep their chains. An id is
    the mode plus INSTANCE_TC; no launch has written one on the CPU."""
    assert lk.TC_MODES == (lk.BF16, lk.TF32, lk.X3, lk.X6, lk.F16)
    assert lk.TC_MODES_OF == {"B3": (lk.BF16, lk.X3, lk.F16),
                              "B9": lk.TC_MODES}
    assert lk.F32 not in lk.TC_MODES and lk.F64 not in lk.TC_MODES
    assert lk.INSTANCE_TC == 16 and len(lk.MODE_NAMES) < lk.INSTANCE_TC
    assert lk.last_instance("B3", "cpu") == -1
    assert lk.last_instance("B9", "cpu") == -1


@pytest.mark.parametrize("mode", TC, ids=TC_IDS)
def test_probe_operands_make_every_block_sum_exact(mode):
    """`mma_probe_operands`: the parts sum to the operand, and every
    k-block's part product (16 terms, 8 at TF32) is exact in float32 under
    any order of its additions: each partial sum of its terms lies on the
    terms' common grid within 24 bits."""
    a, b = lk.mma_probe_operands(np.random.RandomState(5), mode)
    pa, pb = _parts(a, mode), _parts(b, mode)
    assert np.array_equal(sum(pa), a.astype(np.float64))
    assert np.array_equal(sum(pb), b.astype(np.float64))
    step = 8 if mode == lk.TF32 else 16
    for k0 in range(0, a.shape[1], step):
        for i, j in _passes(mode):
            terms = pa[i][:, None, k0:k0 + step] * pb[j].T[None, :,
                                                           k0:k0 + step]
            mant, exp = np.frexp(np.abs(terms[terms != 0]))
            m = (mant * 2.0 ** 53).astype(np.int64)
            low = exp - 53 + np.log2(m & -m).astype(np.int64)
            grid = 2.0 ** low.min()  # every term a multiple of it
            assert np.abs(terms).sum(-1).max() < 2.0 ** 24 * grid


@pytest.mark.parametrize("mode", TC, ids=TC_IDS)
def test_mma_chain_is_the_blockwise_float32_sum(mode):
    """The probe's plain version against a loop written out element by
    element: each block's part products summed exactly (fractions of the
    float32 values), rounded to float32 and added into a float32 sum in the
    passes' order; F16 rounds the result to float16."""
    from fractions import Fraction

    a, b = lk.mma_probe_operands(np.random.RandomState(6), mode, rows=16,
                                 k=37, cols=8)
    got = lk.mma_chain(a, b, mode)
    pa, pb = _parts(a, mode), _parts(b, mode)
    step = 8 if mode == lk.TF32 else 16
    for r in range(16):
        for c in range(8):
            acc = np.float32(0.0)
            for k0 in range(0, 37, step):
                for i, j in _passes(mode):
                    s = sum(Fraction(float(pa[i][r, q])) *
                            Fraction(float(pb[j][q, c]))
                            for q in range(k0, min(k0 + step, 37)))
                    acc = np.float32(acc + np.float32(float(s)))
            if mode == lk.F16:
                acc = np.float32(np.float16(acc))
            assert got[r, c].view(np.uint32) == acc.view(np.uint32), (r, c)


@pytest.mark.parametrize("mode", TC, ids=TC_IDS)
def test_mma_chain_against_the_jax_dot(mode):
    """The probe's plain version on general operands (lk.probe_operands:
    every mantissa bit set, sums that cancel) against the JAX package's
    own dot (ops/learner_kernel.py::_dot, at 'highest') on the same
    rounded operands or parts, pass by pass: within float32's summation
    rounding of the sum of the terms' magnitudes (different orders)."""
    a, b = lk.probe_operands(np.random.RandomState(7), rows=32, k=100,
                             cols=24)
    got = lk.mma_chain(a, b, mode)
    pa, pb = _parts(a, mode), _parts(b, mode)
    want, mag = np.zeros(got.shape, np.float32), np.zeros(got.shape)
    with jax.default_matmul_precision("highest"):
        for i, j in _passes(mode):
            want = want + np.asarray(jlk._dot(
                jnp.asarray(pa[i].astype(np.float32)),
                jnp.asarray(pb[j].astype(np.float32))))
            mag = mag + np.abs(pa[i]) @ np.abs(pb[j])
    if mode == lk.F16:
        want = want.astype(np.float16).astype(np.float32)
        mag = mag + np.abs(want) * 2.0 ** -10
    bar = 1e-6 * mag + 1e-30
    assert np.all(np.abs(got.astype(np.float64) - want) <= bar)


def test_mma_split_on_the_cpu_is_the_split():
    """mma_split on a CPU tensor is mm_split (the hardware's conversions on
    the card are held to it bit for bit); a mode off the tensor cores or
    a tensor of another rank raises."""
    x = torch.from_numpy(np.random.RandomState(12).normal(
        size=100).astype(np.float32))
    for mode in TC:
        assert torch.equal(lk.mma_split(x, mode), lk.mm_split(x, mode))
    for mode in (lk.F32, lk.F64):
        with pytest.raises(ValueError):
            lk.mma_split(x, mode)
    with pytest.raises(ValueError):
        lk.mma_split(x.reshape(10, 10), lk.BF16)


def test_mma_probe_wrapper_on_the_cpu():
    """mma_probe on CPU tensors runs mma_chain; a shape the probe kernel
    does not tile (rows not a multiple of 16, columns not of 8) or a mode
    off the tensor cores raises."""
    a, b = lk.mma_probe_operands(np.random.RandomState(8), lk.X3, rows=32,
                                 k=40, cols=16)
    got = lk.mma_probe(torch.from_numpy(a), torch.from_numpy(b), lk.X3)
    assert np.array_equal(got.numpy().view(np.uint32),
                          lk.mma_chain(a, b, lk.X3).view(np.uint32))
    for rows, cols in ((24, 16), (32, 12)):
        with pytest.raises(ValueError):
            lk.mma_probe(torch.zeros(rows, 40), torch.zeros(40, cols),
                         lk.BF16)
    for mode in (lk.F32, lk.F64):
        with pytest.raises(ValueError):
            lk.mma_probe(torch.zeros(16, 40), torch.zeros(40, 8), mode)


def _packed_words(obs_dim, hidden, mode) -> int:
    """B9's packed weight copy counted matrix by matrix from its
    definition: per part, rows of 16-padded outputs, each holding the
    16-padded inputs (two 16-bit values a word; TF32 one) and 4 words."""
    parts = {lk.X3: 2, lk.X6: 3}.get(mode, 1)
    total = 0
    for k, n in zip((obs_dim,) + tuple(hidden),
                    tuple(hidden) + (lk.NUM_ACTIONS,)):
        kp, npad = -(-k // 16) * 16, -(-n // 16) * 16
        row = kp + 4 if mode == lk.TF32 else kp // 2 + 4
        assert row % 32 in (4, 12, 20, 28)  # the fragment loads' banks
        total += parts * npad * row
    return total


@pytest.mark.parametrize("hidden", TORSOS, ids=str)
def test_b9_plan_at_the_tensor_core_modes(hidden):
    """At each tensor-core mode B9's shared-memory block holds the packed
    weights (`pg_weight_floats`, counted here from the definition) beside
    the float32 accumulators and the tile; it takes the shared-memory route
    exactly where that block fits, covers the torso on either route, and
    its pass-1 plan and workspace follow the route as at float32. Every
    torso of the reference's kernel is taken at every mode."""
    p = lk.layout_size(lk.policy_layout(F, hidden))
    tile = lk.pg_tile_floats(F, hidden)
    for mode in TC:
        words = lk.pg_weight_floats(F, hidden, mode)
        assert words == _packed_words(F, hidden, mode)
        smem = lk.pg_smem_floats(F, hidden, mode)
        assert smem == words + -(-(p + 1) // 4) * 4 + tile
        spills = lk.pg_tile_spills(F, hidden, mode)
        assert spills == (4 * smem > _native.MAX_SMEM)
        assert lk.lrpg_covers(F, hidden)
        rows, rpb, blocks = lk.pg_plan(F, hidden, 777, mode)
        assert rows == 64 and rpb % 64 == 0 and blocks * rpb >= 777
        assert lk.pg_plan(F, hidden, 777, mode) == lk.pg_plan(
            F, hidden, 777, lk.F32 if spills == lk.pg_tile_spills(
                F, hidden) else mode)
        ws = lk.pg_workspace_floats(F, hidden, 777, mode)
        assert ws >= blocks * (p + 1) and ws <= lk.PG_WORK_FLOATS + 32
    assert lk.pg_weight_floats(F, hidden) == lk.pg_weight_floats(
        F, hidden, lk.F64)


def test_b9_keeps_its_block_in_shared_memory_at_the_defaults():
    """At LRPG's default hidden (64, 64) every mode keeps B9's block in
    shared memory: the packed copies take 18,688 bytes at bfloat16 and
    F16, twice that at X3, three times at X6, 35,072 at TF32, against
    29,184 for the float32 transposed copy."""
    hidden = (64, 64)
    assert 4 * lk.pg_weight_floats(F, hidden) == 29_184
    want = {lk.BF16: 18_688, lk.F16: 18_688, lk.X3: 37_376, lk.X6: 56_064,
            lk.TF32: 35_072}
    for mode, nbytes in want.items():
        assert 4 * lk.pg_weight_floats(F, hidden, mode) == nbytes
        assert not lk.pg_tile_spills(F, hidden, mode)
