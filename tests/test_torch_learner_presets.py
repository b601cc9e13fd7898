"""The dot-algorithm presets of `learner_precision` on the kernel learners
(B3, B5, B7, B9) on the CPU: the bfloat16 split of BF16_BF16_F32_X3 and
_X6 against numpy on float32 bit patterns, the twins' products at X3, X6,
F64 and F16 against float64 oracles of their definitions
(ops.learner_kernel.mm_mode), the probe's plain version against exact
arithmetic, the aliases F32_F32_F32 and BF16_BF16_F32 bit for bit, each
twin against the JAX package's kernel entry at the same name (in Pallas
interpret mode; on the CPU it computes float32 at BF16_BF16_F32_X3 and
_X6, float64 products at F64_F64_F64 and float16 results at F16_F16_F16),
train steps at X3 and F64 against the JAX agents' kernel learners, and
the CLI flag with a resume at each new name.

Inputs come from numpy with a seed; the phases start from the warmed
states of the learners' own parity tests (test_torch_learner_precision.py
holds them).
"""

import functools
import json
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu.ops import learner_kernel as jlk
from cartpoleplusplus_tpu_torch.models.from_jax import unflatten_naf
from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk
import test_torch_dqn_learner as dqn_t
import test_torch_learner_kernel as ddpg_t
import test_torch_learner_precision as prec_t
import test_torch_lrpg_learner as lrpg_t
import test_torch_naf_learner as naf_t
from test_torch_learner_precision import (AGENTS, HIDDEN, K, PHASES,
                                          REF_TOL, EDGE_BITS, _flat, _oracle)

# The bars at which the port's float32 twins are held to the JAX package
# (test_torch_learner_kernel.py, test_torch_dqn_learner.py,
# test_torch_naf_learner.py: rtol 1e-5, atol 1e-6;
# test_torch_lrpg_learner.py: rtol 1e-5, atol 1e-7).
F32_TOL = {"ddpg": dict(rtol=1e-5, atol=1e-6), "dqn": dict(rtol=1e-5,
                                                            atol=1e-6),
           "naf": dict(rtol=1e-5, atol=1e-6), "lrpg": dict(rtol=1e-5,
                                                            atol=1e-7)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# --- the split ------------------------------------------------------------

def _bf16(bits: np.ndarray) -> np.ndarray:
    """bfloat16 rounding (to nearest even) of float32 bit patterns by the
    float64 oracle of test_torch_learner_precision.py."""
    return _oracle(bits.astype(np.uint32), 7, True)


def _split_oracle(bits: np.ndarray, n_parts: int) -> list:
    """The parts of the definition in float64 arithmetic: hi = bf16(x),
    each residual x - hi (- mid) exact in float64 and then rounded to
    float32 (where it is exact too), zero where hi is not finite."""
    with np.errstate(invalid="ignore"):
        x = bits.view(np.float32).astype(np.float64)
    hi = _bf16(bits).view(np.float32)
    parts, rest = [hi], np.zeros_like(x)
    fin = np.isfinite(hi)
    rest[fin] = x[fin] - hi[fin].astype(np.float64)
    for _ in range(n_parts - 1):
        r32 = rest.astype(np.float32)
        assert np.array_equal(r32.astype(np.float64), rest)  # exact
        part = _bf16(r32.view(np.uint32)).view(np.float32)
        parts.append(part)
        rest = rest - part.astype(np.float64)
    return parts


@pytest.mark.parametrize("mode", [lk.X3, lk.X6], ids=["x3", "x6"])
def test_split_against_numpy(mode):
    """split_operand on the edge patterns of the rounding tests (ties,
    subnormals, +-0, +-inf, NaNs, bfloat16's overflow edge) and 20,000
    random bit patterns against the float64 oracle, bit for bit: every
    part a bfloat16 value, X6's hi + mid + lo == x for every normal x from
    2^-110 up to the values that bfloat16 rounds to infinity (X3's hi + lo
    within 2^-17 of x), and a NaN
    or an infinity (or a value past that edge) whole in hi with zero
    residuals."""
    rng = np.random.RandomState(1)
    bits = np.concatenate([EDGE_BITS, rng.randint(0, 2 ** 32, 20000,
                                                  dtype=np.uint64)
                           .astype(np.uint32)])
    x = torch.from_numpy(bits.view(np.float32).copy())
    n = 2 if mode == lk.X3 else 3
    got = [p.numpy() for p in lk.split_operand(x, mode)]
    want = _split_oracle(bits, n)
    assert len(got) == n
    for g, w in zip(got, want):
        nan = np.isnan(w)
        assert np.array_equal(np.isnan(g), nan)
        np.testing.assert_array_equal(g[~nan].view(np.uint32),
                                      w[~nan].view(np.uint32))
        assert not (g[~nan].view(np.uint32) & 0xFFFF).any()
    xf = bits.view(np.float32)
    with np.errstate(invalid="ignore"):
        finite_hi = np.isfinite(got[0])
        normal = (np.abs(xf) >= 2.0 ** -110) & finite_hi
        total = sum(p.astype(np.float64) for p in got)
        x64 = xf[normal].astype(np.float64)
        if mode == lk.X6:
            assert np.array_equal(total[normal], x64)
            # the lowest part is needed: without it the sum is short
            short = (got[0].astype(np.float64) + got[1])[normal]
            assert (short != x64).mean() > 0.9
        else:  # X3's two parts hold 16 of the 24 bits
            assert (np.abs(total[normal] - x64) <= 2.0 ** -17
                    * np.abs(x64)).all()
    whole = ~finite_hi
    assert whole.sum() >= 5
    for p in got[1:]:
        assert not p[whole].any()
    edge = {b: i for i, b in enumerate(EDGE_BITS)}
    assert got[0][edge[0x7F7F8000]] == np.inf   # rounds past the largest
    assert got[0].view(np.uint32)[edge[0x7F7F7FFF]] == 0x7F7F0000
    assert got[1][edge[0x7F7F7FFF]] > 0.0
    assert np.isnan(got[0][edge[0x7FC00000]])


# --- the products ---------------------------------------------------------

def _exact_oracle(a: np.ndarray, b: np.ndarray, mode: int) -> np.ndarray:
    """The definition of `mode`'s product in float64: the part products
    (each exact) summed in float64 (X3, X6), the float64 product (F64), or
    float32 operands' product in float64 (F32); no float32 sums."""
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if mode in (lk.X3, lk.X6):
        pa = [p.numpy().astype(np.float64) for p in lk.split_operand(ta,
                                                                      mode)]
        pb = [p.numpy().astype(np.float64) for p in lk.split_operand(tb,
                                                                      mode)]
        return sum(pa[i] @ pb[j] for i, j in lk._PASSES[mode])
    return a.astype(np.float64) @ b.astype(np.float64)


def test_mm_at_the_presets_against_float64_oracles():
    """_mm at X3, X6 and F64 against float64 oracles of the definitions:
    X3 and X6 within float32 summation's error of their part products'
    exact sum (k 96 terms of size ~1: 1e-5 relative to the sum of |terms|),
    F64 within half a float32 ulp of the float64 product (one rounding),
    F16 the float16 rounding of its float32 sum of float16 operands. Against
    the exact product the errors order BF16 > X3 > X6 ~ F32 (X6 within 3x
    F32's)."""
    rng = np.random.RandomState(2)
    a = rng.normal(size=(24, 96)).astype(np.float32)
    b = rng.normal(size=(96, 16)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    for mode in (lk.X3, lk.X6):
        got = lk._mm(ta, tb, mode).numpy().astype(np.float64)
        assert (np.abs(got - _exact_oracle(a, b, mode)) <= 1e-5 * scale).all()
    exact = _exact_oracle(a, b, lk.F32)
    got = lk._mm(ta, tb, lk.F64).numpy()
    np.testing.assert_array_equal(got, exact.astype(np.float32))
    f16 = lk._mm(ta, tb, lk.F16).numpy()
    a16, b16 = a.astype(np.float16), b.astype(np.float16)
    want16 = (a16.astype(np.float64) @ b16.astype(np.float64))
    np.testing.assert_allclose(f16, want16.astype(np.float16).astype(
        np.float32), rtol=2 ** -10, atol=0)
    assert np.array_equal(f16, f16.astype(np.float16).astype(np.float32))
    err = {m: float(np.abs(lk._mm(ta, tb, m).numpy() - exact).max())
           for m in (lk.BF16, lk.X3, lk.X6, lk.F32)}
    assert err[lk.BF16] > 10 * err[lk.X3] > 10 * err[lk.X6]
    assert err[lk.X6] <= 3 * err[lk.F32]


def test_mm_twin_sums_pass_by_pass_the_smallest_first():
    """The twin at X3 and X6 is the float32 sum of its part products in the
    stated order, pass by pass: bit for bit."""
    rng = np.random.RandomState(3)
    ta = torch.from_numpy(rng.normal(size=(8, 40)).astype(np.float32))
    tb = torch.from_numpy(rng.normal(size=(40, 6)).astype(np.float32))
    for mode, order in ((lk.X3, ("lo hi", "hi lo", "hi hi")),
                        (lk.X6, ("mid mid", "lo hi", "hi lo", "mid hi",
                                 "hi mid", "hi hi"))):
        names = ("hi", "lo") if mode == lk.X3 else ("hi", "mid", "lo")
        pa = dict(zip(names, lk.split_operand(ta, mode)))
        pb = dict(zip(names, lk.split_operand(tb, mode)))
        want = None
        for term in order:
            i, j = term.split()
            t = pa[i] @ pb[j]
            want = t if want is None else want + t
        assert torch.equal(lk._mm(ta, tb, mode), want)


def _fmaf_exact(a, b, acc) -> np.float32:
    """fmaf by exact rational arithmetic: a b + acc rounded once to the
    nearest float32 (ties to even)."""
    ex = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(acc))
    f = np.float32(float(ex))
    cands = [f, np.nextafter(f, np.float32(np.inf)),
             np.nextafter(f, np.float32(-np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - ex),
                                     int(np.float32(c).view(np.uint32)) & 1))


def test_the_probes_plain_version_is_exact():
    """mm_chain, the product probe's plain version (its wrapper's CPU
    path), emulates each step of the kernels' chains bit for bit: its fmaf
    against exact rational arithmetic on 3000 random triples (and on sums
    that land on float32 ties), and each mode's chain on a small product
    against the same chain stepped in exact arithmetic."""
    rng = np.random.RandomState(4)
    a = rng.normal(size=3000).astype(np.float32)
    b = rng.normal(size=3000).astype(np.float32)
    c = (rng.normal(size=3000) * 2.0 ** rng.randint(-30, 5, 3000)).astype(
        np.float32)
    got = lk._fmaf(a, b, c)
    want = np.array([_fmaf_exact(x, y, z) for x, y, z in zip(a, b, c)])
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # a b = +-(2^-24 + 2^-60): the float64 sum lands on a float32 tie (1 +
    # 2^-24, 1 + 3 2^-24) and only the lost 2^-60 decides it
    x = np.float32(1 + 2.0 ** -12)
    y = np.float32(2.0 ** -24 * (1 - 2.0 ** -12 + 2.0 ** -24))
    got = lk._fmaf(np.array([x, -x]), np.array([y, y]),
                   np.array([1.0, 1 + 2.0 ** -22], np.float32))
    assert (got == np.float32(1 + 2.0 ** -23)).all()
    a = rng.normal(size=(3, 7)).astype(np.float32)
    b = rng.normal(size=(7, 2)).astype(np.float32)
    for mode in range(len(lk.MODE_NAMES)):
        got = lk.mm_probe(torch.from_numpy(a), torch.from_numpy(b),
                          mode).numpy()
        if mode == lk.F64:
            want = (a.astype(np.float64) @ b.astype(np.float64)).astype(
                np.float32)
            np.testing.assert_array_equal(got, want)
            continue
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        if mode in (lk.X3, lk.X6):
            pa = [p.numpy() for p in lk.split_operand(ta, mode)]
            pb = [p.numpy() for p in lk.split_operand(tb, mode)]
            terms = lk._PASSES[mode]
        else:
            pa = [lk.round_operand(ta, mode).numpy()]
            pb = [lk.round_operand(tb, mode).numpy()]
            terms = ((0, 0),)
        want = np.zeros((3, 2), np.float32)
        for r in range(3):
            for cc in range(2):
                acc = np.float32(0.0)
                for q in range(7):
                    for i, j in terms:
                        acc = _fmaf_exact(pa[i][r, q], pb[j][q, cc], acc)
                want[r, cc] = acc
        if mode == lk.F16:
            want = want.astype(np.float16).astype(np.float32)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_probe_operands_tell_every_mode_from_every_other():
    """The product probe's operands (lk.probe_operands, which chip_smoke.py's
    phase 32 draws: low mantissa bits set, k 384, sums that cancel) part every mode's exact chain from
    every other's in more than a tenth of the elements, so the card's
    probe, bitwise equal to its own mode's chain, differs from each other
    mode's."""
    a, b = lk.probe_operands(np.random.RandomState(0), rows=32, cols=16)
    chains = [lk.mm_chain(a, b, m) for m in range(len(lk.MODE_NAMES))]
    for i, x in enumerate(chains):
        for j, y in enumerate(chains):
            if i != j:
                share = float((x.view(np.uint32) != y.view(np.uint32)).mean())
                assert share > 0.1, (lk.MODE_NAMES[i], lk.MODE_NAMES[j],
                                     share)


# --- the twins against the JAX package's kernel entries --------------------

def _jax_entry(agent: str, name: str):
    """The JAX package's kernel entry of `agent` (interpret mode) at
    learner_precision `name`, from the same state and inputs as
    test_torch_learner_precision.py's phase: (groups in the port's layout,
    losses), as PHASES[agent][0] returns them."""
    if agent == "ddpg":
        trees = ddpg_t._trees(HIDDEN, seed=3)
        bat = ddpg_t._batches(seed=4, k=K)
        jflat = [(jlk.flatten_actor if a else jlk.flatten_critic)(t, HIDDEN)
                 for t, a in zip(trees, ddpg_t._IS_ACTOR)]
        run = jlk.ddpg_update_phase(HIDDEN, ddpg_t.F, K, ddpg_t.BM,
                                    block_size=ddpg_t.BM, interpret=True,
                                    mm_precision=name, **ddpg_t.LRS)
        new, closs, aloss = jax.jit(run)(
            tuple(jflat), tuple(jnp.asarray(x) for x in bat), jnp.int32(40))
        return ([ddpg_t._jax_flat_to_port(w, HIDDEN, a)
                 for w, a in zip(new, ddpg_t._IS_ACTOR)],
                [np.asarray(closs), np.asarray(aloss)])
    if agent == "dqn":
        trees = dqn_t._trees(HIDDEN, seed=3)
        bat = dqn_t._batches(seed=13, k=K)
        run = jlk.dqn_update_phase(HIDDEN, dqn_t.F, K, dqn_t.BM,
                                   block_size=dqn_t.BM, interpret=True,
                                   mm_precision=name, **dqn_t.LRS)
        new, loss = jax.jit(run)(
            tuple(jlk.flatten_actor(t, HIDDEN) for t in trees),
            tuple(jnp.asarray(x) for x in bat), jnp.int32(40))
        return ([dqn_t._jax_flat_to_port(w, HIDDEN) for w in new],
                [np.asarray(loss)])
    if agent == "naf":
        trees = naf_t._trees(HIDDEN, seed=3)
        bat = naf_t._batches(seed=13, k=K)
        run = jlk.naf_update_phase(HIDDEN, naf_t.F, K, naf_t.BM,
                                   max_grad_norm=10.0, block_size=naf_t.BM,
                                   interpret=True, lr_schedule=naf_t.SCHED,
                                   mm_precision=name, **naf_t.LRS)
        new, loss = jax.jit(run)(
            tuple(jlk.flatten_naf(t, HIDDEN) for t in trees),
            tuple(jnp.asarray(x) for x in bat), jnp.int32(40))
        return ([[x.numpy() for x in naf_t._port_list(
            unflatten_naf(w, HIDDEN), HIDDEN)] for w in new],
                [np.asarray(loss)])
    trees = lrpg_t._trees(HIDDEN, seed=4)
    win = lrpg_t._window(seed=14)
    run = jlk.lrpg_update_phase(HIDDEN, lrpg_t.F, lrpg_t.N, num_actions=5,
                                block_size=32, interpret=True,
                                mm_precision=name, **lrpg_t.KW)
    new, loss = jax.jit(run)(
        [jlk.flatten_actor(t, HIDDEN) for t in trees],
        tuple(jnp.asarray(x) for x in win), jnp.int32(lrpg_t.T0))
    return ([lrpg_t._jax_flat_to_port(w, HIDDEN) for w in new],
            [np.asarray(loss)])


@functools.lru_cache(maxsize=None)
def _entry(agent, name):
    return _flat(_jax_entry(agent, name))


def _close_all(got, want, **tol):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), b, err_msg=f"tensor {i}",
                                   **tol)


def _max_rel(got, want) -> float:
    """The largest error of any tensor over its largest magnitude."""
    return max(float(np.abs(a.numpy() - b).max()) / max(float(np.abs(b)
                                                               .max()), 1e-30)
               for a, b in zip(got, want))


@pytest.mark.parametrize("agent", AGENTS)
def test_aliases_give_the_legacy_bits(agent):
    """F32_F32_F32 gives the default's bits and BF16_BF16_F32 bfloat16's
    (the JAX package's kernel entry runs both on the CPU:
    test_torch_learner_precision.py::test_mm_mode_takes_the_presets)."""
    phase = PHASES[agent][0]
    for alias, legacy in (("F32_F32_F32", None),
                          ("BF16_BF16_F32", "bfloat16")):
        got = _flat(phase(mm_precision=alias))
        want = _flat(phase(mm_precision=legacy))
        assert all(torch.equal(a, b) for a, b in zip(got, want)), alias


@pytest.mark.parametrize("agent", AGENTS)
def test_twin_at_multipass_against_the_jax_kernel_entry(agent):
    """Each twin at BF16_BF16_F32_X6 and _X3 against the JAX package's
    kernel entry at the same name (which computes float32 on the CPU): X6
    within the bar at which the float32 twins are held to it, X3 within
    the reference's bfloat16 bar (rtol 2e-2, atol 2e-3) and nearer to it
    than the twin at bfloat16; X3 and X6 each off the float32 twin (the
    modes are live)."""
    phase = PHASES[agent][0]
    want = _entry(agent, "BF16_BF16_F32_X6")
    assert all(np.array_equal(a, b) for a, b in zip(
        _entry(agent, "BF16_BF16_F32_X3"), want))
    x6 = _flat(phase(mm_precision="BF16_BF16_F32_X6"))
    _close_all(x6, want, **F32_TOL[agent])
    x3 = _flat(phase(mm_precision="BF16_BF16_F32_X3"))
    _close_all(x3, want, **REF_TOL)
    bf16 = _flat(phase(mm_precision="bfloat16"))
    assert _max_rel(x3, want) < _max_rel(bf16, want) / 10
    f32 = _flat(phase())
    for got in (x3, x6):
        assert max(float((a - b).abs().max()) for a, b in zip(got, f32)) > 0


@pytest.mark.parametrize("agent", AGENTS)
def test_twin_at_f64_against_the_jax_kernel_entry(agent):
    """Each twin at F64_F64_F64 against the JAX package's kernel entry at
    F64_F64_F64, which computes float64 products on the CPU, at the bar of
    the float32 twins, and nearer to it than the float32 twin is."""
    phase = PHASES[agent][0]
    want = _entry(agent, "F64_F64_F64")
    got = _flat(phase(mm_precision="F64_F64_F64"))
    _close_all(got, want, **F32_TOL[agent])
    f32 = _flat(phase())
    off = [float(np.abs(a.numpy() - b).max()) for a, b in zip(got, want)]
    off32 = [float(np.abs(a.numpy() - b).max()) for a, b in zip(f32, want)]
    assert sum(off) < sum(off32)


@pytest.mark.parametrize("agent", AGENTS)
def test_twin_at_f16_against_the_jax_kernel_entry(agent):
    """Each twin at F16_F16_F16 against the JAX package's kernel entry at
    the same name, which rounds every dot's result to float16 on the CPU:
    within the reference's bfloat16 bar (a float32 sum in another order
    may round to the neighbouring float16), nearer to it than the float32
    twin is, and off the float32 twin."""
    phase = PHASES[agent][0]
    want = _entry(agent, "F16_F16_F16")
    got = _flat(phase(mm_precision="F16_F16_F16"))
    _close_all(got, want, **REF_TOL)
    f32 = _flat(phase())
    assert _max_rel(got, want) < _max_rel(f32, want)


def test_the_wrappers_take_the_presets_on_the_cpu():
    """Each wrapper on CPU buffers runs its twin at a preset (the groups
    move as the twin's do), B9's plan mirrors take the mode (doubles at
    F64), and the probe's wrappers refuse a mode out of range."""
    trees = lrpg_t._trees(HIDDEN, seed=4)
    win = lrpg_t._torch_window(lrpg_t._window(seed=14))
    lay = lk.policy_layout(lrpg_t.F, HIDDEN)
    groups = [torch.cat([x.reshape(-1) for x in lrpg_t._port_list(t,
                                                                  HIDDEN)])
              for t in trees]
    for name in ("BF16_BF16_F32_X3", "F64_F64_F64", "F16_F16_F16"):
        want, _ = PHASES["lrpg"][0](mm_precision=name)
        got = [g.clone() for g in groups]
        lk.lrpg_update_phase(got, win, lrpg_t.T0, HIDDEN, mm_precision=name,
                             **lrpg_t.KW)
        for g, w in zip(got, want):
            for v, x in zip(lk.group_views(g, lay), w):
                assert torch.equal(v, x), name
    p = lk.layout_size(lk.policy_layout(42, (64, 64)))
    assert (lk.pg_smem_floats(42, (64, 64), lk.F64)
            - lk.pg_smem_floats(42, (64, 64))) == (p + 1 + 3) // 4 * 4
    assert not lk.pg_tile_spills(42, (64, 64), lk.F64)
    assert lk.pg_tile_spills(42, (80, 80), lk.F64)
    assert not lk.pg_tile_spills(42, (80, 80))
    _, _, blocks = lk.pg_plan(42, (64, 64), 131072, lk.F64)
    assert lk.pg_plan(42, (64, 64), 131072, lk.F64) == lk.pg_plan(
        42, (64, 64), 131072)
    assert lk.pg_workspace_floats(42, (64, 64), 131072, lk.F64) == \
        -(-2 * blocks * (p + 1) // 32) * 32
    with pytest.raises(ValueError):
        lk.mm_probe(torch.ones(2, 3), torch.ones(3, 2), 7)
    with pytest.raises(ValueError):
        lk.mm_split(torch.ones(2, 3), lk.X3)


# --- train steps and the CLI ----------------------------------------------

# The bar of the float32 port's train steps against the JAX package's
# (test_torch_ddpg.py's teacher-forced steps: rtol 2e-4, atol 1e-5).
STEP_TOL = dict(rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("precision", ["BF16_BF16_F32_X3", "F64_F64_F64"])
@pytest.mark.parametrize("agent", AGENTS)
def test_train_steps_track_the_reference_kernel_learner(agent, precision):
    """2 train steps, each from the reference's state (its replay draws
    injected for DDPG, DQN and NAF), of the port's kernel learner against
    the reference's kernel learner (Pallas interpret mode) at the same
    name: X3 within the reference's bfloat16 bar (the reference computes
    float32 on the CPU), F64 within the float32 port's train-step bar (it
    computes float64 products); counts, the ring and the env's integers
    exact."""
    tol = REF_TOL if precision == "BF16_BF16_F32_X3" else STEP_TOL
    prec_t._track_reference(agent, precision, "kernel", tol, 2)


@pytest.mark.parametrize("precision", list(prec_t.TAKEN_PRESETS))
def test_cli_takes_each_preset_across_a_resume(tmp_path, precision):
    """`--lrpg.learner kernel --lrpg.learner-precision NAME` at each preset
    the port takes: rc 0, finite metrics, the kernel learner's twin; a
    checkpointed run resumes at the same name (the config round-trips)."""
    run = ["--device", "cpu", "--agent", "lrpg", "--num-envs", "16",
           "--lrpg.hidden", "16", "16", "--lrpg.rollout-steps", "8",
           "--lrpg.learner", "kernel", "--lrpg.learner-precision",
           precision, "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-interval",
           "1", "--log-interval", "1"]
    rc, _, err = prec_t._cli(run + ["--total-env-steps", "16"])
    assert rc == 0, err
    rc, out, err = prec_t._cli(run + ["--total-env-steps", "32"])
    assert rc == 0, err
    assert "resumed from step 1" in err
    steps = [json.loads(x) for x in out.splitlines()]
    assert [m["train_step"] for m in steps] == [3, 4]
    assert all(m["learner_impl"] == 1.0 for m in steps)
    assert all(np.isfinite(v) for m in steps for v in m.values())
