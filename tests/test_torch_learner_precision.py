"""`learner_precision` on the kernel learners (B3, B5, B7, B9) on the CPU:
the map of the reference's legacy values onto the port's product modes,
the operand rounding against numpy on the float32 bit patterns, each twin
at float32 under every spelling against its default, each twin at
bfloat16 and TF32 against the JAX package's float32 phase at the
reference's own bar (tests/test_learner_kernel.py:545-578: rtol 2e-2, atol
2e-3; JAX on the CPU computes float32 whatever the precision), train steps
at bfloat16 against the reference's plain learner, and the CLI flag.

Inputs come from numpy with a seed, the learners start from warmed Adam
moments (as the learners' own parity tests do).
"""

import contextlib
import functools
import inspect
import io
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu import CartPole3D as JCartPole3D
from cartpoleplusplus_tpu import CartPoleParams as JCartPoleParams
from cartpoleplusplus_tpu.agents import DDPG as JDDPG
from cartpoleplusplus_tpu.agents import DDPGConfig as JDDPGConfig
from cartpoleplusplus_tpu.agents import DQN as JDQN
from cartpoleplusplus_tpu.agents import DQNConfig as JDQNConfig
from cartpoleplusplus_tpu.agents import LRPG as JLRPG
from cartpoleplusplus_tpu.agents import LRPGConfig as JLRPGConfig
from cartpoleplusplus_tpu.agents import NAF as JNAF
from cartpoleplusplus_tpu.agents import NAFConfig as JNAFConfig
from cartpoleplusplus_tpu.ops import learner_kernel as jlk
from cartpoleplusplus_tpu.physics import params as jparams
from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams
from cartpoleplusplus_tpu_torch import train as ttrain
from cartpoleplusplus_tpu_torch.agents import (DDPG, DQN, LRPG, NAF,
                                               DDPGConfig, DQNConfig,
                                               LRPGConfig, NAFConfig)
from cartpoleplusplus_tpu_torch.ckpt.checkpoint import to_tree
from cartpoleplusplus_tpu_torch.models.from_jax import (
    ddpg_state_from_jax, dqn_state_from_jax, lrpg_state_from_jax,
    naf_state_from_jax, unflatten_naf)
from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk
from cartpoleplusplus_tpu_torch.physics.params import continuous_params
import test_torch_dqn_learner as dqn_t
import test_torch_learner_kernel as ddpg_t
import test_torch_lrpg_learner as lrpg_t
import test_torch_naf_learner as naf_t
from test_torch_ddpg import DRAWS

# The reference's bar for its kernel learner at "bfloat16" against the
# float32 plain learner (tests/test_learner_kernel.py:545-578).
REF_TOL = dict(rtol=2e-2, atol=2e-3)
SPELLINGS = {lk.F32: (None, "float32", "highest", "F32_F32_F32"),
             lk.BF16: ("bfloat16", "default", "BF16_BF16_F32"),
             lk.TF32: ("tensorfloat32", "high")}
# The dot-algorithm presets (jax.lax.DotAlgorithmPreset's names, which
# jax.default_matmul_precision also takes) that the port takes, as the JAX
# package's kernel learners run them on the CPU, each with its mode.
TAKEN_PRESETS = {"F32_F32_F32": lk.F32, "BF16_BF16_F32": lk.BF16,
                 "BF16_BF16_F32_X3": lk.X3, "BF16_BF16_F32_X6": lk.X6,
                 "F64_F64_F64": lk.F64, "F16_F16_F16": lk.F16}
# The presets the JAX package's kernel learners refuse on the CPU, and so
# the port: every other DotAlgorithmPreset name.
PRESETS = tuple(p.name for p in jax.lax.DotAlgorithmPreset
                if p.name not in TAKEN_PRESETS)
# A name refused by both, as the refusal tests below spell it.
REFUSED = "BF16_BF16_F32_X9"
AGENTS = ("ddpg", "dqn", "naf", "lrpg")
HIDDEN = (32, 32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# --- the map and the rounding ---------------------------------------------

def test_mm_mode_maps_the_legacy_values():
    """Every legacy value maps to its mode, as jax.lax.Precision names the
    same values: bfloat16/default DEFAULT (one bfloat16 pass),
    tensorfloat32/high HIGH, float32/highest HIGHEST; None is float32; the
    aliases F32_F32_F32 and BF16_BF16_F32 map to float32 and bfloat16, and
    PRECISIONS holds the legacy values and the presets taken."""
    want = {lk.F32: jax.lax.Precision.HIGHEST,
            lk.BF16: jax.lax.Precision.DEFAULT,
            lk.TF32: jax.lax.Precision.HIGH}
    assert set(lk.PRECISIONS) == ({v for vs in SPELLINGS.values() for v in vs}
                                  | set(TAKEN_PRESETS))
    for mode, names in SPELLINGS.items():
        for name in names:
            assert lk.mm_mode(name) == mode
            if name is not None and name not in TAKEN_PRESETS:
                assert jax.lax.Precision(name) == want[mode]


def _jax_entry(name):
    """The JAX package's DQN kernel entry (interpret mode) at
    learner_precision `name` on a small phase: its loss (K,)."""
    trees = dqn_t._trees(HIDDEN, seed=3)
    bat = dqn_t._batches(seed=13, k=1)
    run = jlk.dqn_update_phase(HIDDEN, dqn_t.F, 1, dqn_t.BM,
                               block_size=dqn_t.BM, interpret=True,
                               mm_precision=name, **dqn_t.LRS)
    _, loss = jax.jit(run)(
        tuple(jlk.flatten_actor(t, HIDDEN) for t in trees),
        tuple(jnp.asarray(x) for x in bat), jnp.int32(40))
    return np.asarray(loss)


@pytest.mark.parametrize("name", PRESETS + ("float64", "BFLOAT16", 1, "F32",
                                            "bf16_bf16_f32_x3"))
def test_mm_mode_rejects_the_presets(name):
    """Each name the JAX package's kernel entry refuses on the CPU (its
    dot_general or jax.default_matmul_precision raises), the port refuses
    too, saying so."""
    with pytest.raises(ValueError, match="is not ported; the port takes"):
        lk.mm_mode(name)
    with pytest.raises(ValueError):
        _jax_entry(name)


@pytest.mark.parametrize("name", list(TAKEN_PRESETS))
def test_mm_mode_takes_the_presets(name):
    """Each preset the JAX package's kernel entry runs on the CPU, the port
    takes: its mode, a finite loss from the JAX entry."""
    assert lk.mm_mode(name) == TAKEN_PRESETS[name]
    assert name in lk.PRECISIONS
    assert np.isfinite(_jax_entry(name)).all()


def _oracle(bits: np.ndarray, mant: int, ties_even: bool) -> np.ndarray:
    """Round float32 bit patterns to `mant` stored mantissa bits in
    float64 arithmetic (independent of the port's integer operations):
    the spacing at each value's exponent (the subnormals' below 2^-126),
    ties to even or away from zero, past the format's largest to inf; NaN
    bits unchanged."""
    with np.errstate(invalid="ignore"):
        x = bits.view(np.float32).astype(np.float64)
    out = np.empty_like(x)
    for i, v in enumerate(x):
        if not np.isfinite(v) or v == 0.0:
            out[i] = v
            continue
        _, e = np.frexp(abs(v))           # |v| = m 2^e, 0.5 <= m < 1
        spacing = 2.0 ** max(e - 1 - mant, -126 - mant)
        q = abs(v) / spacing
        fl = np.floor(q)
        if q - fl > 0.5 or (q - fl == 0.5 and (not ties_even or fl % 2)):
            fl += 1.0
        r = fl * spacing
        out[i] = np.copysign(np.inf if r >= 2.0 ** 128 else r, v)
    res = out.astype(np.float32).view(np.uint32)
    nan = np.isnan(x)
    res[nan] = bits[nan]
    return res


EDGE_BITS = np.array([
    0x00000000, 0x80000000, 0x00000001, 0x80000001, 0x00008000, 0x00018000,
    0x00001000, 0x00003000, 0x007fffff, 0x00800000, 0x3f800000, 0x3f808000,
    0x3f818000, 0x3f807fff, 0xbf808000, 0x3f801000, 0x3f803000, 0xbf801000,
    0x3f800fff, 0x7f7f0000, 0x7f7f7fff, 0x7f7f8000, 0x7f7fe000, 0x7f7fefff,
    0x7f7ff000, 0x7f7fffff, 0xff7fffff, 0x7f800000, 0xff800000, 0x7fc00000,
    0x7f800001, 0xffc00001, 0x7fffffff], dtype=np.uint32)


@pytest.mark.parametrize("mode", [lk.BF16, lk.TF32], ids=["bf16", "tf32"])
def test_round_operand_against_numpy(mode):
    """round_operand on ties, subnormals, +-0, +-inf, NaNs and the formats'
    overflow edges, and on 20,000 random bit patterns, against the float64
    oracle; bfloat16 also against ml_dtypes' cast (which quiets a NaN:
    finite and infinite values only). TF32 rounds ties away from zero, so
    1 + 2^-11 goes up and 1 + 3 2^-11 too."""
    rng = np.random.RandomState(0)
    bits = np.concatenate([EDGE_BITS, rng.randint(0, 2 ** 32, 20000,
                                                  dtype=np.uint64)
                           .astype(np.uint32)])
    x = torch.from_numpy(bits.view(np.float32).copy())
    got = lk.round_operand(x, mode).numpy().view(np.uint32)
    mant, even = (7, True) if mode == lk.BF16 else (10, False)
    np.testing.assert_array_equal(got, _oracle(bits, mant, even))
    if mode == lk.BF16:
        f = bits.view(np.float32)
        ok = ~np.isnan(f)
        with np.errstate(invalid="ignore", over="ignore"):
            ref = f[ok].astype(ml_dtypes.bfloat16).astype(np.float32)
        np.testing.assert_array_equal(got[ok], ref.view(np.uint32))
    else:
        assert got[list(EDGE_BITS).index(0x3f801000)] == 0x3f802000
        assert got[list(EDGE_BITS).index(0x3f803000)] == 0x3f804000
    # idempotent, and strided views round as their elements
    again = lk.round_operand(torch.from_numpy(got.view(np.float32).copy()),
                             mode).numpy().view(np.uint32)
    np.testing.assert_array_equal(again, got)
    w = torch.from_numpy(rng.normal(size=(24, 40)).astype(np.float32))
    assert torch.equal(lk.round_operand(w.t(), mode),
                       lk.round_operand(w, mode).t())
    assert lk.round_operand(w, lk.F32) is w


# --- the twins, one phase per agent ---------------------------------------

K = 2


def _ddpg_phase(**extra):
    trees = ddpg_t._trees(HIDDEN, seed=3)
    bat = ddpg_t._batches(seed=4, k=K)
    got = lk.update_phase_math(
        *[ddpg_t._port_list(t, HIDDEN, a)
          for t, a in zip(trees, ddpg_t._IS_ACTOR)],
        tuple(torch.from_numpy(np.asarray(x)) for x in bat), 40, HIDDEN,
        **ddpg_t.LRS, **extra)
    return [list(g) for g in got[:8]], list(got[8:])


def _ddpg_jax():
    trees = ddpg_t._trees(HIDDEN, seed=3)
    bat = ddpg_t._batches(seed=4, k=K)
    jflat = [(jlk.flatten_actor if a else jlk.flatten_critic)(t, HIDDEN)
             for t, a in zip(trees, ddpg_t._IS_ACTOR)]
    want = jlk.update_phase_math(*jflat, tuple(jnp.asarray(x) for x in bat),
                                 jnp.int32(40), HIDDEN, **ddpg_t.LRS)
    groups = [ddpg_t._jax_flat_to_port(w, HIDDEN, a)
              for w, a in zip(want[:8], ddpg_t._IS_ACTOR)]
    return groups, [np.asarray(x) for x in want[8:]]


def _dqn_phase(**extra):
    trees = dqn_t._trees(HIDDEN, seed=3)
    bat = dqn_t._batches(seed=13, k=K)
    got = lk.dqn_update_phase_math(
        *[dqn_t._port_list(t, HIDDEN) for t in trees],
        tuple(torch.from_numpy(np.asarray(x)) for x in bat), 40, HIDDEN,
        **dqn_t.LRS, **extra)
    return [list(g) for g in got[:4]], [got[4]]


def _dqn_jax():
    trees = dqn_t._trees(HIDDEN, seed=3)
    bat = dqn_t._batches(seed=13, k=K)
    want = jlk.dqn_update_phase_math(
        *[jlk.flatten_actor(t, HIDDEN) for t in trees],
        tuple(jnp.asarray(x) for x in bat), jnp.int32(40), HIDDEN,
        **dqn_t.LRS)
    return ([dqn_t._jax_flat_to_port(w, HIDDEN) for w in want[:4]],
            [np.asarray(want[4])])


def _naf_phase(**extra):
    trees = naf_t._trees(HIDDEN, seed=3)
    bat = naf_t._batches(seed=13, k=K)
    got = lk.naf_update_phase_math(
        *[naf_t._port_list(t, HIDDEN) for t in trees],
        tuple(torch.from_numpy(np.asarray(x)) for x in bat), 40, HIDDEN,
        max_grad_norm=10.0, lr_schedule=naf_t.SCHED, **naf_t.LRS, **extra)
    return [list(g) for g in got[:4]], [got[4]]


def _naf_jax():
    trees = naf_t._trees(HIDDEN, seed=3)
    bat = naf_t._batches(seed=13, k=K)
    want = jlk.naf_update_phase_math(
        *[jlk.flatten_naf(t, HIDDEN) for t in trees],
        tuple(jnp.asarray(x) for x in bat), jnp.int32(40), HIDDEN,
        max_grad_norm=10.0, lr_schedule=naf_t.SCHED, **naf_t.LRS)
    return ([[x.numpy() for x in naf_t._port_list(unflatten_naf(w, HIDDEN),
                                                   HIDDEN)]
             for w in want[:4]], [np.asarray(want[4])])


def _lrpg_phase(**extra):
    trees = lrpg_t._trees(HIDDEN, seed=4)
    win = lrpg_t._window(seed=14)
    got = lk.lrpg_update_phase_math(
        *[lrpg_t._port_list(t, HIDDEN) for t in trees],
        lrpg_t._torch_window(win), lrpg_t.T0, HIDDEN, **lrpg_t.KW, **extra)
    return [list(g) for g in got[:3]], [got[3]]


def _lrpg_jax():
    trees = lrpg_t._trees(HIDDEN, seed=4)
    win = lrpg_t._window(seed=14)
    want = jlk.lrpg_update_phase_math(
        *[jlk.flatten_actor(t, HIDDEN) for t in trees],
        tuple(jnp.asarray(x) for x in win), jnp.int32(lrpg_t.T0), HIDDEN,
        num_actions=5, **lrpg_t.KW)
    return ([lrpg_t._jax_flat_to_port(w, HIDDEN) for w in want[:3]],
            [np.asarray(want[3])])


PHASES = {"ddpg": (_ddpg_phase, _ddpg_jax), "dqn": (_dqn_phase, _dqn_jax),
          "naf": (_naf_phase, _naf_jax), "lrpg": (_lrpg_phase, _lrpg_jax)}


@functools.lru_cache(maxsize=None)
def _jax_result(agent):
    return PHASES[agent][1]()


def _flat(result):
    groups, losses = result
    return ([x.reshape(-1) for g in groups for x in g]
            + [x.reshape(-1) for x in losses])


@pytest.mark.parametrize("agent", AGENTS)
def test_twin_at_float32_is_the_default_under_every_spelling(agent):
    """None, "float32" and "highest" give the twin's float32 result bit for
    bit (the code path that ran before the setting was ported)."""
    phase = PHASES[agent][0]
    want = _flat(phase())
    for name in SPELLINGS[lk.F32]:
        got = _flat(phase(mm_precision=name))
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name


@pytest.mark.parametrize("precision", ["bfloat16", "tensorfloat32"])
@pytest.mark.parametrize("agent", AGENTS)
def test_twin_at_reduced_precision_within_the_reference_bar(agent,
                                                            precision):
    """One phase from the reference's warmed state (K 2 for B3, B5 and B7;
    B9's one update over a window of 128 rows) at bfloat16 and TF32 against
    the JAX package's float32 phase: every group and loss within the
    reference's bar for its bfloat16 kernel (rtol 2e-2, atol 2e-3); and off
    the twin's own float32 result by more than 1e-6 (the mode is live),
    its other spelling giving the same bits."""
    phase = PHASES[agent][0]
    got = _flat(phase(mm_precision=precision))
    want = _flat(_jax_result(agent))
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), b, err_msg=f"tensor {i}",
                                   **REF_TOL)
    f32 = _flat(phase())
    apart = max(float((a - b).abs().max()) for a, b in zip(got, f32))
    assert apart > 1e-6, apart
    other = SPELLINGS[lk.mm_mode(precision)][1]
    got2 = _flat(phase(mm_precision=other))
    assert all(torch.equal(a, b) for a, b in zip(got, got2))


def test_the_wrappers_take_the_setting_on_the_cpu():
    """Each wrapper on CPU buffers runs its twin at the given precision (the
    groups move as the twin's do) and refuses a name the JAX package
    refuses too."""
    trees = dqn_t._trees(HIDDEN, seed=3)
    bat = tuple(torch.from_numpy(np.asarray(x))
                for x in dqn_t._batches(seed=13, k=K))
    lay = lk.qnet_layout(42, HIDDEN)
    groups = [torch.cat([x.reshape(-1) for x in dqn_t._port_list(t, HIDDEN)])
              for t in trees]
    want, _ = _dqn_phase(mm_precision="bfloat16")
    got = [g.clone() for g in groups]
    lk.dqn_update_phase(got, bat, 40, HIDDEN, mm_precision="bfloat16",
                        **dqn_t.LRS)
    for g, w in zip(got, want):
        for v, x in zip(lk.group_views(g, lay), w):
            assert torch.equal(v, x)
    with pytest.raises(ValueError, match="is not ported"):
        lk.dqn_update_phase([g.clone() for g in groups], bat, 40, HIDDEN,
                            mm_precision=REFUSED, **dqn_t.LRS)


# --- train steps at bfloat16 against the reference's plain learner --------

def _floats_close(got, want, path="", tol=REF_TOL):
    """Two `to_tree` dicts: float tensors within `tol`, every integer,
    bool and count exact."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _floats_close(got[k], want[k], f"{path}.{k}", tol)
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for a, b in zip(got, want):
            _floats_close(a, b, path, tol)
    elif isinstance(want, torch.Tensor) and want.is_floating_point():
        torch.testing.assert_close(got, want, msg=lambda m: f"{path}: {m}",
                                   **tol)
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want), path
    else:
        assert got == want, path


def _agents(name, precision="bfloat16", jax_learner="xla"):
    """(reference agent with the plain learner in float32, or with its
    kernel learner at `precision` when jax_learner is "kernel", the port's
    agent with the kernel learner's twin at `precision`, the state
    converter, the replay draws or None, K) at a small config."""
    cont, disc = jparams.continuous_params(), JCartPoleParams()
    jkw = ({} if jax_learner == "xla"
           else dict(learner_precision=precision))
    if name == "ddpg":
        kw = dict(hidden=HIDDEN, rollout_steps=4, updates_per_step=2,
                  batch_size=32, replay_capacity_per_env=16,
                  warmup_env_steps=8)
        jagent = JDDPG(JCartPole3D(cont, num_envs=64),
                       JDDPGConfig(learner=jax_learner, **jkw, **kw))
        return (jagent,
                DDPG(CartPole3D(continuous_params(), num_envs=64,
                                device="cpu"),
                     DDPGConfig(learner="kernel",
                                learner_precision=precision, **kw)),
                lambda port, st: ddpg_state_from_jax(
                    port, jagent.state_to_tree(st) if jagent.kernel_mode
                    else st), DRAWS["column"], 2)
    if name in ("dqn", "naf"):
        kw = dict(hidden=HIDDEN, rollout_steps=4, updates_per_step=2,
                  batch_size=32, replay_capacity_per_env=16,
                  warmup_env_steps=8)
        if name == "dqn":
            return (JDQN(JCartPole3D(disc, num_envs=64),
                         JDQNConfig(learner=jax_learner, **jkw, **kw)),
                    DQN(CartPole3D(CartPoleParams(), num_envs=64,
                                   device="cpu"),
                        DQNConfig(learner="kernel",
                                  learner_precision=precision, **kw)),
                    dqn_state_from_jax, DRAWS["column"], 2)
        return (JNAF(JCartPole3D(cont, num_envs=64),
                     JNAFConfig(learner=jax_learner, **jkw, **kw)),
                NAF(CartPole3D(continuous_params(), num_envs=64,
                               device="cpu"),
                    NAFConfig(learner="kernel",
                              learner_precision=precision, **kw)),
                naf_state_from_jax, DRAWS["column"], 2)
    kw = dict(hidden=HIDDEN, rollout_steps=8)
    return (JLRPG(JCartPole3D(disc, num_envs=64),
                  JLRPGConfig(learner=jax_learner, **jkw, **kw)),
            LRPG(CartPole3D(CartPoleParams(), num_envs=64, device="cpu"),
                 LRPGConfig(learner="kernel", learner_precision=precision,
                            **kw)),
            lrpg_state_from_jax, None, 1)


@pytest.mark.parametrize("agent", AGENTS)
def test_bf16_train_steps_track_the_reference_plain_learner(agent):
    """4 train steps, each from the reference's state (its replay draws
    injected for DDPG, DQN and NAF): the port's kernel learner at
    learner_precision="bfloat16" against the reference's plain float32
    learner, as the reference holds its own bfloat16 kernel learner
    (tests/test_learner_kernel.py:545-578): every network, target, Adam
    moment and the losses within rtol 2e-2 / atol 2e-3; counts, the ring's
    cursor and fill and the env state's integers exact."""
    _track_reference(agent, "bfloat16", "xla", REF_TOL, 4)


def _track_reference(agent, precision, jax_learner, tol, steps):
    """`steps` train steps of the port's kernel learner at `precision`,
    each from the reference's state (its replay draws injected for DDPG,
    DQN and NAF), against the reference agent (_agents): every float within
    `tol`, every integer exact; a loss moved in all but the first step."""
    jagent, port, from_jax, draw, k = _agents(agent, precision, jax_learner)
    assert port.kernel_mode
    assert jagent.kernel_mode == (jax_learner == "kernel")
    jstep = jax.jit(functools.partial(jagent.train_step, fused=False))
    jst = jagent.init(0)
    c = jagent.cfg
    learned = 0
    for step in range(1, steps + 1):
        host = jax.device_get(jst)
        indices = None
        if draw is not None:
            cap = jagent.replay.capacity
            filled = min(int(host.replay.filled) + c.rollout_steps, cap)
            cursor = (int(host.replay.cursor) + c.rollout_steps) % cap
            indices = draw(jagent, jst, k, filled, cursor)
        pst = from_jax(port, host)
        pst, m = (port.train_step(pst) if draw is None
                  else port.train_step(pst, indices=indices))
        jst, jm = jstep(jst)
        want = from_jax(port, jax.device_get(jst))
        try:
            _floats_close(
                {key: v for key, v in to_tree(pst).items() if key != "rng"},
                {key: v for key, v in to_tree(want).items() if key != "rng"},
                tol=tol)
            assert m["learner_impl"] == 1.0
            for key, v in jm.items():
                if key in m and key not in ("learner_impl", "rollout_impl",
                                            "env_steps_per_sec"):
                    np.testing.assert_allclose(float(m[key]), float(v),
                                               err_msg=key, **tol)
        except AssertionError as e:
            raise AssertionError(f"train step {step}: {e}") from e
        loss = m.get("critic_loss", m.get("loss"))
        learned += float(loss) != 0.0
    assert learned >= steps - 1


# --- the CLI --------------------------------------------------------------

def _cli(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = ttrain.main(argv)
    return rc, out.getvalue(), err.getvalue()


CLI_SMALL = {
    "ddpg": ["--ddpg.hidden", "16", "16", "--ddpg.batch-size", "16",
             "--ddpg.replay-capacity-per-env", "16"],
    "dqn": ["--dqn.hidden", "16", "16", "--dqn.batch-size", "16",
            "--dqn.replay-capacity-per-env", "16"],
    "naf": ["--naf.hidden", "16", "16", "--naf.batch-size", "16",
            "--naf.replay-capacity-per-env", "16"],
    "lrpg": ["--lrpg.hidden", "16", "16", "--lrpg.rollout-steps", "8"],
}


@pytest.mark.parametrize("agent", AGENTS)
def test_cli_trains_at_bfloat16_on_the_kernel_learner(agent):
    """`--<agent>.learner kernel --<agent>.learner-precision bfloat16` on
    the CPU at 16 envs: rc 0, finite metrics, the kernel learner's twin
    (learner_impl 1.0) past the warmup; a refused name exits 2."""
    base = ["--device", "cpu", "--agent", agent, "--num-envs", "16",
            "--log-interval", "1", *CLI_SMALL[agent],
            f"--{agent}.learner", "kernel"]
    rc, out, err = _cli(base + ["--total-env-steps", "32",
                                f"--{agent}.learner-precision", "bfloat16"])
    assert rc == 0, err
    lines = [json.loads(x) for x in out.splitlines()]
    assert lines and all(np.isfinite(v) for m in lines for v in m.values())
    assert lines[-1]["learner_impl"] == 1.0
    rc, _, err = _cli(base + ["--total-env-steps", "16",
                              f"--{agent}.learner-precision", REFUSED])
    assert rc == 2 and REFUSED in err


def test_cli_precision_under_a_preset_and_across_a_resume(tmp_path):
    """The flag survives `--preset fast` (the preset pins LRPG's kernel
    learner, not the precision) as the reference's merge keeps it, and a
    checkpointed bfloat16 run resumes at bfloat16."""
    import test_torch_cli as cli_t
    from cartpoleplusplus_tpu import train as jtrain

    argv = ["--agent", "lrpg", "--preset", "fast", "--num-envs", "16",
            "--lrpg.hidden", "16", "16", "--lrpg.learner-precision", "high"]
    _, t_cfg = cli_t._merged(ttrain, argv + ["--device", "cpu"], "fast",
                             "lrpg")
    _, j_cfg = cli_t._merged(jtrain, argv, "fast", "lrpg")
    assert t_cfg.learner_precision == j_cfg.learner_precision == "high"
    assert t_cfg.learner == "kernel"
    run = ["--device", "cpu", "--agent", "lrpg", "--num-envs", "16",
           "--lrpg.hidden", "16", "16", "--lrpg.rollout-steps", "8",
           "--lrpg.learner", "kernel", "--lrpg.learner-precision",
           "bfloat16", "--ckpt-dir", str(tmp_path / "ck"),
           "--ckpt-interval", "1", "--log-interval", "1"]
    rc, _, err = _cli(run + ["--total-env-steps", "16"])
    assert rc == 0, err
    rc, out, err = _cli(run + ["--total-env-steps", "32"])
    assert rc == 0, err
    assert "resumed from step 1" in err
    steps = [json.loads(x) for x in out.splitlines()]
    assert [m["train_step"] for m in steps] == [3, 4]
    assert all(m["learner_impl"] == 1.0 for m in steps)


def test_agents_take_every_legacy_value():
    """Each agent constructs at every value the port takes (the plain
    learner ignores it, as the reference's does) and raises for a refused
    name."""
    cont = continuous_params()
    made = {"ddpg": lambda **kw: DDPG(CartPole3D(cont, num_envs=8,
                                                 device="cpu"),
                                      DDPGConfig(**kw)),
            "naf": lambda **kw: NAF(CartPole3D(cont, num_envs=8,
                                               device="cpu"),
                                    NAFConfig(**kw)),
            "dqn": lambda **kw: DQN(CartPole3D(CartPoleParams(), num_envs=8,
                                               device="cpu"),
                                    DQNConfig(**kw)),
            "lrpg": lambda **kw: LRPG(CartPole3D(CartPoleParams(),
                                                 num_envs=8, device="cpu"),
                                      LRPGConfig(**kw))}
    for name, make in made.items():
        for value in lk.PRECISIONS:
            for learner in ("kernel", "xla"):
                agent = make(learner=learner, learner_precision=value)
                assert agent.kernel_mode == (learner == "kernel")
        with pytest.raises(ValueError, match=REFUSED):
            make(learner="kernel", learner_precision=REFUSED)
    assert "learner_precision" in inspect.signature(DDPGConfig).parameters
