"""Plain twin of kernel B1 (cartpoleplusplus_tpu_torch/ops/fused_rollout.py)
against the JAX `reference_rollout` on the CPU, with tests/test_ops.py's
tolerances; and the wrapper's CPU dispatch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu import CartPole3D as JCartPole3D
from cartpoleplusplus_tpu.ops import fused_rollout as jfr
from cartpoleplusplus_tpu.physics import params as jparams
from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams
from cartpoleplusplus_tpu_torch.models.from_jax import env_state_from_jax
from cartpoleplusplus_tpu_torch.ops import _native, fused_rollout as tfr
from cartpoleplusplus_tpu_torch.physics.params import continuous_params

B, T = 256, 25
PARAMS = {"discrete": (jparams.CartPoleParams(), CartPoleParams()),
          "continuous": (jparams.continuous_params(), continuous_params())}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_reference_rollout_matches_jax(name):
    jp, tp = PARAMS[name]
    jenv = JCartPole3D(jp, num_envs=B)
    jstate0, _ = jax.jit(jenv.reset)(7)
    state0 = env_state_from_jax(jax.device_get(jstate0))
    jstate, jacc = jfr.reference_rollout(jenv, T)(
        jax.tree.map(jnp.copy, jstate0))
    state, acc = tfr.reference_rollout(CartPole3D(tp, num_envs=B,
                                                  device="cpu"), state0, T)
    jph = jstate.phys
    np.testing.assert_allclose(state.phys.pos.numpy(), np.asarray(jph.pos),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(state.phys.s.numpy(), np.asarray(jph.s),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(state.phys.vel.numpy(), np.asarray(jph.vel),
                               rtol=5e-4, atol=5e-4)
    np.testing.assert_array_equal(state.steps.numpy(),
                                  np.asarray(jstate.steps))
    np.testing.assert_array_equal(state.episode.numpy(),
                                  np.asarray(jstate.episode))
    assert int(state.episode.sum()) > 0  # resets happened inside the window
    assert abs(float(acc) - float(jacc)) / max(abs(float(jacc)), 1.0) < 1e-4


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_bench_action_force_matches_jax(name):
    jp, tp = PARAMS[name]
    seeds = np.random.RandomState(1).randint(0, 2**32, size=B,
                                             dtype=np.uint64)
    for t in (0, 3, 999):
        jf = jfr.bench_action_force(jp, jnp.asarray(seeds.astype(np.uint32)),
                                    jnp.uint32(t))
        tf = tfr.bench_action_force(tp, torch.from_numpy(
            seeds.astype(np.int64)), t)
        for a, b in zip(tf, jf):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_wrapper_runs_twin_on_cpu():
    """On CPU tensors the wrapper is the plain twin and launches nothing."""
    env = CartPole3D(continuous_params(), num_envs=64, device="cpu")
    state, _ = env.reset(3)
    before = tfr.fused_rollout.launches
    s1, acc1 = tfr.fused_rollout(env, state, 5)
    s2, acc2 = tfr.reference_rollout(env, state, 5)
    assert tfr.fused_rollout.launches == before
    assert float(acc1) == float(acc2)
    torch.testing.assert_close(s1.phys.pos, s2.phys.pos, rtol=0, atol=0)


def test_wrapper_rejects_other_devices():
    env = CartPole3D(CartPoleParams(), num_envs=8, device="cpu")
    state, _ = env.reset(0)
    meta = type(state)(*(x.to("meta") if isinstance(x, torch.Tensor) else
                         type(x)(*(y.to("meta") for y in x))
                         for x in state))
    with pytest.raises(ValueError):
        tfr.fused_rollout(env, meta, 2)


def test_env_consts_are_the_folded_float32_constants():
    """The kernel constants equal the float32 roundings of the twin's
    folded Python subexpressions."""
    for p in (CartPoleParams(), continuous_params(ground_friction=0.3)):
        c = _native.env_consts(p)
        f32 = lambda v: float(np.float32(v))  # noqa: E731
        assert c.mt_g == f32(p.total_mass * p.gravity)
        assert c.inv_den == f32(1.0 / p.schur_denom)
        assert c.w_min2 == f32(p.w_min * p.w_min)
        assert c.z0 == f32(p.cart_rest_z - p.rest_penetration)
        assert c.reset_mag_span == f32(0.8)
        assert c.tilt_s2_limit == f32(p.tilt_s2_limit)
        assert c.has_push == int(p.push_prob_per_repeat > 0)
        assert c.has_friction == int(p.ground_friction != 0)
        assert c.action_repeats == p.action_repeats


@pytest.mark.parametrize("params", [CartPoleParams(), continuous_params(),
                                    CartPoleParams(s_norm_max=0.9)],
                         ids=["discrete", "continuous", "snm0.9"])
def test_s2_clamp_bounds_the_clamp_that_is_exactly_one(params):
    """The kernels skip the substep's chart clamp for s2 <= s2_clamp: the
    twin's scale min(1, s_norm_max / max(sqrt(s2), 1e-9)) is exactly 1 on
    every s2 up to it (the 4096 floats below it, random ones in [0, it],
    zero and tiny ones) and below 1 just above it."""
    t = np.float32(_native.s2_clamp(params))
    assert np.float32(_native.env_consts(params).s2_clamp) == t
    snm = np.float32(params.s_norm_max)
    up = np.nextafter(t, np.float32(np.inf))
    assert np.sqrt(t) <= snm < np.sqrt(up)
    below = t.view(np.int32) - np.arange(4096, dtype=np.int32)
    rng = np.random.RandomState(0)
    s2 = np.concatenate([below.view(np.float32),
                         rng.uniform(0, t, 4096).astype(np.float32),
                         np.float32([0.0, 1e-45, 1e-30, 1e-18, t])])
    x = torch.from_numpy(s2)
    scale = torch.clamp(params.s_norm_max
                        / torch.clamp(torch.sqrt(x), min=1e-9), max=1.0)
    assert bool((scale == 1.0).all())
    over = torch.from_numpy(np.float32([up]))
    assert float(torch.clamp(params.s_norm_max / torch.sqrt(over),
                             max=1.0)) < 1.0


@pytest.mark.parametrize("name", ["mt", "reset_det"])
def test_constant_divides_as_double_products_are_exact(name):
    """The env math divides by the mass and the reset determinant as
    float(a * inv_b), inv_b = 1/b in double (env_consts' inv_mt and
    inv_reset_det): equal to the float quotient a / b bit for bit on
    random float bit patterns over the whole finite range, on the
    physics' own scale, and at signed zeros."""
    for p in (CartPoleParams(), continuous_params()):
        c = _native.env_consts(p)
        b = np.float32(getattr(c, name))
        y = np.float64(getattr(c, {"mt": "inv_mt",
                                   "reset_det": "inv_reset_det"}[name]))
        assert y == np.float64(1.0) / np.float64(b)
        rng = np.random.RandomState(1)
        bits = rng.randint(0, 2**32, size=400_000, dtype=np.uint64)
        a = bits.astype(np.uint32).view(np.float32)
        a = np.concatenate([a[np.isfinite(a)],
                            rng.uniform(-50, 50, 100_000).astype(np.float32),
                            np.float32([0.0, -0.0, 1.0, -1.0])])
        with np.errstate(over="ignore", under="ignore"):
            got = (a.astype(np.float64) * y).astype(np.float32)
            want = a / b
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("w_min", [0.0, 1e-16])
def test_env_consts_reject_a_w_min_below_the_exact_root_range(w_min):
    """The kernels' fast square root is exact for operands from 2^-101 up,
    and the substep's smallest operand is w_min^2, so the constants
    builder refuses a w_min below 1e-15; 1e-15 itself is taken."""
    with pytest.raises(ValueError, match="w_min"):
        _native.env_consts(CartPoleParams(w_min=w_min))
    assert _native.env_consts(CartPoleParams(w_min=1e-15)).w_min2 > 0.0
