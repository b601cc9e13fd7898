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
    state, acc = tfr.reference_rollout(CartPole3D(tp, num_envs=B), state0, T)
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
    env = CartPole3D(continuous_params(), num_envs=64)
    state, _ = env.reset(3)
    before = tfr.fused_rollout.launches
    s1, acc1 = tfr.fused_rollout(env, state, 5)
    s2, acc2 = tfr.reference_rollout(env, state, 5)
    assert tfr.fused_rollout.launches == before
    assert float(acc1) == float(acc2)
    torch.testing.assert_close(s1.phys.pos, s2.phys.pos, rtol=0, atol=0)


def test_wrapper_rejects_other_devices():
    env = CartPole3D(CartPoleParams(), num_envs=8)
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
