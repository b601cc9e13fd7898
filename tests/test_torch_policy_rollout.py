"""Plain twin of kernel B2 (cartpoleplusplus_tpu_torch/ops/policy_rollout.py)
against the JAX `reference_policy_rollout` on the CPU, from converted flax
actor weights and env state, with tests/test_policy_rollout.py's
tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu import CartPole3D as JCartPole3D
from cartpoleplusplus_tpu.agents import DDPG as JDDPG
from cartpoleplusplus_tpu.agents import DDPGConfig as JDDPGConfig
from cartpoleplusplus_tpu.ops.policy_rollout import (
    reference_policy_rollout as j_reference_policy_rollout,
)
from cartpoleplusplus_tpu.physics import params as jparams
from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams
from cartpoleplusplus_tpu_torch.models.from_jax import (
    actor_from_flax,
    env_state_from_jax,
)
from cartpoleplusplus_tpu_torch.ops import policy_rollout as tpr
from cartpoleplusplus_tpu_torch.physics.params import continuous_params

HIDDEN = (32, 32)
T = 3
B = 256
THETA = 0.15


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    """A JAX DDPG state whose actor head is rescaled from a numpy seed
    (the default U[0, 3e-3) head would hide torso errors), and the same
    weights and state converted to the port."""
    jenv = JCartPole3D(jparams.continuous_params(), num_envs=B)
    jagent = JDDPG(jenv, JDDPGConfig(hidden=HIDDEN, rollout_steps=T,
                                     warmup_env_steps=0, learner="xla"))
    st = jagent.init(0)
    rng = np.random.RandomState(4)
    head = st.actor["params"]["Dense_0"]
    head["kernel"] = jnp.asarray(
        rng.normal(0, 0.5, head["kernel"].shape).astype(np.float32))
    head["bias"] = jnp.asarray(
        rng.normal(0, 0.1, head["bias"].shape).astype(np.float32))
    noise = jnp.asarray(rng.normal(0, 0.1, (B, 2)).astype(np.float32))
    st = st._replace(noise=noise)
    actor = actor_from_flax(jax.device_get(st.actor), 42, 2, HIDDEN)
    return jagent, st, actor


def _port_inputs(st):
    return (env_state_from_jax(jax.device_get(st.env_state)),
            torch.tensor(np.asarray(st.obs)),
            torch.tensor(np.asarray(st.noise)))


def _assert_rollouts_match(got, want):
    g_state, g_obs, g_noise, g_traj = got
    w_state, w_obs, w_noise, w_traj = want
    for name, a, b in [("obs", g_traj[0], w_traj[0]),
                       ("action", g_traj[1], w_traj[1]),
                       ("reward", g_traj[2], w_traj[2])]:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5, err_msg=name)
    np.testing.assert_array_equal(g_traj[3].numpy(), np.asarray(w_traj[3]))
    for a, b in zip((*g_state.phys, g_obs, g_noise),
                    (*w_state.phys, w_obs, w_noise)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5)
    np.testing.assert_array_equal(g_state.steps.numpy(),
                                  np.asarray(w_state.steps))
    np.testing.assert_array_equal(g_state.episode.numpy(),
                                  np.asarray(w_state.episode))


def test_reference_policy_rollout_matches_jax(setup):
    jagent, st, actor = setup
    env = CartPole3D(continuous_params(), num_envs=B)
    sigma = 0.2
    want = jax.jit(j_reference_policy_rollout(jagent, T))(
        st.env_state, st.obs, st.noise, st.actor, jnp.int32(0),
        jnp.float32(sigma))
    got = tpr.reference_policy_rollout(env, actor, THETA, *_port_inputs(st),
                                       0, sigma, T)
    _assert_rollouts_match(got, want)
    assert got[3][3].any()  # some envs finished and reset in the window


def test_rollout_continues_counters(setup):
    """A second chunk at env_steps=T keeps the OU streams aligned with the
    reference: the counters, not call boundaries, define the noise."""
    jagent, st, actor = setup
    env = CartPole3D(continuous_params(), num_envs=B)
    ref = jax.jit(j_reference_policy_rollout(jagent, T))
    sigma = jnp.float32(0.1)
    w1 = ref(st.env_state, st.obs, st.noise, st.actor, jnp.int32(0), sigma)
    w2 = ref(w1[0], w1[1], w1[2], st.actor, jnp.int32(T), sigma)
    g1 = tpr.reference_policy_rollout(env, actor, THETA, *_port_inputs(st),
                                      0, 0.1, T)
    g2 = tpr.reference_policy_rollout(env, actor, THETA, g1[0], g1[1], g1[2],
                                      T, 0.1, T)
    _assert_rollouts_match(g2, w2)


def test_ou_step_matches_jax(setup):
    jagent, st, _ = setup
    seeds = st.env_state.env_seed
    want = jagent._ou_step(st.noise, seeds, jnp.int32(17), jnp.float32(0.3))
    got = tpr.ou_step(torch.tensor(np.asarray(st.noise)),
                      torch.tensor(np.asarray(seeds).astype(np.int64)), 17,
                      THETA, 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_wrapper_runs_twin_on_cpu(setup):
    _, st, actor = setup
    env = CartPole3D(continuous_params(), num_envs=B)
    before = tpr.policy_rollout.launches
    got = tpr.policy_rollout(env, actor, THETA, *_port_inputs(st), 0, 0.2, T)
    want = tpr.reference_policy_rollout(env, actor, THETA,
                                        *_port_inputs(st), 0, 0.2, T)
    assert tpr.policy_rollout.launches == before
    for a, b in zip(got[3], want[3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("hidden", [HIDDEN, (7,), (5, 6, 9, 3, 8)])
def test_pack_actor_layout(hidden):
    """The kernel's flat weight layout (B4's, csrc/q_tile.cuh): per layer
    W (in, Np) with zero pad columns to a multiple of 4, the head's W (H,
    8), then per layer bias, LN scale, LN bias, and the head's bias; read
    at the kernel's offsets, tanh of its head is the actor."""
    from cartpoleplusplus_tpu_torch.models import ActorMLP
    from test_torch_q_rollout import _packed_forward, _redrawn

    g = torch.Generator().manual_seed(3)
    actor = _redrawn(ActorMLP(42, 2, hidden, generator=g), g)
    obs = torch.randn((16, 42), generator=g)
    with torch.no_grad():
        torch.testing.assert_close(
            torch.tanh(_packed_forward(tpr.pack_actor(actor), obs, hidden,
                                       2)),
            actor(obs), rtol=1e-5, atol=1e-5)


def test_fusable_gate():
    env = CartPole3D(continuous_params(), num_envs=100)
    assert tpr.fusable(env, HIDDEN)  # any batch size: tiles are masked
    assert tpr.fusable(env, (256, 256))
    # Any depth and width: wide activations go to a workspace.
    for hidden in ((2048,), (8,) * 5, (4096, 4096), (3,) * 12):
        assert tpr.fusable(env, hidden)
    assert not tpr.fusable(env, ())
    assert not tpr.fusable(CartPole3D(CartPoleParams(), num_envs=64),
                           HIDDEN)  # discrete
    assert not tpr.fusable(CartPole3D(continuous_params(), num_envs=64,
                                      obs_mode="state"), HIDDEN)
