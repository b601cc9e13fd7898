"""Plain twin of kernel B6 (cartpoleplusplus_tpu_torch/ops/naf_rollout.py)
against the JAX NAF rollouts on the CPU, from converted flax NafNet weights
and env state, with tests/test_policy_rollout.py's tolerances (rtol 2e-4,
atol 2e-5, dones exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu import CartPole3D as JCartPole3D
from cartpoleplusplus_tpu.agents import NAF as JNAF
from cartpoleplusplus_tpu.agents import NAFConfig as JNAFConfig
from cartpoleplusplus_tpu.ops.policy_rollout import (
    naf_policy_rollout as j_naf_policy_rollout,
)
from cartpoleplusplus_tpu.ops.policy_rollout import (
    reference_naf_rollout as j_reference_naf_rollout,
)
from cartpoleplusplus_tpu.physics import params as jparams
from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams
from cartpoleplusplus_tpu_torch.agents.common import TAG_NAF_X, TAG_NAF_Y
from cartpoleplusplus_tpu_torch.models.from_jax import (
    env_state_from_jax,
    naf_from_flax,
)
from cartpoleplusplus_tpu_torch.ops import naf_rollout as tnr
from cartpoleplusplus_tpu_torch.physics.params import continuous_params

HIDDEN = (32, 32)
T = 3
B = 1024
SIGMA = 0.2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    """A JAX NAF state whose mu head is redrawn from a numpy seed (the
    U[0, 3e-3) init would hide torso errors), and the same weights and
    state converted to the port."""
    jenv = JCartPole3D(jparams.continuous_params(), num_envs=B)
    jagent = JNAF(jenv, JNAFConfig(hidden=HIDDEN, rollout_steps=T))
    st = jagent.init(0)
    rng = np.random.RandomState(4)
    head = st.params["params"]["Dense_1"]
    head["kernel"] = jnp.asarray(
        rng.normal(0, 0.5, head["kernel"].shape).astype(np.float32))
    head["bias"] = jnp.asarray(
        rng.normal(0, 0.1, head["bias"].shape).astype(np.float32))
    net = naf_from_flax(jax.device_get(st.params), 42, 2, HIDDEN)
    return jagent, st, net


def _port_inputs(st):
    return (env_state_from_jax(jax.device_get(st.env_state)),
            torch.tensor(np.asarray(st.obs)))


def _assert_rollouts_match(got, want):
    g_state, g_obs, g_traj = got
    w_state, w_obs, w_traj = want
    for name, a, b in [("obs", g_traj[0], w_traj[0]),
                       ("action", g_traj[1], w_traj[1]),
                       ("reward", g_traj[2], w_traj[2])]:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5, err_msg=name)
    np.testing.assert_array_equal(g_traj[3].numpy(), np.asarray(w_traj[3]))
    for a, b in zip((*g_state.phys, g_obs), (*w_state.phys, w_obs)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5)
    np.testing.assert_array_equal(g_state.steps.numpy(),
                                  np.asarray(w_state.steps))
    np.testing.assert_array_equal(g_state.episode.numpy(),
                                  np.asarray(w_state.episode))


def test_reference_naf_rollout_matches_jax(setup):
    jagent, st, net = setup
    env = CartPole3D(continuous_params(), num_envs=B)
    want = jax.jit(j_reference_naf_rollout(jagent, T))(
        st.env_state, st.obs, st.params, jnp.int32(0), jnp.float32(SIGMA))
    got = tnr.reference_naf_rollout(env, net, *_port_inputs(st), 0, SIGMA, T)
    _assert_rollouts_match(got, want)
    assert got[2][3].any()  # some envs finished and reset in the window
    assert bool((got[2][1].abs() == 1.0).any())  # and some actions clipped


def test_reference_naf_rollout_matches_jax_pallas_kernel(setup):
    """The twin against the reference's B6 (the Pallas kernel in interpret
    mode, ~10 s here) at the same bars."""
    jagent, st, net = setup
    env = CartPole3D(continuous_params(), num_envs=B)
    run = jax.jit(j_naf_policy_rollout(jagent.env, HIDDEN, T,
                                       interpret=True))
    want = run(st.env_state, st.obs, st.params, jnp.int32(5),
               jnp.float32(SIGMA))
    got = tnr.reference_naf_rollout(env, net, *_port_inputs(st), 5, SIGMA, T)
    _assert_rollouts_match(got, want)


def test_rollout_continues_counters(setup):
    """A second chunk at env_steps=T keeps the noise aligned with the
    reference: the counters, not call boundaries, define it."""
    jagent, st, net = setup
    env = CartPole3D(continuous_params(), num_envs=B)
    ref = jax.jit(j_reference_naf_rollout(jagent, T))
    w1 = ref(st.env_state, st.obs, st.params, jnp.int32(0), jnp.float32(0.1))
    w2 = ref(w1[0], w1[1], st.params, jnp.int32(T), jnp.float32(0.1))
    g1 = tnr.reference_naf_rollout(env, net, *_port_inputs(st), 0, 0.1, T)
    g2 = tnr.reference_naf_rollout(env, net, g1[0], g1[1], T, 0.1, T)
    _assert_rollouts_match(g2, w2)


@pytest.mark.parametrize("t,sigma", [(17, 0.3), (40, 0.0), (3, 1.0)])
def test_naf_action_matches_jax_act(setup, t, sigma):
    """`naf_action` on the port's mu against the reference's NAF.act: the
    noisy, clipped actions within 1e-6 (the same counter normals)."""
    jagent, st, net = setup
    obs = np.array(st.obs)
    seeds = np.array(st.env_state.env_seed)
    want = jagent.act(st.params, jnp.asarray(obs), jnp.asarray(seeds),
                      jnp.int32(t), jnp.float32(sigma))
    with torch.no_grad():
        mu = net(torch.from_numpy(obs))[1]
    got = tnr.naf_action(mu, torch.from_numpy(seeds.astype(np.int64)), t,
                         sigma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert (TAG_NAF_X, TAG_NAF_Y) == (0x45, 0x46)


def test_wrapper_runs_twin_on_cpu(setup):
    _, st, net = setup
    env = CartPole3D(continuous_params(), num_envs=B)
    before = tnr.naf_policy_rollout.launches
    got = tnr.naf_policy_rollout(env, net, *_port_inputs(st), 0, SIGMA, T)
    want = tnr.reference_naf_rollout(env, net, *_port_inputs(st), 0, SIGMA,
                                      T)
    assert tnr.naf_policy_rollout.launches == before
    for a, b in zip(got[2], want[2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("hidden", [HIDDEN, (7,), (5, 6, 9, 3, 8)])
def test_pack_naf_mu_layout(hidden):
    """B2's flat layout (csrc/q_tile.cuh) over the torso, then the packed
    head's mu rows (1 and 2) in the padded (H, 8) block, and their biases;
    the V and L rows stay out. Read at the kernel's offsets, tanh of its
    head is NafNet's mu."""
    from cartpoleplusplus_tpu_torch.models import NafNet
    from test_torch_q_rollout import _packed_forward, _redrawn

    g = torch.Generator().manual_seed(5)
    net = _redrawn(NafNet(42, 2, hidden, generator=g), g)
    obs = torch.randn((16, 42), generator=g)
    with torch.no_grad():
        torch.testing.assert_close(
            torch.tanh(_packed_forward(tnr.pack_naf_mu(net), obs, hidden,
                                       2)),
            net(obs)[1], rtol=1e-5, atol=1e-5)


def test_naf_fusable_is_b2s_window():
    env = CartPole3D(continuous_params(), num_envs=100)
    for hidden in (HIDDEN, (256, 256), (2048,), (8,) * 5, (64,),
                   (4096, 4096), (3,) * 12, ()):
        assert tnr.naf_fusable(env, hidden) == tnr.fusable(env, hidden)
    assert tnr.naf_fusable(env, (256, 256))
    # Any depth and width, as B2 (and the reference's naf_fusable).
    for hidden in ((2048,), (8,) * 5, (4096, 4096), (3,) * 12):
        assert tnr.naf_fusable(env, hidden)
    assert not tnr.naf_fusable(env, ())
    assert not tnr.naf_fusable(CartPole3D(CartPoleParams(), num_envs=64),
                               HIDDEN)  # discrete
    assert not tnr.naf_fusable(CartPole3D(continuous_params(), num_envs=64,
                                          obs_mode="state"), HIDDEN)
