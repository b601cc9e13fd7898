"""Plain twin of kernel B4 (cartpoleplusplus_tpu_torch/ops/q_rollout.py)
against the JAX `reference_q_rollout` and the JAX Pallas kernel in
interpret mode on the CPU, from converted flax Q-net weights and env
state, with tests/test_policy_rollout.py's tolerances: actions exact, obs
and reward within rtol 2e-4 / atol 2e-5, dones, steps and episodes exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu import CartPole3D as JCartPole3D
from cartpoleplusplus_tpu import CartPoleParams as JCartPoleParams
from cartpoleplusplus_tpu.agents import DQN as JDQN
from cartpoleplusplus_tpu.agents import DQNConfig as JDQNConfig
from cartpoleplusplus_tpu.ops.policy_rollout import (
    q_policy_rollout as j_q_policy_rollout,
)
from cartpoleplusplus_tpu.ops.policy_rollout import (
    reference_q_rollout as j_reference_q_rollout,
)
from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams
from cartpoleplusplus_tpu_torch.models.from_jax import (
    env_state_from_jax,
    qnet_from_flax,
)
from cartpoleplusplus_tpu_torch.ops import q_rollout as tqr
from cartpoleplusplus_tpu_torch.physics.params import continuous_params

HIDDEN = (32, 32)
T = 3
B = 1024          # the JAX kernel takes multiples of 1024 envs
EPS = 0.3         # both branches of the epsilon gate


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    """A JAX DQN state whose LayerNorm parameters and head are redrawn
    from a numpy seed (so every stage moves the argmax), and the same
    weights converted to the port."""
    jenv = JCartPole3D(JCartPoleParams(), num_envs=B)
    jagent = JDQN(jenv, JDQNConfig(hidden=HIDDEN, rollout_steps=T,
                                   warmup_env_steps=0, learner="xla"))
    st = jagent.init(0)
    rng = np.random.RandomState(4)
    p = st.q["params"]
    for i in range(len(HIDDEN)):
        ln = p["_Torso_0"][f"LayerNorm_{i}"]
        ln["scale"] = jnp.asarray(
            1.0 + rng.normal(0, 0.2, ln["scale"].shape).astype(np.float32))
        ln["bias"] = jnp.asarray(
            rng.normal(0, 0.1, ln["bias"].shape).astype(np.float32))
    for name, scale in (("kernel", 0.5), ("bias", 0.1)):
        p["Dense_0"][name] = jnp.asarray(rng.normal(
            0, scale, p["Dense_0"][name].shape).astype(np.float32))
    q = qnet_from_flax(jax.device_get(st.q), 42, 5, HIDDEN)
    return jagent, st, q


def _port_inputs(st):
    return (env_state_from_jax(jax.device_get(st.env_state)),
            torch.tensor(np.asarray(st.obs)))


def _assert_rollouts_match(got, want):
    g_state, g_obs, g_traj = got
    w_state, w_obs, w_traj = want
    assert g_traj[1].dtype == torch.int32
    np.testing.assert_array_equal(g_traj[1].numpy(), np.asarray(w_traj[1]))
    for name, a, b in [("obs", g_traj[0], w_traj[0]),
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


def test_reference_q_rollout_matches_jax(setup):
    jagent, st, q = setup
    env = CartPole3D(CartPoleParams(), num_envs=B, device="cpu")
    want = jax.jit(j_reference_q_rollout(jagent, T))(
        st.env_state, st.obs, st.q, jnp.int32(0), jnp.float32(EPS))
    got = tqr.reference_q_rollout(env, q, *_port_inputs(st), 0, EPS, T)
    _assert_rollouts_match(got, want)
    acts = got[2][1].numpy()
    assert len(np.unique(acts)) == 5  # explored and greedy actions
    assert got[2][3].any()  # some envs finished and reset in the window


def test_reference_q_rollout_matches_jax_pallas_kernel(setup):
    """The twin against the reference's own kernel B4 (interpret mode)."""
    _, st, q = setup
    env = CartPole3D(CartPoleParams(), num_envs=B, device="cpu")
    run = j_q_policy_rollout(JCartPole3D(JCartPoleParams(), num_envs=B),
                             HIDDEN, T, interpret=True)
    want = jax.jit(run)(st.env_state, st.obs, st.q, jnp.int32(0),
                        jnp.float32(EPS))
    got = tqr.reference_q_rollout(env, q, *_port_inputs(st), 0, EPS, T)
    _assert_rollouts_match(got, want)


def test_rollout_continues_counters(setup):
    """A second greedy chunk at env_steps=T stays aligned with the
    reference: the counters, not call boundaries, key the draws."""
    jagent, st, q = setup
    env = CartPole3D(CartPoleParams(), num_envs=B, device="cpu")
    ref = jax.jit(j_reference_q_rollout(jagent, T))
    w1 = ref(st.env_state, st.obs, st.q, jnp.int32(0), jnp.float32(EPS))
    w2 = ref(w1[0], w1[1], st.q, jnp.int32(T), jnp.float32(0.0))
    g1 = tqr.reference_q_rollout(env, q, *_port_inputs(st), 0, EPS, T)
    g2 = tqr.reference_q_rollout(env, q, g1[0], g1[1], T, 0.0, T)
    _assert_rollouts_match(g2, w2)


def test_wrapper_runs_twin_on_cpu(setup):
    _, st, q = setup
    env = CartPole3D(CartPoleParams(), num_envs=B, device="cpu")
    before = tqr.q_policy_rollout.launches
    got = tqr.q_policy_rollout(env, q, *_port_inputs(st), 5, EPS, T)
    want = tqr.reference_q_rollout(env, q, *_port_inputs(st), 5, EPS, T)
    assert tqr.q_policy_rollout.launches == before
    for a, b in zip(got[2], want[2]):
        assert torch.equal(a, b)
    for a, b in zip((*got[0].phys, got[1]), (*want[0].phys, want[1])):
        assert torch.equal(a, b)


def test_wrapper_rejects_other_devices(setup):
    _, st, q = setup
    env = CartPole3D(CartPoleParams(), num_envs=B, device="cpu")
    state, obs = _port_inputs(st)
    meta = state._replace(steps=state.steps.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tqr.q_policy_rollout(env, q, meta, obs, 0, EPS, T)


def _packed_forward(flat, obs, hidden, n_out=5):
    """The network read from `pack_tile_net`'s flat buffer (n_out head
    rows) at the offsets the kernel computes (csrc/q_tile.cuh): padded
    torso blocks, the padded head block, then the vectors; the head's
    pre-activations."""
    dims, off, ws = (obs.shape[1],) + tuple(hidden), 0, []
    for a, b in zip(dims[:-1], dims[1:]):
        np_ = (b + 3) // 4 * 4
        w = flat[off:off + a * np_].reshape(a, np_)
        assert not w[:, b:].any()  # zero pad columns
        ws.append(w[:, :b])
        off += a * np_
    assert off == tqr.torso_weight_floats(dims[0], hidden)
    h_w = flat[off:off + 8 * dims[-1]].reshape(dims[-1], 8)
    assert not h_w[:, n_out:].any()
    off += 8 * dims[-1]
    x = obs
    for w, b in zip(ws, hidden):
        bias, scale, shift = flat[off:off + 3 * b].reshape(3, b)
        off += 3 * b
        x = x @ w + bias
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        x = torch.relu((x - mean) * (torch.rsqrt(var + 1e-6) * scale)
                       + shift)
    assert off + n_out == flat.numel()
    return x @ h_w[:, :n_out] + flat[off:]


@pytest.mark.parametrize("hidden", [HIDDEN, (7,), (5, 6, 9, 3, 8)])
def test_pack_qnet_layout(hidden):
    """The kernel's flat weight layout: per layer W (in, Np) with zero pad
    columns to a multiple of 4, the head's W (H, 8), then per layer bias,
    LN scale, LN bias, and the head's bias; read at the kernel's offsets,
    it is the Q-net."""
    g = torch.Generator().manual_seed(2)
    q = _random_port_qnet(hidden, g)
    obs = torch.randn((16, 42), generator=g)
    with torch.no_grad():
        torch.testing.assert_close(_packed_forward(tqr.pack_qnet(q), obs,
                                                   hidden), q(obs),
                                   rtol=1e-5, atol=1e-5)


def _random_port_qnet(hidden, g):
    """A port QNetMLP with its LayerNorm parameters and head redrawn."""
    from cartpoleplusplus_tpu_torch.models import QNetMLP

    return _redrawn(QNetMLP(42, 5, hidden, generator=g), g)


def _redrawn(q, g):
    """A port torso net with its LayerNorm parameters and head redrawn
    (the heads' default inits would hide layout errors)."""
    with torch.no_grad():
        for norm in q.norms:
            norm.weight.copy_(1.0 + 0.2 * torch.randn(norm.weight.shape,
                                                      generator=g))
            norm.bias.copy_(0.1 * torch.randn(norm.bias.shape, generator=g))
        for prm in q.head.parameters():
            prm.copy_(0.5 * torch.randn(prm.shape, generator=g))
    return q


def test_q_fusable_gate():
    env = CartPole3D(CartPoleParams(), num_envs=100, device="cpu")
    assert tqr.q_fusable(env, HIDDEN)  # any batch size: tiles are masked
    assert tqr.q_fusable(env, (256, 256))
    # Any depth and width: wide activations go to a workspace.
    for hidden in ((2048,), (8,) * 5, (4096, 4096), (3,) * 12):
        assert tqr.q_fusable(env, hidden)
    assert not tqr.q_fusable(env, ())
    assert not tqr.q_fusable(CartPole3D(continuous_params(), num_envs=64,
                                        device="cpu"),
                             HIDDEN)  # continuous
    assert not tqr.q_fusable(CartPole3D(CartPoleParams(), num_envs=64,
                                        obs_mode="state", device="cpu"),
                           HIDDEN)
    assert not tqr.q_fusable(CartPole3D(CartPoleParams(), num_envs=64,
                                        auto_reset=False, device="cpu"),
                             HIDDEN)
