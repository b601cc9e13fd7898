"""The port's DQN (Q-net, epsilon schedule, acting, the loss and one plain
update, train steps on both learners, the JAX-state bridge, the CLI)
against the JAX reference on the CPU."""

import contextlib
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cartpoleplusplus_tpu import CartPole3D as JCartPole3D
from cartpoleplusplus_tpu import CartPoleParams as JCartPoleParams
from cartpoleplusplus_tpu.agents import DQN as JDQN
from cartpoleplusplus_tpu.agents import DQNConfig as JDQNConfig
from cartpoleplusplus_tpu.models import QNetMLP as JQNetMLP
from cartpoleplusplus_tpu.models import polyak as jpolyak
from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams
from cartpoleplusplus_tpu_torch import train as ttrain
from cartpoleplusplus_tpu_torch.agents import DQN, DQNConfig
from cartpoleplusplus_tpu_torch.agents.common import AdamState
from cartpoleplusplus_tpu_torch.agents.dqn import DQNState
from cartpoleplusplus_tpu_torch.models import QNetMLP
from cartpoleplusplus_tpu_torch.models.from_jax import (
    dqn_state_from_jax,
    qnet_from_flax,
    qnet_state_dict,
)
from test_torch_ddpg import (_column_indices, _cuda_kernel_rollout,
                             _cuda_plain_rollout, _perturb)

HIDDEN = (32, 32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(learner="xla", b=64, **kw):
    cfg = dict(hidden=HIDDEN, **kw)
    jagent = JDQN(JCartPole3D(JCartPoleParams(), num_envs=b),
                  JDQNConfig(learner=learner, **cfg))
    agent = DQN(CartPole3D(CartPoleParams(), num_envs=b),
                DQNConfig(learner=learner, **cfg))
    return jagent, agent


@pytest.mark.parametrize("hidden", [HIDDEN, (24,), (16, 24, 8)])
def test_qnet_matches_flax(hidden):
    obs = np.random.RandomState(0).normal(0, 1, (64, 42)).astype(np.float32)
    jq = _perturb(JQNetMLP(hidden=hidden).init(jax.random.PRNGKey(0),
                                               obs[:1]), 1)
    q = qnet_from_flax(jax.device_get(jq), 42, 5, hidden)
    with torch.no_grad():
        got = q(torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(got, np.asarray(JQNetMLP(hidden=hidden).apply(
        jq, obs)), rtol=1e-5, atol=1e-6)


def test_qnet_head_init_is_lecun():
    """The Q head takes flax's default Dense init (truncated lecun normal,
    zero bias), not the DDPG heads' U[0, 3e-3)."""
    net = QNetMLP(42, 5, (256, 256),
                  generator=torch.Generator().manual_seed(0))
    w = net.head.weight.detach()
    std = (1 / 256) ** 0.5
    assert float(w.min()) < -3e-3 and float(w.max()) > 3e-3
    assert abs(float(w.std()) - std) < 0.1 * std
    assert float(w.abs().max()) <= 2 * std / 0.8796
    assert float(net.head.bias.detach().abs().max()) == 0.0


@pytest.mark.parametrize("decay", [10000, 1200, 0, -5])
def test_epsilon_matches_jax_bitwise(decay):
    """The float32 linear schedule, including the no-decay guard
    (tests/test_agents.py::test_dqn_epsilon_no_decay_guard)."""
    jagent, agent = _pair(b=4, eps_decay_env_steps=decay)
    for steps in (0, 8, 333, 1199, 1200, 5000, 20000):
        got = agent.epsilon(steps)
        assert np.isfinite(got)
        assert np.float32(got) == np.float32(jagent.epsilon(jnp.int32(steps)))
    if decay <= 0:
        assert agent.epsilon(100) == float(np.float32(agent.cfg.eps_end))


def test_act_matches_jax():
    """Epsilon-greedy actions from the same weights, seeds and step."""
    jagent, agent = _pair(b=256)
    st = jagent.init(0)
    jq = _perturb(st.q, 2)
    q = qnet_from_flax(jax.device_get(jq), 42, 5, HIDDEN)
    obs = np.array(st.obs)
    seeds = np.array(st.env_state.env_seed)
    for t, eps in ((17, 0.3), (40, 0.0), (3, 1.0)):
        want = jagent.act(jq, jnp.asarray(obs), jnp.asarray(seeds),
                          jnp.int32(t), jnp.float32(eps))
        got = agent.act(q, torch.from_numpy(obs),
                        torch.from_numpy(seeds.astype(np.int64)), t, eps)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if eps > 0.0:  # explored actions: every index drawn
            assert len(np.unique(got.numpy())) == 5


def _batch(seed, bm=64):
    rng = np.random.RandomState(seed)
    obs = (0.3 * rng.normal(size=(bm, 42))).astype(np.float32)
    return (obs, rng.randint(0, 5, (bm,)).astype(np.int32),
            rng.uniform(size=(bm,)).astype(np.float32),
            (obs + 0.05 * rng.normal(size=obs.shape)).astype(np.float32),
            rng.uniform(size=(bm,)) < 0.1)


@pytest.mark.parametrize("double_dqn", [True, False], ids=["double", "max"])
def test_loss_and_plain_update_match_jax(double_dqn):
    """`_loss` and one `_update_once` (Huber TD, optax Adam from warmed
    moments, Polyak) against the reference's upd_body math: loss within
    rtol 1e-5, the updated Q-net and target within rtol 1e-5, atol 1e-7."""
    jagent, agent = _pair(b=8, double_dqn=double_dqn, lr=1e-3, tau=0.05)
    init = JQNetMLP(hidden=HIDDEN).init(jax.random.PRNGKey(0),
                                        np.zeros((1, 42), np.float32))
    jq, jqt = _perturb(init, 3), _perturb(init, 4)
    rng = np.random.RandomState(5)
    mu = jax.tree.map(lambda x: jnp.asarray(
        rng.normal(0, 1e-2, x.shape).astype(np.float32)), init)
    nu = jax.tree.map(lambda x: jnp.asarray(
        (rng.normal(0, 1e-2, x.shape) ** 2 + 1e-5).astype(np.float32)), init)
    adam = jagent.tx.init(jq)
    jopt = (adam[0]._replace(count=jnp.int32(30), mu=mu, nu=nu),) \
        + tuple(adam[1:])
    batch = _batch(6)
    jbatch = tuple(jnp.asarray(x) for x in batch)

    jloss, grad = jax.value_and_grad(jagent._loss)(jq, jqt, jbatch)
    upd, _ = jagent.tx.update(grad, jopt, jq)
    jq2 = optax.apply_updates(jq, upd)
    jqt2 = jpolyak(jqt, jq2, agent.cfg.tau)

    q = qnet_from_flax(jax.device_get(jq), 42, 5, HIDDEN)
    qt = qnet_from_flax(jax.device_get(jqt), 42, 5, HIDDEN)

    def moments(tree):
        sd = qnet_state_dict(jax.device_get(tree), HIDDEN)
        return [sd[n].clone() for n, _ in q.named_parameters()]

    st = DQNState(q=q, q_target=qt,
                  opt=AdamState(count=30, mu=moments(mu), nu=moments(nu)),
                  replay=None, env_state=None, obs=None, generator=None,
                  env_steps=0)
    tbatch = tuple(torch.from_numpy(np.asarray(x)) for x in batch)
    loss = agent._loss(q, qt, tbatch).detach()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    st2, m = agent._update_once(st, tbatch)
    np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-5)
    assert st2.opt.count == 31
    for net, tree in ((st2.q, jq2), (st2.q_target, jqt2)):
        sd = qnet_state_dict(jax.device_get(tree), HIDDEN)
        for name, p in net.state_dict().items():
            np.testing.assert_allclose(p.numpy(), sd[name].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=name)


def _uniform_indices(jagent, st, num_updates, filled, cursor):
    """The (env_idx, slot) the reference's presample_uniform draws for the
    next learning step (agents/common.py::gated_update_scan splits st.rng,
    then one key per update)."""
    rb, bs = jagent.replay, jagent.cfg.batch_size
    n_valid = max(filled - 1, 1)
    _, k = jax.random.split(st.rng)
    env_idx, slots = [], []
    for key in jax.random.split(k, num_updates):
        k_env, k_slot = jax.random.split(key)
        env_idx.append(np.asarray(jax.random.randint(k_env, (bs,), 0,
                                                     rb.num_envs)))
        age = np.asarray(jax.random.randint(k_slot, (bs,), 1, n_valid + 1))
        slots.append((cursor - 1 - age) % rb.capacity)
    return np.stack(env_idx), np.stack(slots)


def _train_pair(learner, sample, steps=4):
    """`steps` reference train steps (fused=False) and the port's from the
    converted initial state, with the reference's replay draws injected."""
    k, t, cap = 2, 4, 16
    jagent, agent = _pair(learner, warmup_env_steps=8, updates_per_step=k,
                          batch_size=32, rollout_steps=t,
                          replay_capacity_per_env=cap,
                          eps_decay_env_steps=100, sample=sample)
    assert agent.kernel_mode == (learner == "kernel") == jagent.kernel_mode
    jstep = jax.jit(functools.partial(jagent.train_step, fused=False))
    draw = _column_indices if sample == "column" else _uniform_indices
    jst = jagent.init(0)
    pst = dqn_state_from_jax(agent, jax.device_get(jst))
    pairs = []
    for i in range(1, steps + 1):
        ready = i * t >= agent.cfg.warmup_env_steps
        indices = (draw(jagent, jst, k, min(i * t, cap), (i * t) % cap)
                   if ready else None)
        jst, jm = jstep(jst)
        pst, m = agent.train_step(pst, fused=False, indices=indices)
        pairs.append((m, jm))
    return jagent, jst, pst, pairs


def _assert_train_match(jagent, jst, pst, pairs, rtol, atol):
    for m, jm in pairs:
        assert m["epsilon"] == float(jm["epsilon"])
        assert m["rollout_impl"] == 0.0
        assert m["learner_impl"] == float(jm["learner_impl"])
        for key in ("loss", "reward_mean", "done_frac"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=rtol, atol=atol, err_msg=key)
    assert float(pairs[-1][0]["loss"]) > 0.0
    jst = jax.device_get(jagent.state_to_tree(jst))
    for net, tree in ((pst.q, jst.q), (pst.q_target, jst.q_target)):
        sd = qnet_state_dict(tree, HIDDEN)
        for name, p in net.state_dict().items():
            np.testing.assert_allclose(p.numpy(), sd[name].numpy(),
                                       rtol=rtol, atol=atol, err_msg=name)
    assert pst.opt.count == int(jst.opt[0].count) == 6
    assert pst.replay.cursor == int(jst.replay.cursor)
    np.testing.assert_array_equal(pst.replay.action.numpy(),
                                  np.asarray(jst.replay.action))
    np.testing.assert_allclose(pst.replay.obs.numpy(),
                               np.asarray(jst.replay.obs), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("sample", ["column", "uniform"])
def test_train_steps_match_jax_xla_learner(sample):
    """4 train steps (3 past the warmup, 6 updates) of the plain learner
    from the converted initial state against JAX train_step(fused=False)
    with learner='xla', the reference's replay draws injected: metrics,
    Q-net and target within rtol 1e-4, atol 1e-6."""
    _assert_train_match(*_train_pair("xla", sample), rtol=1e-4, atol=1e-6)


def test_train_steps_match_jax_kernel_learner():
    """DQN(learner='kernel') on the CPU (B5's twin through its wrapper)
    against the reference's kernel mode (its Pallas kernel in interpret
    mode), 4 train steps: within the reference's own kernel-vs-XLA bar,
    rtol 2e-4, atol 1e-5 (tests/test_learner_kernel.py)."""
    _assert_train_match(*_train_pair("kernel", "column"), rtol=2e-4,
                        atol=1e-5)


@pytest.mark.parametrize("learner", ["xla", "kernel"])
def test_dqn_state_from_jax_round_trip(learner):
    """A reference state after one learning step (both of its layouts)
    converts to the port exactly: parameters, target, Adam moments and
    count, the int32 replay ring, env state and counters; in kernel mode
    the port's modules are views of its 4 group buffers."""
    jagent, agent = _pair(learner, warmup_env_steps=0, updates_per_step=2,
                          batch_size=32, rollout_steps=4,
                          replay_capacity_per_env=16)
    jst, _ = jax.jit(functools.partial(jagent.train_step, fused=False))(
        jagent.init(0))
    pst = dqn_state_from_jax(agent, jax.device_get(jst))
    tree = jax.device_get(jagent.state_to_tree(jst))
    for net, t in ((pst.q, tree.q), (pst.q_target, tree.q_target)):
        sd = qnet_state_dict(t, HIDDEN)
        for name, p in net.state_dict().items():
            assert torch.equal(p, sd[name]), name
    for got, t in ((pst.opt.mu, tree.opt[0].mu), (pst.opt.nu, tree.opt[0].nu)):
        sd = qnet_state_dict(t, HIDDEN)
        for (name, _), x in zip(pst.q.named_parameters(), got):
            assert torch.equal(x, sd[name]), name
    assert pst.opt.count == int(tree.opt[0].count) == 2
    assert pst.replay.action.dtype == torch.int32
    np.testing.assert_array_equal(pst.replay.action.numpy(),
                                  np.asarray(tree.replay.action))
    assert pst.env_steps == int(tree.env_steps) == 4
    np.testing.assert_array_equal(pst.env_state.episode.numpy(),
                                  np.asarray(tree.env_state.episode))
    assert (pst.groups is not None) == (learner == "kernel")
    if pst.groups is not None:
        assert pst.q.torso[0].weight.untyped_storage().data_ptr() == \
            pst.groups[0].untyped_storage().data_ptr()


def test_train_cli_cpu():
    """train.main --agent dqn on the CPU at 64 envs for 3 train steps: rc 0,
    finite metrics, epsilon decaying, the plain learner past the warmup,
    and an eval line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ttrain.main(["--agent", "dqn", "--device", "cpu",
                          "--num-envs", "64", "--total-env-steps", "24",
                          "--log-interval", "1", "--dqn.hidden", "32", "32",
                          "--dqn.replay-capacity-per-env", "64",
                          "--final-eval", "--eval-steps", "20"])
    assert rc == 0
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    steps = lines[:-1]
    assert [x["train_step"] for x in steps] == [1, 2, 3]
    for x in lines:
        assert all(np.isfinite(v) for v in x.values()), x
    assert steps[0]["loss"] == 0.0 and steps[0]["epsilon"] == 1.0
    assert all(x["loss"] > 0.0 for x in steps[1:])  # warmup 16 env-steps
    assert steps[2]["epsilon"] < steps[1]["epsilon"] < 1.0
    assert all(x["learner_impl"] == 0.0 and x["rollout_impl"] == 0.0
               for x in steps)
    assert 0 < lines[-1]["eval_mean_episode_length"] <= 20


def test_train_cli_cuda_without_gpu_is_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert ttrain.main(["--agent", "dqn", "--num-envs", "8"]) == 2
    assert "no CUDA device" in err.getvalue()


@pytest.mark.parametrize("argv", [["--obs-mode", "state"],
                                  ["--dqn.hidden", *["8"] * 5],
                                  ["--dqn.hidden", "2048"]])
def test_train_cli_cuda_rejects_shapes_b4_does_not_cover(argv):
    """On a GPU a shape B4 does not cover (state obs) runs the plain
    rollout on the card: the agent resolves to it at construction with one
    stderr line naming the kernel. Any depth and width of the torso takes
    the kernel route with no such line (train.build with --device cuda; no
    card here to train on)."""
    covered = argv[0] == "--dqn.hidden"
    argv = ["--agent", "dqn", "--num-envs", "8", *argv]
    if covered:
        assert _cuda_kernel_rollout(argv, "B4")
    else:
        assert _cuda_plain_rollout(argv, "B4")


@pytest.mark.parametrize("argv", [["--agent", "naf",
                                   "--naf.learner-precision", "highest"],
                                  ["--agent", "naf", "--obs-mode", "pixels"],
                                  ["--agent", "lrpg", "--lrpg.dtype",
                                   "bfloat16"],
                                  ["--agent", "dqn", "--dqn.sample", "block"],
                                  ["--agent", "dqn", "--dqn.dtype",
                                   "bfloat16"]])
def test_train_cli_rejects_unported_dqn_neighbours(argv):
    """DQN, NAF and LRPG settings the port lacks (pixel NAF waits for the
    pixels slice)."""
    with contextlib.redirect_stderr(io.StringIO()):
        assert ttrain.main(["--device", "cpu", "--num-envs", "8",
                            *argv]) == 2


def test_dqn_rejects_the_continuous_env():
    from cartpoleplusplus_tpu_torch.physics.params import continuous_params

    with pytest.raises(ValueError, match="discrete env"):
        DQN(CartPole3D(continuous_params(), num_envs=4), DQNConfig())


def test_port_imports_no_jax():
    """The DQN, LRPG and NAF slices, the random agent, the renderer and
    chip_smoke.py import neither JAX nor the JAX package: the GPU machine
    has no JAX."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, chip_smoke, cartpoleplusplus_tpu_torch.train, "
            "cartpoleplusplus_tpu_torch.agents.dqn, "
            "cartpoleplusplus_tpu_torch.ops.q_rollout, "
            "cartpoleplusplus_tpu_torch.agents.lrpg, "
            "cartpoleplusplus_tpu_torch.agents.random_agent, "
            "cartpoleplusplus_tpu_torch.ops.pg_rollout, "
            "cartpoleplusplus_tpu_torch.agents.naf, "
            "cartpoleplusplus_tpu_torch.ops.naf_rollout, "
            "cartpoleplusplus_tpu_torch.ops.learner_kernel, "
            "cartpoleplusplus_tpu_torch.models.from_jax, "
            "cartpoleplusplus_tpu_torch.env.pixels, "
            "cartpoleplusplus_tpu_torch.ops.render_kernel; "
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'cartpoleplusplus_tpu.')) or "
            "m == 'cartpoleplusplus_tpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
