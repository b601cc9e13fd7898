"""The port's DDPG (networks, one train step, the CLI) against the JAX
reference on the CPU."""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu import CartPole3D as JCartPole3D
from cartpoleplusplus_tpu.agents import DDPG as JDDPG
from cartpoleplusplus_tpu.agents import DDPGConfig as JDDPGConfig
from cartpoleplusplus_tpu.models import ActorMLP as JActorMLP
from cartpoleplusplus_tpu.models import CriticMLP as JCriticMLP
from cartpoleplusplus_tpu.physics import params as jparams
from cartpoleplusplus_tpu_torch import CartPole3D
from cartpoleplusplus_tpu_torch import train as ttrain
from cartpoleplusplus_tpu_torch.agents import DDPG, DDPGConfig
from cartpoleplusplus_tpu_torch.models.from_jax import (
    actor_from_flax,
    actor_state_dict,
    critic_from_flax,
    critic_state_dict,
    ddpg_state_from_jax,
)
from cartpoleplusplus_tpu_torch.physics.params import continuous_params

HIDDEN = (32, 32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _perturb(tree, seed):
    """Random values for every leaf (numpy seed), so LayerNorm scales and
    biases and the heads are exercised away from their init."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: jnp.asarray(rng.normal(0, 0.5, x.shape).astype(np.float32)),
        tree)


@pytest.mark.parametrize("hidden", [HIDDEN, (24,), (16, 24, 8)])
def test_nets_match_flax(hidden):
    rng = np.random.RandomState(0)
    obs = rng.normal(0, 1, (64, 42)).astype(np.float32)
    act = rng.uniform(-1, 1, (64, 2)).astype(np.float32)
    ja = _perturb(JActorMLP(hidden=hidden).init(jax.random.PRNGKey(0),
                                                obs[:1]), 1)
    jc = _perturb(JCriticMLP(hidden=hidden).init(jax.random.PRNGKey(1),
                                                 obs[:1], act[:1]), 2)
    actor = actor_from_flax(jax.device_get(ja), 42, 2, hidden)
    critic = critic_from_flax(jax.device_get(jc), 42, 2, hidden)
    with torch.no_grad():
        a = actor(torch.from_numpy(obs)).numpy()
        q = critic(torch.from_numpy(obs), torch.from_numpy(act)).numpy()
    np.testing.assert_allclose(a, np.asarray(JActorMLP(hidden=hidden).apply(
        ja, obs)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(q, np.asarray(JCriticMLP(hidden=hidden).apply(
        jc, obs, act)), rtol=1e-5, atol=1e-6)


def test_init_distributions():
    """Heads draw from U[0, 3e-3) (flax's uniform(3e-3)), torso kernels
    from a truncated lecun normal, biases are zero."""
    from cartpoleplusplus_tpu_torch.models import ActorMLP

    net = ActorMLP(42, 2, (256, 256), generator=torch.Generator().manual_seed(0))
    w = net.head.weight.detach()
    assert float(w.min()) >= 0.0 and float(w.max()) < 3e-3
    std = float(net.torso[1].weight.detach().std())
    assert abs(std - (1 / 256) ** 0.5) < 0.1 * (1 / 256) ** 0.5
    assert float(net.torso[0].weight.detach().abs().max()) <= 2 * (1 / 42) ** 0.5 / 0.8796
    assert float(net.torso[0].bias.detach().abs().max()) == 0.0


def _column_indices(jagent, st, num_updates, filled, cursor):
    """The (slots, offs) the reference's presample_columns draws for the
    next train step's learner phase (agents/common.py::gated_update_scan
    splits st.rng, then one key per update)."""
    rb, cfg = jagent.replay, jagent.cfg
    k_cols = -(-cfg.batch_size // rb.num_envs)
    n_valid = max(filled - 1, 1)
    _, k = jax.random.split(st.rng)
    slots, offs = [], []
    for key in jax.random.split(k, num_updates):
        k_slot, k_env = jax.random.split(key)
        ages = jax.random.randint(k_slot, (k_cols,), 1, n_valid + 1)
        offs.append(int(jax.random.randint(k_env, (), 0, k_cols * rb.num_envs)))
        slots.append((cursor - 1 - np.asarray(ages)) % rb.capacity)
    return np.stack(slots), np.asarray(offs)


def test_train_step_matches_jax_xla_learner():
    """One train_step(fused=False) from a converted JAX DDPG(learner='xla')
    state, with the reference's replay draws injected: losses and every
    updated network within rtol 1e-4, atol 1e-6."""
    b, t, k = 64, 4, 2
    kw = dict(hidden=HIDDEN, warmup_env_steps=0, updates_per_step=k,
              batch_size=32, rollout_steps=t, replay_capacity_per_env=16)
    jagent = JDDPG(JCartPole3D(jparams.continuous_params(), num_envs=b),
                   JDDPGConfig(learner="xla", **kw))
    agent = DDPG(CartPole3D(continuous_params(), num_envs=b),
                 DDPGConfig(learner="xla", **kw))
    jstep = jax.jit(jagent.train_step)
    st1, _ = jstep(jagent.init(0))  # a state with replay and Adam moments
    indices = _column_indices(jagent, st1, k, filled=2 * t, cursor=2 * t)
    st2, jm = jstep(st1)

    pst = ddpg_state_from_jax(agent, jax.device_get(st1))
    pst2, m = agent.train_step(pst, fused=False, indices=indices)

    for key in ("critic_loss", "actor_loss", "reward_mean", "done_frac"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    assert float(jm["critic_loss"]) > 0.0 and m["learner_impl"] == 0.0
    st2 = jax.device_get(st2)
    for name, net, sd in [
            ("actor", pst2.actor, actor_state_dict(st2.actor, HIDDEN)),
            ("critic", pst2.critic, critic_state_dict(st2.critic, HIDDEN)),
            ("actor_target", pst2.actor_target,
             actor_state_dict(st2.actor_target, HIDDEN)),
            ("critic_target", pst2.critic_target,
             critic_state_dict(st2.critic_target, HIDDEN))]:
        for pname, p in net.state_dict().items():
            np.testing.assert_allclose(p.numpy(), sd[pname].numpy(),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name}.{pname}")
    assert pst2.actor_opt.count == int(st2.actor_opt[0].count)
    assert pst2.replay.cursor == int(st2.replay.cursor)
    np.testing.assert_allclose(pst2.replay.obs.numpy(),
                               np.asarray(st2.replay.obs), rtol=2e-4,
                               atol=2e-5)


def test_unported_learner_settings_raise():
    """The learner settings the port still lacks raise at construction, and
    so does learner='kernel' where B3 does not cover the config."""
    env = CartPole3D(continuous_params(), num_envs=8)
    for kw in (dict(learner_precision="bfloat16"), dict(dtype="bfloat16"),
               dict(sample="uniform")):
        with pytest.raises(ValueError, match="not ported"):
            DDPG(env, DDPGConfig(**kw))
    with pytest.raises(ValueError, match="not covered by the fused update"):
        DDPG(env, DDPGConfig(learner="kernel", polyak_cadence="per_step"))


def test_train_cli_cpu():
    """train.main on the CPU at 64 envs for 2 train steps: rc 0, finite
    metrics, the plain learner, and an eval line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ttrain.main(["--device", "cpu", "--num-envs", "64",
                          "--total-env-steps", "16", "--log-interval", "1",
                          "--ddpg.hidden", "32", "32",
                          "--ddpg.replay-capacity-per-env", "64",
                          "--final-eval", "--eval-steps", "20"])
    assert rc == 0
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert [x["train_step"] for x in lines[:-1]] == [1, 2]
    for x in lines:
        assert all(np.isfinite(v) for v in x.values()), x
    assert lines[1]["critic_loss"] > 0.0 and lines[1]["learner_impl"] == 0.0
    assert lines[1]["rollout_impl"] == 0.0  # CPU tensors: the plain twin
    assert 0 < lines[-1]["eval_mean_episode_length"] <= 20


@pytest.mark.parametrize("argv", [["--obs-mode", "state"],
                                  ["--ddpg.hidden", *["8"] * 5]])
def test_train_cli_cuda_rejects_shapes_b2_does_not_cover(argv):
    """On a GPU a shape B2 does not cover (state obs) runs the plain
    rollout on the card: the agent resolves to it at construction with one
    stderr line naming the kernel. Any depth and width of the torso takes
    the kernel route with no such line (train.build with --device cuda; no
    card here to train on)."""
    argv = ["--num-envs", "8", *argv]
    if "--ddpg.hidden" in argv:
        assert _cuda_kernel_rollout(argv, "B2")
    else:
        assert _cuda_plain_rollout(argv, "B2")


def _cuda_rollout_route(argv, kernel):
    """train.build on --device cuda: the agent's `kernel_rollout` and the
    number of stderr lines saying that `kernel` does not cover it."""
    args = ttrain.build_parser().parse_args(["--device", "cuda", *argv])
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        _, agent = ttrain.build(ttrain.from_args(ttrain.RunConfig, args),
                                args, set())
    told = [ln for ln in err.getvalue().splitlines()
            if f"kernel {kernel} does not cover" in ln]
    return agent.kernel_rollout, len(told)


def _cuda_plain_rollout(argv, kernel):
    """Whether train.build on --device cuda resolves the agent to the plain
    rollout with exactly one stderr line naming `kernel`."""
    return _cuda_rollout_route(argv, kernel) == (False, 1)


def _cuda_kernel_rollout(argv, kernel):
    """Whether train.build on --device cuda resolves the agent to `kernel`
    with no stderr line about its coverage."""
    return _cuda_rollout_route(argv, kernel) == (True, 0)


@pytest.mark.parametrize("argv", [["--use-mesh"], ["--learner", "shardmap"],
                                  ["--agent", "naf", "--naf.dtype",
                                   "bfloat16"],
                                  ["--agent", "naf", "--naf.sample", "block"],
                                  ["--obs-mode", "pixels", "--num-envs", "8",
                                   "--render-dtype", "bfloat16"]])
def test_train_cli_rejects_unported(argv):
    with contextlib.redirect_stderr(io.StringIO()):
        assert ttrain.main(["--device", "cpu", *argv]) == 2


def test_train_cli_cuda_without_gpu_is_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with contextlib.redirect_stderr(io.StringIO()):
        assert ttrain.main(["--num-envs", "8"]) == 2


def test_episode_stats_match_jax():
    from cartpoleplusplus_tpu.agents import common as jcommon
    from cartpoleplusplus_tpu_torch.agents import common as tcommon

    done = np.random.RandomState(3).uniform(size=(60, 32)) < 0.08
    jh = jcommon.episode_length_hist(jnp.asarray(done), 40)
    th = tcommon.episode_length_hist(torch.from_numpy(done), 40)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    js = jcommon.episode_stats_from_hist(jh)
    ts = tcommon.episode_stats_from_hist(th)
    assert set(js) == set(ts)
    for key in js:
        np.testing.assert_allclose(float(ts[key]), float(js[key]),
                                   rtol=1e-6, err_msg=key)
    empty = tcommon.episode_stats_from_hist(torch.zeros(41, dtype=torch.int64))
    assert float(empty["mean_episode_length"]) == 0.0


def test_sigma_schedule_matches_jax():
    cfg = dict(ou_sigma_decay_env_steps=1000)
    jagent = JDDPG(JCartPole3D(jparams.continuous_params(), num_envs=8),
                   JDDPGConfig(learner="xla", **cfg))
    agent = DDPG(CartPole3D(continuous_params(), num_envs=8),
                 DDPGConfig(**cfg))
    for steps in (0, 8, 333, 999, 1000, 5000):
        assert agent._sigma(steps) == float(jagent._sigma(jnp.int32(steps)))


def test_replay_column_draws():
    """The port's own column draws: slots stay behind the cursor with a
    valid successor, offsets inside the concatenated columns, and the
    batch rows are whole transitions of the drawn slots."""
    from cartpoleplusplus_tpu_torch.agents import ReplayBuffer

    rb = ReplayBuffer(num_envs=16, capacity_per_env=32, obs_dim=3,
                      action_dim=2)
    rs = rb.init()
    for i in range(5):  # 5 chunks of 4: cursor 20, filled 20
        obs = torch.full((4, 16, 3), float(i))
        obs += torch.arange(4.0)[:, None, None] / 10.0
        rs = rb.add_trajectory(rs, obs, torch.zeros((4, 16, 2)),
                               torch.arange(16.0).expand(4, 16),
                               torch.zeros((4, 16), dtype=torch.bool))
    g = torch.Generator().manual_seed(0)
    slots, offs = rb.draw_columns(rs, 200, 24, g)
    assert slots.shape == (200, 2) and offs.shape == (200,)
    assert int(slots.min()) >= 0 and int(slots.max()) <= rs.cursor - 2
    assert int(offs.min()) >= 0 and int(offs.max()) < 32
    assert len(set(slots.reshape(-1).tolist())) == rs.filled - 1
    obs, act, rew, nobs, done = rb.presample_columns(
        rs, 24, 3, indices=(slots[:3], offs[:3]))
    assert obs.shape == (3, 24, 3) and rew.shape == (3, 24)
    # successor obs is one slot later in the ring (0.1 apart in a chunk)
    step = (nobs - obs)[..., 0]
    assert bool(((step - 0.1).abs() < 1e-5).logical_or(
        (step - 0.7).abs() < 1e-5).all())
    # rows of one update wrap around the concatenated env columns in order
    envs = rew[0].long()
    assert bool((((envs[1:] - envs[:-1]) % 16) == 1).all())
