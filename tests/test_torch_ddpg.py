"""The port's DDPG (networks, one train step, the CLI) against the JAX
reference on the CPU."""

import contextlib
import functools
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
from cartpoleplusplus_tpu_torch.ckpt.checkpoint import to_tree
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


def _block_indices(jagent, st, num_updates, filled, cursor):
    """The (slots, offs) the reference's presample_block draws for the
    next learning step: per update one valid slot and the first env of an
    aligned block of batch_size envs."""
    rb, bs = jagent.replay, jagent.cfg.batch_size
    n_valid = max(filled - 1, 1)
    _, k = jax.random.split(st.rng)
    slots, offs = [], []
    for key in jax.random.split(k, num_updates):
        k_slot, k_env = jax.random.split(key)
        age = int(jax.random.randint(k_slot, (), 1, n_valid + 1))
        slots.append((cursor - 1 - age) % rb.capacity)
        offs.append(bs * int(jax.random.randint(k_env, (), 0,
                                                rb.num_envs // bs)))
    return np.asarray(slots), np.asarray(offs)


# The reference's draws of each sampling mode, as the port's `indices`.
DRAWS = {"column": _column_indices, "uniform": _uniform_indices,
         "block": _block_indices}


def test_train_step_matches_jax_xla_learner():
    """One train_step(fused=False) from a converted JAX DDPG(learner='xla')
    state, with the reference's replay draws injected: losses and every
    updated network within rtol 1e-4, atol 1e-6."""
    b, t, k = 64, 4, 2
    kw = dict(hidden=HIDDEN, warmup_env_steps=0, updates_per_step=k,
              batch_size=32, rollout_steps=t, replay_capacity_per_env=16)
    jagent = JDDPG(JCartPole3D(jparams.continuous_params(), num_envs=b),
                   JDDPGConfig(learner="xla", **kw))
    agent = DDPG(CartPole3D(continuous_params(), num_envs=b, device="cpu"),
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


# The teacher-forced run: 64 envs, rollout 8, a ring of 32 slots per env
# (it wraps every 4 train steps), OU sigma at its floor from env-step 64
# (train step 8), batch 32 = one trimmed ring column of the 64 envs.
TF_ENVS, TF_STEPS = 64, 16
TF_KW = dict(hidden=HIDDEN, rollout_steps=8, updates_per_step=4,
             batch_size=32, replay_capacity_per_env=32,
             ou_sigma_decay_env_steps=64)
TF_RTOL, TF_ATOL = 2e-4, 1e-5


@functools.lru_cache(maxsize=None)
def _jax_ddpg(num_envs, kw_items):
    """A reference DDPG(learner='xla') and its jitted train_step, shared
    by the cases of one config."""
    jagent = JDDPG(JCartPole3D(jparams.continuous_params(),
                               num_envs=num_envs),
                   JDDPGConfig(learner="xla", **dict(kw_items)))
    return jagent, jax.jit(jagent.train_step)


def _assert_trees_close(got, want, path=""):
    """Two `to_tree` dicts: float tensors within TF_RTOL / TF_ATOL, every
    integer, bool and count exact."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for a, b in zip(got, want):
            _assert_trees_close(a, b, path)
    elif isinstance(want, torch.Tensor) and want.is_floating_point():
        torch.testing.assert_close(got, want, rtol=TF_RTOL, atol=TF_ATOL,
                                   msg=lambda m: f"{path}: {m}")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want), path
    else:
        assert got == want, path


def ddpg_teacher_forced(num_envs, kw, steps, learner, seed=0):
    """Each of `steps` train steps from the reference's state: the
    reference's state converted, one port train_step with the reference's
    replay draws, and the port's next state held to the reference's next
    state (every network, target, Adam moment and count, the OU noise,
    the obs, the env state and the ring with its cursor and fill), the
    losses too. Returns the port's critic loss of each step."""
    jagent, jstep = _jax_ddpg(num_envs, tuple(sorted(kw.items())))
    agent = DDPG(CartPole3D(continuous_params(), num_envs=num_envs,
                            device="cpu"),
                 DDPGConfig(learner=learner, **kw))
    c, cap = jagent.cfg, jagent.replay.capacity
    jst, losses = jagent.init(seed), []
    for _ in range(steps):
        host = jax.device_get(jst)
        filled = min(int(host.replay.filled) + c.rollout_steps, cap)
        cursor = (int(host.replay.cursor) + c.rollout_steps) % cap
        indices = DRAWS[c.sample](jagent, jst, c.updates_per_step, filled,
                                  cursor)
        pst, m = agent.train_step(ddpg_state_from_jax(agent, host),
                                  indices=indices)
        jst, jm = jstep(jst)
        want = ddpg_state_from_jax(agent, jax.device_get(jst))
        try:
            _assert_trees_close(
                {k: v for k, v in to_tree(pst).items() if k != "rng"},
                {k: v for k, v in to_tree(want).items() if k != "rng"})
            for key in ("critic_loss", "actor_loss", "reward_mean",
                        "done_frac"):
                np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                           rtol=TF_RTOL, atol=TF_ATOL,
                                           err_msg=key)
        except AssertionError as e:
            raise AssertionError(f"train step {len(losses) + 1}: {e}") from e
        losses.append(float(m["critic_loss"]))
    return losses


@pytest.mark.parametrize("warmup", [0, 16], ids=["warmup0", "warmup16"])
@pytest.mark.parametrize("learner", ["xla", "kernel"],
                         ids=["plain", "b3_twin"])
def test_train_steps_track_jax_teacher_forced(learner, warmup):
    """16 train steps, each from the reference's state with its replay
    draws injected: the ring wraps (4 times), sigma reaches its floor
    (step 8), and with warmup 16 the first step only rolls out. Every
    field stays within rtol 2e-4 / atol 1e-5 of the reference's after
    every step; cursor, fill, counts, steps, episodes and dones exact."""
    kw = dict(TF_KW, warmup_env_steps=warmup)
    losses = ddpg_teacher_forced(TF_ENVS, kw, TF_STEPS, learner)
    gated = max(warmup // TF_KW["rollout_steps"] - 1, 0)  # before the gate
    assert losses[:gated] == [0.0] * gated
    assert all(loss > 0.0 for loss in losses[gated:])


@pytest.mark.parametrize("learner", ["xla", "kernel"],
                         ids=["plain", "b3_twin"])
def test_uniform_train_steps_track_jax_teacher_forced(learner):
    """The teacher-forced run of test_train_steps_track_jax_teacher_forced
    under uniform sampling (per row an env and a slot, drawn by the
    reference and injected), warmup 16, 8 train steps (the ring wraps
    twice): every field within rtol 2e-4 / atol 1e-5 of the reference's
    after every step, on the plain learner and on B3's twin."""
    kw = dict(TF_KW, warmup_env_steps=16, sample="uniform")
    losses = ddpg_teacher_forced(TF_ENVS, kw, 8, learner)
    assert losses[0] == 0.0 and all(loss > 0.0 for loss in losses[1:])


def test_unported_learner_settings_raise():
    """The learner setting the port does not take (a dot-algorithm preset
    the JAX package refuses too, as learner_precision) raises at
    construction, and so does
    learner='kernel' where B3 does not cover the config. learner_precision
    "bfloat16", ported since, constructs on B3; bfloat16 nets, ported
    since, construct on the plain learner ("auto" and "xla") and raise
    with "kernel", as the reference's kernel_learner_ok refuses them;
    uniform sampling, ported since, constructs on both learners."""
    env = CartPole3D(continuous_params(), num_envs=8, device="cpu")
    agent = DDPG(env, DDPGConfig(learner_precision="bfloat16",
                                 learner="kernel"))
    assert agent.kernel_mode and agent.cfg.learner_precision == "bfloat16"
    with pytest.raises(ValueError, match="not ported"):
        DDPG(env, DDPGConfig(learner_precision="BF16_BF16_F32_X9"))
    for learner in ("auto", "xla"):
        agent = DDPG(env, DDPGConfig(dtype="bfloat16", learner=learner))
        assert not agent.kernel_mode and not agent.kernel_learner_ok()
        assert agent.fusable()  # B2 still covers it: float32 weights
    with pytest.raises(ValueError, match="not covered by the fused update"):
        DDPG(env, DDPGConfig(dtype="bfloat16", learner="kernel"))
    for learner in ("xla", "kernel"):
        agent = DDPG(env, DDPGConfig(sample="uniform", learner=learner))
        assert agent.kernel_mode == (learner == "kernel")
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


# Flags that shrink a CLI run on the CPU to a few small train steps.
SMALL_RUN = ["--num-envs", "8", "--total-env-steps", "16",
             "--log-interval", "1"]
SMALL_PIXELS = ["--obs-mode", "pixels", "--render-size", "16",
                "--render-grayscale", "--render-obs-uint8"]


def cli_rc(argv) -> int:
    """train.main on the CPU, its output swallowed: the exit code."""
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return ttrain.main(["--device", "cpu", *argv])


@pytest.mark.parametrize("argv", [["--use-mesh", "--ddpg.hidden", "8",
                                   "--ddpg.replay-capacity-per-env", "8",
                                   *SMALL_RUN],
                                  ["--learner", "shardmap", "--ddpg.hidden",
                                   "8", "--ddpg.replay-capacity-per-env", "8",
                                   *SMALL_RUN],
                                  ["--agent", "naf", "--naf.dtype",
                                   "bfloat16", "--naf.hidden", "8",
                                   "--naf.batch-size", "8",
                                   "--naf.replay-capacity-per-env", "8",
                                   *SMALL_RUN],
                                  ["--agent", "naf", "--naf.sample", "block",
                                   "--naf.hidden", "8", "--naf.batch-size",
                                   "8", *SMALL_RUN],
                                  [*SMALL_PIXELS, "--render-dtype",
                                   "bfloat16", "--ddpg.hidden", "8",
                                   "--ddpg.replay-capacity-per-env", "8",
                                   *SMALL_RUN]])
def test_train_cli_rejects_unported(argv):
    """The flags the port lacks exit 2. `--naf.sample block`,
    `--render-dtype bfloat16`, `--use-mesh`, `--learner shardmap` and
    `--naf.dtype bfloat16`, rejected until they were ported, now train on
    the CPU and exit 0."""
    ported = any(f in argv for f in ("--naf.sample", "--render-dtype",
                                     "--use-mesh", "--learner",
                                     "--naf.dtype"))
    assert cli_rc(argv) == (0 if ported else 2)


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
    agent = DDPG(CartPole3D(continuous_params(), num_envs=8, device="cpu"),
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
