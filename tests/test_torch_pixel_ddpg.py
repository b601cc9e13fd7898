"""The pixel DDPG slice as a whole — the env rendering uint8 frame-diff
frames, the quantized ring with the late insert and block sampling, and
the plain learner through VisualActor / VisualCritic — against the JAX
reference's train_step on the CPU, and the pixel CLI."""

import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu import CartPole3D as JCartPole3D
from cartpoleplusplus_tpu.agents import DDPG as JDDPG
from cartpoleplusplus_tpu.agents import DDPGConfig as JDDPGConfig
from cartpoleplusplus_tpu.env import pixels as jpx
from cartpoleplusplus_tpu.physics import params as jparams
from cartpoleplusplus_tpu_torch import CartPole3D
from cartpoleplusplus_tpu_torch import train as ttrain
from cartpoleplusplus_tpu_torch.agents import DDPG, DDPGConfig
from cartpoleplusplus_tpu_torch.env import pixels as tpx
from cartpoleplusplus_tpu_torch.models.from_jax import (
    ddpg_state_from_jax, visual_actor_state_dict, visual_critic_state_dict)
from cartpoleplusplus_tpu_torch.physics.params import continuous_params

B = 16
CFG = dict(hidden=(32, 32), batch_size=16, replay_capacity_per_env=16,
           rollout_steps=2, updates_per_step=2, warmup_env_steps=2,
           sample="block")
RENDER = dict(width=16, height=16, grayscale=True, obs_uint8=True,
              frame_diff=True, frame_diff_gain=4.0)
# The reference's jit-compiled renderer rounds near-silhouette pixels
# otherwise than the op-by-op twin (test_torch_render.py): a pixel that
# flips between pole and background moves a gain-4 frame-diff plane by tens
# of uint8 levels. Such pixels are rare (RING_OFF_SHARE of the ring; every
# other element within one level), and they and the reference's other
# convolution sums move the losses by RTOL / ATOL.
RTOL, ATOL = 2e-3, 2e-5
RING_OFF_SHARE = 1e-3
# Parameters after the 6 Adam updates: where a gradient element sits near
# zero, Adam's m / sqrt(v) turns a rounding difference into a step of up to
# lr per update. So all but 0.5% of each network's elements within RTOL /
# ATOL, and each network's largest error at most MOVE_SHARE of the largest
# step the reference took from the initial network (an unchanged network
# sits at 1; the sound runs at 0.19 to 0.32, the targets' steps below ATOL
# included).
PARAM_OFF_SHARE = 5e-3
MOVE_SHARE = 0.5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(2)


def _agents(**over):
    kw = {**CFG, **over}
    jenv = JCartPole3D(jparams.continuous_params(), num_envs=B,
                       obs_mode="pixels",
                       render_config=jpx.RenderConfig(**RENDER))
    env = CartPole3D(continuous_params(), num_envs=B, obs_mode="pixels",
                     render_config=tpx.RenderConfig(**RENDER), device="cpu")
    return (JDDPG(jenv, JDDPGConfig(learner="xla", **kw)),
            DDPG(env, DDPGConfig(learner="xla", **kw)))


def _block_indices(jagent, st):
    """The (slots, offs) the reference's presample_block draws in the next
    train step: its update phase splits st.rng, then one key per update,
    and reads the ring before this step's (late) insert."""
    rb, c = jagent.replay, jagent.cfg
    n_valid = max(int(st.replay.filled) - 1, 1)
    _, k = jax.random.split(st.rng)
    slots, offs = [], []
    for key in jax.random.split(k, c.updates_per_step):
        k_slot, k_env = jax.random.split(key)
        age = int(jax.random.randint(k_slot, (), 1, n_valid + 1))
        slots.append((int(st.replay.cursor) - 1 - age) % rb.capacity)
        offs.append(c.batch_size * int(jax.random.randint(
            k_env, (), 0, rb.num_envs // c.batch_size)))
    return slots, offs


def _compare_nets(pst, jst, jst0, hidden):
    """All four networks against the reference's (jst), which started from
    jst0: the share of elements off RTOL / ATOL, and the largest error
    against the largest step the reference took."""
    jst, jst0 = jax.device_get(jst), jax.device_get(jst0)
    for name, sd_fn in (("actor", visual_actor_state_dict),
                        ("critic", visual_critic_state_dict),
                        ("actor_target", visual_actor_state_dict),
                        ("critic_target", visual_critic_state_dict)):
        want = sd_fn(getattr(jst, name), hidden)
        start = sd_fn(getattr(jst0, name), hidden)
        got = getattr(pst, name).state_dict()
        off = n = 0
        err = moved = 0.0
        for pname, p in got.items():
            a, b = p.numpy(), want[pname].numpy()
            err = max(err, float(np.abs(a - b).max()))
            moved = max(moved, float(np.abs(b - start[pname].numpy()).max()))
            off += int((np.abs(a - b) > ATOL + RTOL * np.abs(b)).sum())
            n += a.size
        assert off <= PARAM_OFF_SHARE * n, (name, off, n)
        assert err <= MOVE_SHARE * moved, (name, err, moved)


@pytest.mark.parametrize("cadence", ["per_update", "per_step"])
def test_pixel_train_steps_match_jax(cadence):
    """3 pixel-DDPG train steps from the reference's init state, with its
    block draws injected: losses, reward and done fraction within RTOL /
    ATOL, all four networks as _compare_nets bounds them, the uint8 ring
    within one level but for RING_OFF_SHARE of it, and the
    late insert's cursor. per_step runs the frozen-target learner, which
    flattens frame-shaped next observations."""
    jagent, agent = _agents(polyak_cadence=cadence)
    jst0 = jst = jagent.init(0)
    pst = ddpg_state_from_jax(agent, jax.device_get(jst))
    assert pst.obs.dtype == torch.uint8 and pst.replay.obs.dtype == torch.uint8
    jstep = jax.jit(jagent.train_step)
    for _ in range(3):
        indices = _block_indices(jagent, jst)
        jst, jm = jstep(jst)
        pst, m = agent.train_step(pst, indices=indices)
        for key in ("critic_loss", "actor_loss", "reward_mean", "done_frac"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=RTOL, atol=ATOL, err_msg=key)
        assert m["rollout_impl"] == 0.0 and m["learner_impl"] == 0.0
        assert pst.replay.cursor == int(jst.replay.cursor)
        assert pst.replay.filled == int(jst.replay.filled)
    assert float(jm["critic_loss"]) > 0.0
    _compare_nets(pst, jst, jst0, agent.cfg.hidden)
    ring = np.abs(pst.replay.obs.numpy().astype(np.int32)
                  - np.asarray(jst.replay.obs).astype(np.int32))
    assert (ring > 1).mean() <= RING_OFF_SHARE, (ring > 1).sum()


def test_late_insert_samples_the_pre_insert_ring():
    """On a quantized ring the first learning step's minibatches come from
    the ring as it was before this step's rollout: empty at the first
    train step, so every sampled frame is zero."""
    _, agent = _agents()
    st = agent.init(0)
    seen = []
    draw = agent.replay.presample_block

    def spy(rs, *a, **kw):
        seen.append((rs.filled, rs.cursor))
        return draw(rs, *a, **kw)

    agent.replay.presample_block = spy
    st, m = agent.train_step(st)
    assert seen == [(0, 0)] and st.replay.filled == CFG["rollout_steps"]
    assert float(m["critic_loss"]) >= 0.0


def test_block_sampling_needs_the_batch_to_divide_the_envs():
    with pytest.raises(ValueError, match="divide num_envs"):
        _agents(batch_size=12)


def test_pixel_cli_cpu():
    """The pixel CLI on the CPU at 16 envs, 16 x 16 gray uint8 frame-diff
    frames, block sampling: rc 0, finite metrics, an eval line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ttrain.main([
            "--device", "cpu", "--obs-mode", "pixels", "--num-envs", "16",
            "--render-size", "16", "--render-grayscale",
            "--render-obs-uint8", "--render-frame-diff",
            "--render-frame-diff-gain", "4", "--ddpg.hidden", "32", "32",
            "--ddpg.batch-size", "16", "--ddpg.sample", "block",
            "--ddpg.replay-capacity-per-env", "16", "--total-env-steps", "32",
            "--final-eval", "--eval-steps", "30"])
    assert rc == 0
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert lines[-2]["train_step"] == 4 and lines[-2]["critic_loss"] > 0.0
    for x in lines:
        assert all(np.isfinite(v) for v in x.values()), x
    assert lines[-2]["rollout_impl"] == 0.0
    assert 0 < lines[-1]["eval_mean_episode_length"] <= 30


def test_pixel_cli_rejects_other_render_dtypes_and_agents():
    """bfloat16 rendering and the other agents' pixel nets, rejected until
    they were ported: each argv now trains one step on the CPU (16 envs,
    16 x 16 gray uint8 frame-diff frames) and exits 0, with finite
    metrics and the plain rollout and learner."""
    small = {"dqn": ["--dqn.hidden", "16", "--dqn.batch-size", "16",
                     "--dqn.replay-capacity-per-env", "16"],
             "naf": ["--naf.hidden", "16", "--naf.batch-size", "16",
                     "--naf.replay-capacity-per-env", "16"],
             "lrpg": ["--lrpg.hidden", "16", "--lrpg.rollout-steps", "8"],
             "ddpg": ["--ddpg.hidden", "16", "16", "--ddpg.batch-size", "16",
                      "--ddpg.replay-capacity-per-env", "16"]}
    for argv in (["--render-dtype", "bfloat16"], ["--agent", "dqn"],
                 ["--agent", "naf"], ["--agent", "lrpg"]):
        agent = argv[1] if argv[0] == "--agent" else "ddpg"
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            assert ttrain.main([
                "--device", "cpu", "--obs-mode", "pixels", "--num-envs",
                "16", "--render-size", "16", "--render-grayscale",
                "--render-obs-uint8", "--render-frame-diff",
                "--total-env-steps", "8", *small[agent], *argv]) == 0
        (m,) = [json.loads(x) for x in out.getvalue().splitlines()]
        assert m["train_step"] == 1, argv
        assert all(np.isfinite(v) for v in m.values()), m
        assert m["rollout_impl"] == 0.0 and m["learner_impl"] == 0.0
