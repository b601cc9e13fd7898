"""Pixel DQN, NAF and LRPG — VisualQNet, VisualNafNet and VisualPolicy, the
quantized ring with the late insert and block sampling, the plain learners
through the conv encoder, the on-policy window of uint8 frames — against
the JAX reference on the CPU, and their CLI runs, checkpoints and
`--eval-only`."""

import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu import CartPole3D as JCartPole3D
from cartpoleplusplus_tpu.agents import DQN as JDQN
from cartpoleplusplus_tpu.agents import LRPG as JLRPG
from cartpoleplusplus_tpu.agents import NAF as JNAF
from cartpoleplusplus_tpu.agents import DQNConfig as JDQNConfig
from cartpoleplusplus_tpu.agents import LRPGConfig as JLRPGConfig
from cartpoleplusplus_tpu.agents import NAFConfig as JNAFConfig
from cartpoleplusplus_tpu.env import pixels as jpx
from cartpoleplusplus_tpu.models import VisualNafNet as JVisualNafNet
from cartpoleplusplus_tpu.models import VisualPolicy as JVisualPolicy
from cartpoleplusplus_tpu.models import VisualQNet as JVisualQNet
from cartpoleplusplus_tpu.physics import params as jparams
from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams
from cartpoleplusplus_tpu_torch import train as ttrain
from cartpoleplusplus_tpu_torch.agents import (DQN, LRPG, NAF, DQNConfig,
                                               LRPGConfig, NAFConfig)
from cartpoleplusplus_tpu_torch.env import pixels as tpx
from cartpoleplusplus_tpu_torch.models import (VisualNafNet, VisualPolicy,
                                               VisualQNet)
from cartpoleplusplus_tpu_torch.models.from_jax import (
    dqn_state_from_jax, lrpg_state_from_jax, naf_state_from_jax,
    visual_naf_state_dict, visual_policy_state_dict, visual_qnet_state_dict)
from cartpoleplusplus_tpu_torch.physics.params import continuous_params
from test_torch_pixel_ddpg import (ATOL, MOVE_SHARE, PARAM_OFF_SHARE,
                                   RING_OFF_SHARE, RTOL, _block_indices)

B = 16
HIDDEN = (32, 32)
RENDER = dict(width=16, height=16, grayscale=True, obs_uint8=True,
              frame_diff=True, frame_diff_gain=4.0)
REPLAY = dict(hidden=HIDDEN, batch_size=16, replay_capacity_per_env=16,
              rollout_steps=2, updates_per_step=2, warmup_env_steps=2,
              sample="block")
# (reference agent, reference config, port agent, port config, continuous
# env, config fields, bridge, state-dict bridge, [(port field, reference
# field)] of the networks, metric keys).
AGENTS = {
    "dqn": (JDQN, JDQNConfig, DQN, DQNConfig, False,
            dict(REPLAY, double_dqn=True, learner="xla"), dqn_state_from_jax,
            visual_qnet_state_dict, [("q", "q"), ("q_target", "q_target")],
            ("loss", "epsilon", "reward_mean", "done_frac")),
    "naf": (JNAF, JNAFConfig, NAF, NAFConfig, True,
            dict(REPLAY, learner="xla", lr_decay_env_steps=64),
            naf_state_from_jax, visual_naf_state_dict,
            [("net", "params"), ("target", "target")],
            ("loss", "reward_mean", "done_frac")),
    "lrpg": (JLRPG, JLRPGConfig, LRPG, LRPGConfig, False,
             dict(hidden=HIDDEN, rollout_steps=4, learner="xla"),
             lrpg_state_from_jax, visual_policy_state_dict,
             [("policy", "params")],
             ("loss", "return_mean", "reward_mean", "done_frac")),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(2)


def _agents(name, **over):
    jcls, jcfg, cls, cfg, continuous, kw, *_ = AGENTS[name]
    kw = {**kw, **over}
    jenv = JCartPole3D(jparams.continuous_params() if continuous
                       else jparams.CartPoleParams(), num_envs=B,
                       obs_mode="pixels",
                       render_config=jpx.RenderConfig(**RENDER))
    env = CartPole3D(continuous_params() if continuous else CartPoleParams(),
                     num_envs=B, obs_mode="pixels",
                     render_config=tpx.RenderConfig(**RENDER), device="cpu")
    return jcls(jenv, jcfg(**kw)), cls(env, cfg(**kw))


def _frames(shape, seed):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


@pytest.mark.parametrize("encoder", ["conv", "patch"])
@pytest.mark.parametrize("net", ["qnet", "naf", "policy"])
def test_visual_nets_match_flax(net, encoder):
    """VisualQNet, VisualNafNet and VisualPolicy from the flax nets'
    parameters, on the same uint8 frames (24 x 24, so the patch encoder's
    6-pixel patches tile them): every output within rtol 1e-5 / atol
    1e-6; VisualNafNet gives (v, mu) without an action and (q, mu, v)
    with one."""
    shape = (24, 24, 6)
    img = _frames((5,) + shape, seed=len(net) + len(encoder))
    act = np.random.RandomState(3).uniform(-1, 1, (5, 2)).astype(np.float32)
    jcls, cls, to_sd, n_out = {
        "qnet": (JVisualQNet, VisualQNet, visual_qnet_state_dict, 5),
        "naf": (JVisualNafNet, VisualNafNet, visual_naf_state_dict, 2),
        "policy": (JVisualPolicy, VisualPolicy, visual_policy_state_dict,
                   5)}[net]
    jnet = jcls(hidden=HIDDEN, encoder=encoder)
    init_args = (img[:1].astype(np.float32),) + (
        (act[:1],) if net == "naf" else ())
    params = jax.device_get(jnet.init(jax.random.PRNGKey(1), *init_args))
    tnet = cls(shape, n_out, HIDDEN, encoder=encoder)
    tnet.load_state_dict(to_sd(params, HIDDEN))
    calls = [(img,), (img, act)] if net == "naf" else [(img,)]
    for args in calls:
        want = jnet.apply(params, *args)
        with torch.no_grad():
            got = tnet(*(torch.from_numpy(a) for a in args))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want) == (len(args) + 1 if net == "naf"
                                         else 1)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6)


def _compare_nets(name, pst, jst, jst0):
    """Every network against the reference's (jst, which started from
    jst0): the share of elements off RTOL / ATOL, and the largest error
    against the largest step the reference took (test_torch_pixel_ddpg's
    bars)."""
    *_, to_sd, nets, _ = AGENTS[name]
    for pname, jname in nets:
        want = to_sd(getattr(jst, jname), HIDDEN)
        start = to_sd(getattr(jst0, jname), HIDDEN)
        off = n = 0
        err = moved = 0.0
        for key, p in getattr(pst, pname).state_dict().items():
            a, b = p.numpy(), want[key].numpy()
            err = max(err, float(np.abs(a - b).max()))
            moved = max(moved, float(np.abs(b - start[key].numpy()).max()))
            off += int((np.abs(a - b) > ATOL + RTOL * np.abs(b)).sum())
            n += a.size
        assert off <= PARAM_OFF_SHARE * n, (pname, off, n)
        assert err <= MOVE_SHARE * moved, (pname, err, moved)


def _levels_off(got, want):
    """The share of uint8 elements more than one level apart."""
    d = np.abs(got.numpy().astype(np.int32) - np.asarray(want).astype(
        np.int32))
    return float((d > 1).mean())


@pytest.mark.parametrize("name", ["dqn", "naf"])
def test_pixel_train_steps_match_jax(name):
    """3 pixel train steps from the reference's init state through the
    bridges (DQN with double DQN, NAF with its clip and lr schedule), the
    reference's block draws injected: the metrics within RTOL / ATOL,
    every network as _compare_nets bounds it, the uint8 ring and the
    current frames within one level but for RING_OFF_SHARE of them, the
    late insert's cursor and fill exact, and no kernel on the path."""
    jagent, agent = _agents(name)
    assert not agent.kernel_mode and not agent.kernel_rollout
    *_, bridge, _, _, keys = AGENTS[name]
    jst0 = jst = jagent.init(0)
    pst = bridge(agent, jax.device_get(jst))
    assert pst.obs.dtype == pst.replay.obs.dtype == torch.uint8
    jstep = jax.jit(jagent.train_step)
    for _ in range(3):
        indices = _block_indices(jagent, jst)
        jst, jm = jstep(jst)
        pst, m = agent.train_step(pst, indices=indices)
        for key in keys:
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=RTOL, atol=ATOL, err_msg=key)
        assert m["rollout_impl"] == 0.0 and m["learner_impl"] == 0.0
        assert pst.replay.cursor == int(jst.replay.cursor)
        assert pst.replay.filled == int(jst.replay.filled)
        assert pst.env_steps == int(jst.env_steps)
    assert float(jm["loss"]) > 0.0
    _compare_nets(name, pst, jst, jst0)
    assert _levels_off(pst.obs, jst.obs) <= RING_OFF_SHARE
    assert _levels_off(pst.replay.obs, jst.replay.obs) <= RING_OFF_SHARE


def test_pixel_lrpg_train_steps_match_jax():
    """3 pixel-LRPG train steps, each from the reference's state through
    the bridge (the window of 64 uint8 frames, one plain Adam step): the
    metrics and the return baseline within RTOL / ATOL, the current frames
    within one level but for RING_OFF_SHARE of them, and the policy within
    RTOL / ATOL but for PARAM_OFF_SHARE of its elements, each of which is
    the reference's Adam step taken with the other sign. LRPG takes one
    Adam step per train step, and at Adam counts 1-3 a step moves nearly
    every element by about lr whatever its gradient's size: an element
    whose gradient cancels to rounding level (convolution sums in another
    order) flips its step and lands about 2 lr away. Run free for 3 steps,
    0.58 % of the elements part so (PARAM_OFF_SHARE is 0.5 %), and the
    largest error is 0.76 of the reference's largest move (MOVE_SHARE is
    0.5): what _compare_nets bounds for DQN and NAF, whose K updates per
    step move the nets further, does not separate a flip from a fault
    here, so each step restarts from the reference's state and each
    parted element must be a flipped step."""
    jagent, agent = _agents("lrpg")
    assert not agent.kernel_mode and not agent.kernel_rollout
    jstep = jax.jit(jagent.train_step)
    jst = jagent.init(0)
    for _ in range(3):
        host = jax.device_get(jst)
        pst, m = agent.train_step(lrpg_state_from_jax(agent, host))
        jst, jm = jstep(jst)
        for key in AGENTS["lrpg"][-1]:
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=RTOL, atol=ATOL, err_msg=key)
        assert m["rollout_impl"] == 0.0 and m["learner_impl"] == 0.0
        assert pst.obs.dtype == torch.uint8
        assert _levels_off(pst.obs, jst.obs) <= RING_OFF_SHARE
        np.testing.assert_allclose(float(pst.baseline), float(jst.baseline),
                                   rtol=RTOL, atol=ATOL)
        want = visual_policy_state_dict(jax.device_get(jst.params), HIDDEN)
        start = visual_policy_state_dict(host.params, HIDDEN)
        off = n = 0
        for key, p in pst.policy.state_dict().items():
            a, b, s0 = p.numpy(), want[key].numpy(), start[key].numpy()
            bad = np.abs(a - b) > ATOL + RTOL * np.abs(b)
            assert (np.sign(a - s0)[bad] == -np.sign(b - s0)[bad]).all(), key
            off += int(bad.sum())
            n += a.size
        assert off <= PARAM_OFF_SHARE * n, (off, n)
    assert float(jm["loss"]) != 0.0


@pytest.mark.parametrize("name", ["dqn", "naf"])
def test_late_insert_samples_the_pre_insert_ring(name):
    """On the quantized ring the first learning step's block minibatches
    come from the ring as it was before this step's rollout: empty at the
    first train step."""
    _, agent = _agents(name)
    st = agent.init(0)
    seen = []
    draw = agent.replay.presample_block

    def spy(rs, *a, **kw):
        seen.append((rs.filled, rs.cursor))
        return draw(rs, *a, **kw)

    agent.replay.presample_block = spy
    st, m = agent.train_step(st)
    assert seen == [(0, 0)] and st.replay.filled == REPLAY["rollout_steps"]
    assert st.replay.obs.dtype == torch.uint8
    assert float(m["loss"]) >= 0.0


@pytest.mark.parametrize("name", ["dqn", "naf"])
def test_block_sampling_needs_the_batch_to_divide_the_envs(name):
    with pytest.raises(ValueError, match="divide num_envs"):
        _agents(name, batch_size=12)


def _cli(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = ttrain.main(argv)
    return rc, [json.loads(x) for x in out.getvalue().splitlines()], \
        err.getvalue()


PIXEL_ARGV = ["--device", "cpu", "--obs-mode", "pixels", "--num-envs", "16",
              "--render-size", "16", "--render-grayscale",
              "--render-obs-uint8", "--render-frame-diff",
              "--render-frame-diff-gain", "4"]
AGENT_ARGV = {
    "dqn": ["--dqn.hidden", "32", "32", "--dqn.batch-size", "16",
            "--dqn.sample", "block", "--dqn.replay-capacity-per-env", "16"],
    "naf": ["--naf.hidden", "32", "32", "--naf.batch-size", "16",
            "--naf.sample", "block", "--naf.replay-capacity-per-env", "16"],
    "lrpg": ["--lrpg.hidden", "16", "16", "--lrpg.rollout-steps", "8"],
}


@pytest.mark.parametrize("name", ["dqn", "naf", "lrpg"])
def test_pixel_cli_trains_saves_and_evaluates(tmp_path, name):
    """`train --obs-mode pixels --agent dqn|naf|lrpg` on the CPU for 4
    train steps with weights-only checkpoints and a final eval: rc 0,
    finite metrics, the plain rollout and learner, a loss past the warmup;
    then `--eval-only` from those weights prints the same eval line."""
    ck = str(tmp_path / "ck")
    argv = PIXEL_ARGV + ["--agent", name, *AGENT_ARGV[name],
                         "--ckpt-dir", ck, "--no-ckpt-full",
                         "--eval-steps", "30", "--log-interval", "1"]
    total = ["--total-env-steps", "32"]
    rc, lines, _ = _cli(argv + total + ["--final-eval"])
    assert rc == 0
    steps, ev = lines[:-1], lines[-1]
    assert [m["train_step"] for m in steps] == [1, 2, 3, 4]
    for x in lines:
        assert all(np.isfinite(v) for v in x.values()), x
    assert all(m["rollout_impl"] == 0.0 and m["learner_impl"] == 0.0
               for m in steps)
    assert steps[-1]["loss"] != 0.0
    assert 0 < ev["eval_mean_episode_length"] <= 30
    # --final-eval evaluates at seed + 1; --eval-only at the run's seed.
    rc, lines, err = _cli(argv + ["--eval-only", "--seed", "1"])
    assert rc == 0 and "resumed from step 3" in err
    assert lines == [{k[len("eval_"):]: v for k, v in ev.items()}]
