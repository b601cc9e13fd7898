"""The port's LRPG slice (the Gumbel draw, returns-to-go, kernel B8's plain
twin, whole train steps on both learners from a carried-over JAX state,
the CLI) and the random agent, against the JAX reference on the CPU."""

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
from cartpoleplusplus_tpu import CartPoleParams as JCartPoleParams
from cartpoleplusplus_tpu.agents import LRPG as JLRPG
from cartpoleplusplus_tpu.agents import LRPGConfig as JLRPGConfig
from cartpoleplusplus_tpu.agents.lrpg import returns_to_go as j_returns_to_go
from cartpoleplusplus_tpu.agents.random_agent import RandomAgent as JRandom
from cartpoleplusplus_tpu.models import PolicyMLP as JPolicyMLP
from cartpoleplusplus_tpu.ops.policy_rollout import (
    pg_policy_rollout as j_pg_policy_rollout,
)
from cartpoleplusplus_tpu.ops.policy_rollout import (
    reference_pg_rollout as j_reference_pg_rollout,
)
from cartpoleplusplus_tpu.utils import prng as jprng
from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams
from cartpoleplusplus_tpu_torch import train as ttrain
from cartpoleplusplus_tpu_torch.agents import LRPG, LRPGConfig, RandomAgent
from cartpoleplusplus_tpu_torch.agents.common import (TAG_PG_GUMBEL,
                                                      evaluate_policy)
from cartpoleplusplus_tpu_torch.agents.lrpg import returns_to_go
from cartpoleplusplus_tpu_torch.models import PolicyMLP
from cartpoleplusplus_tpu_torch.models.from_jax import (
    env_state_from_jax,
    lrpg_state_from_jax,
    policy_from_flax,
    policy_state_dict,
)
from cartpoleplusplus_tpu_torch.ops import pg_rollout as tpg
from cartpoleplusplus_tpu_torch.physics.params import continuous_params
from cartpoleplusplus_tpu_torch.utils import prng as tprng
from test_torch_ddpg import (_cuda_kernel_rollout, _cuda_plain_rollout,
                             _perturb)
from test_torch_q_rollout import _assert_rollouts_match, _port_inputs

F = 42


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# --- the Gumbel draw -----------------------------------------------------

def test_gumbel_matches_jax():
    """The uniform under gumbel(seed, t, 0x47, a) is JAX's bit for bit;
    g = -log(-log(u)) agrees within 4 ulp of max(|g|, 1). (Near g = 0 the
    outer log amplifies the inner log's last-bit difference between libm
    and XLA, about 1e-7 absolute, so ulps of g itself are no bar there.)"""
    rng = np.random.RandomState(3)
    seeds = rng.randint(0, 2**32, size=4096, dtype=np.uint64).astype(
        np.uint32)
    ts = rng.randint(0, 2**31, size=4096).astype(np.uint32)
    tw = [tprng.as_words(x.astype(np.int64)) for x in (seeds, ts)]
    jw = [jnp.asarray(x) for x in (seeds, ts)]
    assert TAG_PG_GUMBEL == tpg.TAG_PG_GUMBEL == 0x47
    for a in range(5):
        bits = tprng.hash_words(*tw, TAG_PG_GUMBEL, a, 0xB2)
        jbits = jprng.hash_words(*jw, np.uint32(0x47), np.uint32(a),
                                 np.uint32(0xB2))
        np.testing.assert_array_equal(bits.numpy(),
                                      np.asarray(jbits).astype(np.int64))
        u = tprng.uniform_from_bits(bits, lo=2.0 ** -24, hi=1.0).numpy()
        ju = np.asarray(jprng.uniform_from_bits(
            jbits, lo=np.float32(2.0 ** -24), hi=1.0))
        np.testing.assert_array_equal(u, ju)
        got = tprng.gumbel(*tw, TAG_PG_GUMBEL, a).numpy()
        want = np.asarray(jprng.gumbel(*jw, np.uint32(0x47), np.uint32(a)))
        assert got.dtype == np.float32 and np.isfinite(got).all()
        scale = np.spacing(np.maximum(np.maximum(np.abs(got),
                                                 np.abs(want)), 1.0))
        assert (np.abs(got - want) / scale).max() <= 4.0, a


def test_lrpg_sampling_matches_softmax_distribution():
    """Gumbel-max over the counter streams is a softmax sample: empirical
    frequencies over 4096 seeds x 8 steps match softmax(logits) within
    0.02 (tests/test_policy_rollout.py's bar)."""
    logits = torch.tensor([1.0, 0.5, 0.0, -0.5, -1.0])
    seeds = torch.arange(4096, dtype=torch.int64)
    draws = [tpg.gumbel_max(logits[None, :].expand(4096, 5), seeds, t)
             for t in range(8)]
    freq = np.bincount(torch.cat(draws).numpy(), minlength=5) / (4096 * 8)
    np.testing.assert_allclose(freq, torch.softmax(logits, 0).numpy(),
                               atol=0.02)


def test_act_matches_jax():
    """Softmax samples from the same weights, seeds and step are JAX's."""
    jagent = JLRPG(JCartPole3D(JCartPoleParams(), num_envs=256),
                   JLRPGConfig(hidden=(32, 32), learner="xla"))
    agent = LRPG(CartPole3D(CartPoleParams(), num_envs=256),
                 LRPGConfig(hidden=(32, 32), learner="xla"))
    st = jagent.init(0)
    params = _perturb(st.params, 2)
    policy = policy_from_flax(jax.device_get(params), F, 5, (32, 32))
    obs, seeds = np.array(st.obs), np.array(st.env_state.env_seed)
    for t in (0, 17, 40):
        want = jagent.act(params, jnp.asarray(obs), jnp.asarray(seeds),
                          jnp.int32(t))
        got = agent.act(policy, torch.from_numpy(obs),
                        torch.from_numpy(seeds.astype(np.int64)), t)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert len(np.unique(got.numpy())) == 5


@pytest.mark.parametrize("hidden", [(64, 64), (24,), (16, 24, 8)])
def test_policy_matches_flax(hidden):
    obs = np.random.RandomState(0).normal(0, 1, (64, F)).astype(np.float32)
    jp = _perturb(JPolicyMLP(hidden=hidden).init(jax.random.PRNGKey(0),
                                                 obs[:1]), 1)
    net = policy_from_flax(jax.device_get(jp), F, 5, hidden)
    with torch.no_grad():
        got = net(torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(got, np.asarray(JPolicyMLP(
        hidden=hidden).apply(jp, obs)), rtol=1e-5, atol=1e-6)
    assert PolicyMLP(F).hidden == (64, 64)


# --- returns-to-go -----------------------------------------------------------

def test_returns_to_go_matches_jax():
    """A random (T, B) reward/done pattern with a bootstrap: the reverse
    recursion that stops at dones, within rtol 1e-6."""
    rng = np.random.RandomState(7)
    rew = rng.uniform(0, 1, (32, 64)).astype(np.float32)
    done = rng.uniform(size=(32, 64)) < 0.1
    boot = rng.normal(0, 5, (64,)).astype(np.float32)
    want = np.asarray(j_returns_to_go(jnp.asarray(rew), jnp.asarray(done),
                                      0.99, jnp.asarray(boot)))
    got = returns_to_go(torch.from_numpy(rew), torch.from_numpy(done), 0.99,
                        torch.from_numpy(boot)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # Envs that end inside the window and envs bootstrapped throughout.
    assert done.any(0).any() and not done.any(0).all()


# --- the B8 twin ---------------------------------------------------------------

def _pg_setup(b, hidden, t):
    """A JAX LRPG state whose LayerNorm parameters and head are redrawn from
    a numpy seed (so the logits spread the samples over all 5 actions),
    and the same policy converted to the port."""
    jagent = JLRPG(JCartPole3D(JCartPoleParams(), num_envs=b),
                   JLRPGConfig(hidden=hidden, rollout_steps=t,
                               learner="xla"))
    st = jagent.init(0)
    rng = np.random.RandomState(4)
    p = st.params["params"]
    for i in range(len(hidden)):
        ln = p["_Torso_0"][f"LayerNorm_{i}"]
        ln["scale"] = jnp.asarray(
            1.0 + rng.normal(0, 0.2, ln["scale"].shape).astype(np.float32))
        ln["bias"] = jnp.asarray(
            rng.normal(0, 0.1, ln["bias"].shape).astype(np.float32))
    for name, scale in (("kernel", 0.5), ("bias", 0.1)):
        p["Dense_0"][name] = jnp.asarray(rng.normal(
            0, scale, p["Dense_0"][name].shape).astype(np.float32))
    policy = policy_from_flax(jax.device_get(st.params), F, 5, hidden)
    env = CartPole3D(CartPoleParams(), num_envs=b)
    return jagent, st, policy, env


def _min_top2_gap(policy, traj, env_seed, t0):
    """The twin's smallest gap between the two largest logits + Gumbel
    draws over the window: the margin by which every sample was taken."""
    with torch.no_grad():
        top = torch.stack([
            torch.topk(tpg.gumbel_scores(policy(o), env_seed, t0 + i),
                       2).values for i, o in enumerate(traj[0])])
    return float((top[..., 0] - top[..., 1]).min())


def test_reference_pg_rollout_matches_jax():
    """64 envs, hidden (16, 16), T 4 from the carried-over state: actions
    exact with all 5 drawn (no sample decided by less than 1e-5)."""
    hidden, t = (16, 16), 4
    jagent, st, policy, env = _pg_setup(64, hidden, t)
    want = jax.jit(j_reference_pg_rollout(jagent, t))(
        st.env_state, st.obs, st.params, jnp.int32(3), jnp.float32(0.0))
    state, obs = _port_inputs(st)
    got = tpg.reference_pg_rollout(env, policy, state, obs, 3, t)
    _assert_rollouts_match(got, want)
    assert len(np.unique(got[2][1].numpy())) == 5
    assert _min_top2_gap(policy, got[2], state.env_seed, 3) > 1e-5
    assert got[2][3].any()  # some envs finished and reset in the window


def test_reference_pg_rollout_matches_jax_pallas_kernel():
    """The twin against the reference's own kernel B8 (interpret mode,
    which takes multiples of 1024 envs)."""
    hidden, t = (16, 16), 3
    _, st, policy, env = _pg_setup(1024, hidden, t)
    run = j_pg_policy_rollout(JCartPole3D(JCartPoleParams(), num_envs=1024),
                              hidden, t, interpret=True)
    want = jax.jit(run)(st.env_state, st.obs, st.params, jnp.int32(0),
                        jnp.float32(0.0))
    got = tpg.reference_pg_rollout(env, policy, *_port_inputs(st), 0, t)
    _assert_rollouts_match(got, want)


def test_wrapper_runs_twin_on_cpu():
    _, st, policy, env = _pg_setup(64, (16, 16), 4)
    before = tpg.pg_policy_rollout.launches
    got = tpg.pg_policy_rollout(env, policy, *_port_inputs(st), 5, 4)
    want = tpg.reference_pg_rollout(env, policy, *_port_inputs(st), 5, 4)
    assert tpg.pg_policy_rollout.launches == before
    for a, b in zip((*got[2], *got[0].phys, got[1]),
                    (*want[2], *want[0].phys, want[1])):
        assert torch.equal(a, b)
    meta = got[0]._replace(steps=got[0].steps.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tpg.pg_policy_rollout(env, policy, meta, got[1], 0, 2)


def test_pg_fusable_gate():
    env = CartPole3D(CartPoleParams(), num_envs=100)
    assert tpg.pg_fusable(env, (64, 64)) and tpg.pg_fusable(env, (256,))
    # Any depth and width, as the reference's kernel.
    assert all(tpg.pg_fusable(env, h)
               for h in ((8,) * 5, (2048,), (4096, 4096)))
    assert not tpg.pg_fusable(env, ())
    assert not tpg.pg_fusable(CartPole3D(CartPoleParams(), num_envs=64,
                                         obs_mode="state"), (64, 64))
    assert not tpg.pg_fusable(CartPole3D(continuous_params(), num_envs=64),
                              (64, 64))


# --- the whole slice ---------------------------------------------------------

def _slice_pair(jlearner, learner, steps=4):
    """`steps` reference train steps (fused=False, its plain rollout) and
    the port's (B8's wrapper, which runs its twin on CPU tensors) from the
    carried-over initial state (test_learner_kernel.py:663's config)."""
    cfg = dict(hidden=(32, 32), rollout_steps=8)
    jagent = JLRPG(JCartPole3D(JCartPoleParams(), num_envs=64),
                   JLRPGConfig(learner=jlearner, **cfg))
    agent = LRPG(CartPole3D(CartPoleParams(), num_envs=64),
                 LRPGConfig(learner=learner, **cfg))
    assert jagent.kernel_mode == (jlearner == "kernel")
    assert agent.kernel_mode == (learner == "kernel")
    jstep = jax.jit(functools.partial(jagent.train_step, fused=False))
    jst = jagent.init(0)
    pst = lrpg_state_from_jax(agent, jax.device_get(jst))
    pairs = []
    for _ in range(steps):
        jst, jm = jstep(jst)
        pst, m = agent.train_step(pst)
        pairs.append((m, jm))
    return jagent, jst, pst, pairs


@pytest.mark.parametrize("jlearner,learner", [
    ("xla", "xla"), ("xla", "kernel"), ("kernel", "kernel")])
def test_train_steps_match_jax(jlearner, learner):
    """4 train steps from a carried-over JAX state (its tree layout, or its
    kernel layout): params, baseline, Adam count and the metrics within
    rtol 2e-4 / atol 1e-5 (tests/test_learner_kernel.py:676), on the
    port's plain learner and on B9's twin through its wrapper."""
    tol = dict(rtol=2e-4, atol=1e-5)
    jagent, jst, pst, pairs = _slice_pair(jlearner, learner)
    for m, jm in pairs:
        assert m["rollout_impl"] == 0.0
        assert m["learner_impl"] == float(learner == "kernel")
        assert m["env_steps"] == int(jm["env_steps"])
        for key in ("loss", "return_mean", "reward_mean", "done_frac"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       err_msg=key, **tol)
    tree = jax.device_get(jagent.state_to_tree(jst))
    sd = policy_state_dict(tree.params, (32, 32))
    for name, p in pst.policy.state_dict().items():
        np.testing.assert_allclose(p.numpy(), sd[name].numpy(),
                                   err_msg=name, **tol)
    np.testing.assert_allclose(float(pst.baseline), float(tree.baseline),
                               **tol)
    assert pst.opt.count == int(tree.opt[0].count) == 4
    assert pst.env_steps == int(tree.env_steps) == 32
    if learner == "kernel":
        assert pst.policy.head.weight.untyped_storage().data_ptr() == \
            pst.groups[0].untyped_storage().data_ptr()


def test_lrpg_state_from_jax_round_trip():
    """A reference state after one step, in its kernel layout, converts
    exactly: policy, Adam moments and count, baseline, env state."""
    jagent, jst, _, _ = _slice_pair("kernel", "xla", steps=1)
    agent = LRPG(CartPole3D(CartPoleParams(), num_envs=64),
                 LRPGConfig(hidden=(32, 32), rollout_steps=8, learner="xla"))
    pst = lrpg_state_from_jax(agent, jax.device_get(jst))
    tree = jax.device_get(jagent.state_to_tree(jst))
    sd = policy_state_dict(tree.params, (32, 32))
    for name, p in pst.policy.state_dict().items():
        assert torch.equal(p, sd[name]), name
    for got, t in ((pst.opt.mu, tree.opt[0].mu), (pst.opt.nu, tree.opt[0].nu)):
        sd = policy_state_dict(t, (32, 32))
        for (name, _), x in zip(pst.policy.named_parameters(), got):
            assert torch.equal(x, sd[name]), name
    assert pst.opt.count == 1 and pst.groups is None
    assert float(pst.baseline) == float(tree.baseline)
    np.testing.assert_array_equal(pst.env_state.episode.numpy(),
                                  np.asarray(tree.env_state.episode))


def test_lrpg_config_rejections():
    env = CartPole3D(CartPoleParams(), num_envs=8)
    for bad in (dict(dtype="bfloat16"), dict(learner="tpu"),
                dict(learner_precision="highest")):
        with pytest.raises(ValueError, match="not ported|unknown"):
            LRPG(env, LRPGConfig(**bad))
    with pytest.raises(ValueError, match="discrete env"):
        LRPG(CartPole3D(continuous_params(), num_envs=4), LRPGConfig())
    with pytest.raises(ValueError, match="not covered by the fused update "
                                         "kernel B9"):
        LRPG(env, LRPGConfig(hidden=(), learner="kernel"))


# --- the random agent ------------------------------------------------------------

def test_random_agent_smoke():
    env = CartPole3D(CartPoleParams(), num_envs=16)
    stats = RandomAgent(env).evaluate(0, 64)
    assert all(np.isfinite(float(v)) for v in stats.values())
    assert float(stats["episodes"]) > 0  # random policy must fail sometimes
    assert stats["steps_per_episode"] is stats["mean_episode_length"]


def test_evaluate_policy_exact_invariants():
    """The episode count equals the total number of dones (every done
    completes exactly one episode; censored tails are excluded from the
    length stats)."""
    env = CartPole3D(CartPoleParams(), num_envs=16)
    num_steps = 64
    stats = evaluate_policy(env, RandomAgent(env).policy, 0, num_steps,
                            generator=torch.Generator().manual_seed(0))
    episodes = int(stats["episodes"])
    assert episodes > 0
    np.testing.assert_allclose(
        float(stats["done_frac"]) * num_steps * env.num_envs, episodes,
        rtol=1e-5)
    assert 1.0 <= float(stats["mean_episode_length"]) <= 200.0
    assert stats["median_episode_length"] <= stats["max_episode_length"]


def test_random_agent_draws():
    """Discrete draws cover [0, 5) as int32; continuous ones lie in
    [-1, 1)^2; the same seed gives the same statistics."""
    obs = torch.zeros((4096, F))
    g = torch.Generator().manual_seed(1)
    a = RandomAgent(CartPole3D(CartPoleParams(), num_envs=4096)).policy(obs, g)
    assert a.dtype == torch.int32
    assert sorted(torch.unique(a).tolist()) == [0, 1, 2, 3, 4]
    c = RandomAgent(CartPole3D(continuous_params(), num_envs=4096)).policy(
        obs, g)
    assert c.shape == (4096, 2) and float(c.min()) >= -1.0
    assert float(c.max()) < 1.0 and float(c.min()) < -0.99
    env = CartPole3D(CartPoleParams(), num_envs=16)
    s1, s2 = (RandomAgent(env).evaluate(5, 32) for _ in range(2))
    assert all(float(s1[k]) == float(s2[k]) for k in s1)


def test_random_agent_episode_length_matches_jax():
    """The draws differ (jax.random against a torch generator), so parity
    is statistical: the mean episode length over 64 envs x 400 steps is
    within 20 % of the reference's."""
    want = jax.jit(JRandom(JCartPole3D(JCartPoleParams(), num_envs=64))
                   .evaluate, static_argnums=(1,))(jax.random.PRNGKey(0),
                                                   400)
    got = RandomAgent(CartPole3D(CartPoleParams(), num_envs=64)).evaluate(
        0, 400)
    ratio = (float(got["mean_episode_length"])
             / float(want["mean_episode_length"]))
    assert 0.8 <= ratio <= 1.2, ratio


# --- the CLI ---------------------------------------------------------------------

@pytest.mark.parametrize("learner,impl", [("xla", 0.0), ("kernel", 1.0)])
def test_train_cli_cpu(learner, impl):
    """train.main --agent lrpg on the CPU at 64 envs for 3 train steps: rc
    0, finite metrics, the learner asked for, and an eval line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ttrain.main(["--agent", "lrpg", "--device", "cpu",
                          "--num-envs", "64", "--total-env-steps", "24",
                          "--log-interval", "1", "--lrpg.hidden", "16", "16",
                          "--lrpg.rollout-steps", "8", "--lrpg.learner",
                          learner, "--final-eval", "--eval-steps", "20"])
    assert rc == 0
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    steps = lines[:-1]
    assert [x["train_step"] for x in steps] == [1, 2, 3]
    for x in lines:
        assert all(np.isfinite(v) for v in x.values()), x
    assert all(x["learner_impl"] == impl and x["rollout_impl"] == 0.0
               for x in steps)
    assert [x["env_steps"] for x in steps] == [8, 16, 24]
    assert 0 < lines[-1]["eval_mean_episode_length"] <= 20


def test_train_cli_random_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ttrain.main(["--agent", "random", "--device", "cpu",
                          "--num-envs", "32", "--total-env-steps", "50"])
    assert rc == 0
    lines = out.getvalue().splitlines()
    assert len(lines) == 1
    stats = json.loads(lines[0])
    assert stats["steps_per_episode"] == stats["mean_episode_length"] > 0
    assert all(np.isfinite(v) for v in stats.values())


def test_train_cli_cuda_rejects_shapes_b8_does_not_cover():
    """On a GPU a shape B8 does not cover runs the plain rollout on the
    card: the agent resolves to it at construction with one stderr line
    naming the kernel (train.build with --device cuda; no card here to
    train on)."""
    assert _cuda_plain_rollout(["--agent", "lrpg", "--num-envs", "8",
                                "--obs-mode", "state"], "B8")


@pytest.mark.parametrize("hidden", [["8"] * 5, ["2048"]])
def test_train_cli_cuda_takes_b8_at_any_depth_and_width(hidden):
    """Five layers and a 2048-wide torso resolve to the kernel route on a
    GPU, with no stderr line (train.build with --device cuda)."""
    assert _cuda_kernel_rollout(["--agent", "lrpg", "--num-envs", "8",
                                 "--lrpg.hidden", *hidden], "B8")
