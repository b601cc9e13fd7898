"""The port's NAF (NafNet, the sigma schedule, the loss and one plain
update with the global-norm clip and the lr schedule, train steps on both
learners, the JAX-state bridge, the CLI) against the JAX reference on the
CPU."""

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
from cartpoleplusplus_tpu.agents import NAF as JNAF
from cartpoleplusplus_tpu.agents import NAFConfig as JNAFConfig
from cartpoleplusplus_tpu.models import NafNet as JNafNet
from cartpoleplusplus_tpu.models import polyak as jpolyak
from cartpoleplusplus_tpu.physics import params as jparams
from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams
from cartpoleplusplus_tpu_torch import train as ttrain
from cartpoleplusplus_tpu_torch.agents import NAF, NAFConfig, NAFState
from cartpoleplusplus_tpu_torch.agents.common import AdamState
from cartpoleplusplus_tpu_torch.models import NafNet
from cartpoleplusplus_tpu_torch.models.from_jax import (
    naf_from_flax,
    naf_state_dict,
    naf_state_from_jax,
)
from cartpoleplusplus_tpu_torch.physics.params import continuous_params
from test_torch_ddpg import (_column_indices, _cuda_kernel_rollout,
                             _cuda_plain_rollout, _perturb)

HIDDEN = (32, 32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(learner="xla", b=64, **kw):
    cfg = dict(hidden=HIDDEN, **kw)
    jagent = JNAF(JCartPole3D(jparams.continuous_params(), num_envs=b),
                  JNAFConfig(learner=learner, **cfg))
    agent = NAF(CartPole3D(continuous_params(), num_envs=b),
                NAFConfig(learner=learner, **cfg))
    return jagent, agent


def _flax_init(hidden):
    return JNafNet(hidden=hidden).init(jax.random.PRNGKey(0),
                                       np.zeros((1, 42), np.float32),
                                       np.zeros((1, 2), np.float32))


@pytest.mark.parametrize("hidden", [HIDDEN, (16, 24, 8)])
def test_nafnet_matches_flax(hidden):
    """(v, mu) and (q, mu, v) from the same (perturbed) weights within rtol
    1e-5, atol 1e-5 (Q sums squares of products of the heads)."""
    rng = np.random.RandomState(0)
    obs = rng.normal(0, 1, (64, 42)).astype(np.float32)
    act = rng.uniform(-1, 1, (64, 2)).astype(np.float32)
    jp = _perturb(_flax_init(hidden), 1)
    net = naf_from_flax(jax.device_get(jp), 42, 2, hidden)
    jnet = JNafNet(hidden=hidden)
    with torch.no_grad():
        v, mu = net(torch.from_numpy(obs))
        q, mu2, v2 = net(torch.from_numpy(obs), torch.from_numpy(act))
    jv, jmu = jnet.apply(jp, obs)
    jq, jmu2, jv2 = jnet.apply(jp, obs, act)
    for got, want in ((v, jv), (mu, jmu), (q, jq), (mu2, jmu2), (v2, jv2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert float(np.abs(np.asarray(jq) - np.asarray(jv)).max()) > 0.1


def test_nafnet_head_init():
    """The packed head: rows v and l0-l2 take flax's default Dense init
    (truncated lecun normal over fan-in H), the mu rows U[0, 3e-3); every
    bias zero; the torso as the other nets."""
    net = NafNet(42, 2, (256, 256),
                 generator=torch.Generator().manual_seed(0))
    w = net.head.weight.detach()
    assert w.shape == (6, 256)
    mu = w[1:3]
    assert float(mu.min()) >= 0.0 and float(mu.max()) < 3e-3
    lecun = torch.cat([w[:1], w[3:]])
    std = (1 / 256) ** 0.5
    assert abs(float(lecun.std()) - std) < 0.1 * std
    assert float(lecun.abs().max()) <= 2 * std / 0.8796
    assert float(lecun.min()) < -3e-3
    assert float(net.head.bias.detach().abs().max()) == 0.0
    assert float(net.torso[0].bias.detach().abs().max()) == 0.0


@pytest.mark.parametrize("decay", [30000, 1200, 0])
def test_sigma_matches_jax_bitwise(decay):
    """The float32 linear schedule of the exploration scale, decay on and
    off."""
    jagent, agent = _pair(b=4, noise_sigma_decay_env_steps=decay)
    for steps in (0, 8, 333, 1199, 1200, 5000, 29999, 30000, 50000):
        got = agent._sigma(steps)
        assert np.float32(got) == np.float32(jagent._sigma(jnp.int32(steps)))
    if decay <= 0:
        assert agent._sigma(100) == float(np.float32(agent.cfg.noise_sigma))


def test_act_matches_jax():
    """Greedy mu and the noisy, clipped actions from the same weights,
    seeds and step."""
    jagent, agent = _pair(b=256)
    st = jagent.init(0)
    jp = _perturb(st.params, 2)
    net = naf_from_flax(jax.device_get(jp), 42, 2, HIDDEN)
    obs = np.array(st.obs)
    seeds = np.array(st.env_state.env_seed)
    tseeds = torch.from_numpy(seeds.astype(np.int64))
    np.testing.assert_allclose(
        agent.act(net, torch.from_numpy(obs)).numpy(),
        np.asarray(jagent.act(jp, jnp.asarray(obs))), rtol=1e-5, atol=1e-6)
    for t, sigma in ((17, 0.3), (40, 0.0)):
        want = jagent.act(jp, jnp.asarray(obs), jnp.asarray(seeds),
                          jnp.int32(t), jnp.float32(sigma))
        got = agent.act(net, torch.from_numpy(obs), tseeds, t, sigma)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def _batch(seed, bm=64):
    rng = np.random.RandomState(seed)
    obs = (0.3 * rng.normal(size=(bm, 42))).astype(np.float32)
    return (obs, rng.uniform(-1, 1, (bm, 2)).astype(np.float32),
            rng.uniform(size=(bm,)).astype(np.float32),
            (obs + 0.05 * rng.normal(size=obs.shape)).astype(np.float32),
            rng.uniform(size=(bm,)) < 0.1)


def _warm(opt, count, mu, nu):
    """An optax state with every count set to `count` and the Adam moments
    replaced (whichever the nesting: behind the clip or not)."""
    if hasattr(opt, "_fields"):
        if "mu" in opt._fields:
            return opt._replace(count=jnp.int32(count), mu=mu, nu=nu)
        if "count" in opt._fields:
            return opt._replace(count=jnp.int32(count))
        return opt
    if isinstance(opt, tuple):
        return tuple(_warm(o, count, mu, nu) for o in opt)
    return opt


@pytest.mark.parametrize("clip", [10.0, 0.5, 0.0],
                         ids=["clip10", "firing", "noclip"])
def test_loss_and_plain_update_match_jax(clip):
    """`_loss` and one `_update_once` (the TD gradient, optax's clip, Adam
    at the scheduled lr from warmed moments, Polyak) against the
    reference's jax.value_and_grad(_loss) + tx.update: loss within rtol
    1e-5, the updated NafNet and target within rtol 1e-5, atol 1e-7."""
    jagent, agent = _pair(b=8, lr=1e-3, tau=0.05, max_grad_norm=clip,
                          lr_decay_env_steps=100)
    init = _flax_init(HIDDEN)
    jp, jt = _perturb(init, 3), _perturb(init, 4)
    rng = np.random.RandomState(5)
    mu = jax.tree.map(lambda x: jnp.asarray(
        rng.normal(0, 1e-2, x.shape).astype(np.float32)), init)
    nu = jax.tree.map(lambda x: jnp.asarray(
        (rng.normal(0, 1e-2, x.shape) ** 2 + 1e-5).astype(np.float32)), init)
    jopt = _warm(jagent.tx.init(jp), 30, mu, nu)
    batch = _batch(6)
    jbatch = tuple(jnp.asarray(x) for x in batch)

    jloss, grad = jax.value_and_grad(jagent._loss)(jp, jt, jbatch)
    norm = float(optax.global_norm(grad))
    assert (clip == 0.5) == (0.0 < clip < norm), norm
    upd, _ = jagent.tx.update(grad, jopt, jp)
    jp2 = optax.apply_updates(jp, upd)
    jt2 = jpolyak(jt, jp2, agent.cfg.tau)

    net = naf_from_flax(jax.device_get(jp), 42, 2, HIDDEN)
    target = naf_from_flax(jax.device_get(jt), 42, 2, HIDDEN)

    def moments(tree):
        sd = naf_state_dict(jax.device_get(tree), HIDDEN)
        return [sd[n].clone() for n, _ in net.named_parameters()]

    st = NAFState(net=net, target=target,
                  opt=AdamState(count=30, mu=moments(mu), nu=moments(nu)),
                  replay=None, env_state=None, obs=None, generator=None,
                  env_steps=0)
    tbatch = tuple(torch.from_numpy(np.asarray(x)) for x in batch)
    loss = agent._loss(net, target, tbatch).detach()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    st2, m = agent._update_once(st, tbatch)
    assert st2.opt.count == 31
    for module, tree in ((st2.net, jp2), (st2.target, jt2)):
        sd = naf_state_dict(jax.device_get(tree), HIDDEN)
        for name, p in module.state_dict().items():
            np.testing.assert_allclose(p.numpy(), sd[name].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=name)


def _train_pair(learner, steps=4):
    """`steps` reference train steps (fused=False) and the port's from the
    converted initial state, with the reference's replay draws injected."""
    k, t, cap = 2, 4, 16
    jagent, agent = _pair(learner, warmup_env_steps=8, updates_per_step=k,
                          batch_size=32, rollout_steps=t,
                          replay_capacity_per_env=cap,
                          noise_sigma_decay_env_steps=100,
                          lr_decay_env_steps=64)
    assert agent.kernel_mode == (learner == "kernel") == jagent.kernel_mode
    jstep = jax.jit(functools.partial(jagent.train_step, fused=False))
    jst = jagent.init(0)
    pst = naf_state_from_jax(agent, jax.device_get(jst))
    pairs = []
    for i in range(1, steps + 1):
        ready = i * t >= agent.cfg.warmup_env_steps
        indices = (_column_indices(jagent, jst, k, min(i * t, cap),
                                   (i * t) % cap) if ready else None)
        jst, jm = jstep(jst)
        pst, m = agent.train_step(pst, indices=indices)
        pairs.append((m, jm))
    return jagent, jst, pst, pairs


@pytest.mark.parametrize("learner", ["xla", "kernel"])
def test_train_steps_match_jax(learner):
    """4 train steps (3 past the warmup, 6 updates, the clip at its default
    10 and the lr schedule on) from the converted initial state against
    JAX train_step(fused=False) with the same learner, the reference's
    replay draws injected: metrics, NafNet and target within rtol 2e-4,
    atol 1e-5 (the reference's kernel-vs-XLA bar). "kernel" is B7's twin
    through its wrapper against the reference's Pallas kernel in interpret
    mode."""
    jagent, jst, pst, pairs = _train_pair(learner)
    tol = dict(rtol=2e-4, atol=1e-5)
    for m, jm in pairs:
        assert m["rollout_impl"] == 0.0
        assert m["learner_impl"] == float(jm["learner_impl"])
        for key in ("loss", "reward_mean", "done_frac"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       err_msg=key, **tol)
    assert float(pairs[-1][0]["loss"]) > 0.0
    jst = jax.device_get(jagent.state_to_tree(jst))
    for module, tree in ((pst.net, jst.params), (pst.target, jst.target)):
        sd = naf_state_dict(tree, HIDDEN)
        for name, p in module.state_dict().items():
            np.testing.assert_allclose(p.numpy(), sd[name].numpy(),
                                       err_msg=name, **tol)
    assert pst.opt.count == int(jagent._adam_state(jst.opt).count) == 6
    assert pst.replay.cursor == int(jst.replay.cursor)
    np.testing.assert_allclose(pst.replay.action.numpy(),
                               np.asarray(jst.replay.action), **tol)
    np.testing.assert_allclose(pst.replay.obs.numpy(),
                               np.asarray(jst.replay.obs), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("clip", [10.0, 0.0], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("learner", ["xla", "kernel"])
def test_naf_state_from_jax_round_trip(learner, clip):
    """A reference state after one learning step, in either of its layouts
    (flax trees, or kernel-mode flat lists) and either optax nesting (Adam
    behind the clip at opt[1][0], or at opt[0]), converts to the port
    exactly: parameters, target, Adam moments and count, the float replay
    ring, env state and counters; in kernel mode the port's modules are
    views of its 4 group buffers."""
    jagent, agent = _pair(learner, warmup_env_steps=0, updates_per_step=2,
                          batch_size=32, rollout_steps=4,
                          replay_capacity_per_env=16, max_grad_norm=clip)
    jst, _ = jax.jit(functools.partial(jagent.train_step, fused=False))(
        jagent.init(0))
    assert isinstance(jst.params, (list, tuple)) == (learner == "kernel")
    pst = naf_state_from_jax(agent, jax.device_get(jst))
    tree = jax.device_get(jagent.state_to_tree(jst))
    for module, t in ((pst.net, tree.params), (pst.target, tree.target)):
        sd = naf_state_dict(t, HIDDEN)
        for name, p in module.state_dict().items():
            assert torch.equal(p, sd[name]), name
    adam = jagent._adam_state(tree.opt)
    for got, t in ((pst.opt.mu, adam.mu), (pst.opt.nu, adam.nu)):
        sd = naf_state_dict(t, HIDDEN)
        for (name, _), x in zip(pst.net.named_parameters(), got):
            assert torch.equal(x, sd[name]), name
    assert pst.opt.count == int(adam.count) == 2
    assert pst.replay.action.dtype == torch.float32
    np.testing.assert_array_equal(pst.replay.action.numpy(),
                                  np.asarray(tree.replay.action))
    assert pst.env_steps == int(tree.env_steps) == 4
    np.testing.assert_array_equal(pst.env_state.episode.numpy(),
                                  np.asarray(tree.env_state.episode))
    assert (pst.groups is not None) == (learner == "kernel")
    if pst.groups is not None:
        assert pst.net.torso[0].weight.untyped_storage().data_ptr() == \
            pst.groups[0].untyped_storage().data_ptr()


def test_train_cli_cpu():
    """train.main --agent naf on the CPU at 64 envs for 3 train steps: rc
    0, finite metrics, the plain learner (the NAF default) past the
    warmup, the continuous preset, and an eval line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ttrain.main(["--agent", "naf", "--device", "cpu",
                          "--num-envs", "64", "--total-env-steps", "24",
                          "--log-interval", "1", "--naf.hidden", "32", "32",
                          "--naf.replay-capacity-per-env", "64",
                          "--final-eval", "--eval-steps", "20"])
    assert rc == 0
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    steps = lines[:-1]
    assert [x["train_step"] for x in steps] == [1, 2, 3]
    for x in lines:
        assert all(np.isfinite(v) for v in x.values()), x
    assert steps[0]["loss"] == 0.0
    assert all(x["loss"] > 0.0 for x in steps[1:])  # warmup 16 env-steps
    assert all(x["learner_impl"] == 0.0 and x["rollout_impl"] == 0.0
               for x in steps)
    assert 0 < lines[-1]["eval_mean_episode_length"] <= 20
    args = ttrain.build_parser().parse_args(["--agent", "naf", "--device",
                                             "cpu", "--num-envs", "4"])
    env, _ = ttrain.build(ttrain.from_args(ttrain.RunConfig, args), args,
                          set())
    assert env.params == continuous_params()


@pytest.mark.parametrize("argv", [["--obs-mode", "state"],
                                  ["--naf.hidden", *["8"] * 5],
                                  ["--naf.hidden", "2048"]])
def test_train_cli_cuda_rejects_shapes_b6_does_not_cover(argv):
    """On a GPU a shape B6 does not cover (state obs) runs the plain
    rollout on the card: the agent resolves to it at construction with one
    stderr line naming the kernel. Any depth and width of the torso takes
    the kernel route with no such line (train.build with --device cuda; no
    card here to train on)."""
    argv = ["--agent", "naf", "--num-envs", "8", *argv]
    if "--naf.hidden" in argv:
        assert _cuda_kernel_rollout(argv, "B6")
    else:
        assert _cuda_plain_rollout(argv, "B6")


def test_unported_settings_and_the_discrete_env_raise():
    env = CartPole3D(continuous_params(), num_envs=8)
    for kw in (dict(dtype="bfloat16"), dict(sample="block"),
               dict(learner_precision="highest")):
        with pytest.raises(ValueError, match="not ported"):
            NAF(env, NAFConfig(**kw))
    with pytest.raises(ValueError, match="continuous env"):
        NAF(CartPole3D(CartPoleParams(), num_envs=4), NAFConfig())
