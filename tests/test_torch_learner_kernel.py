"""Kernel B3's plain twin, its wrapper on CPU tensors, and the port's DDPG
learners against the JAX reference on the CPU.

Inputs come from numpy with a seed. The comparisons start from warmed Adam
moments (t0 > 0, nonzero m and v): from zero moments Adam's first step is
+-lr for any element whose gradient is rounding noise, so a different
summation order could flip such an element by a whole lr.
"""

import contextlib
import io

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
from cartpoleplusplus_tpu.ops import learner_kernel as jlk
from cartpoleplusplus_tpu.physics import params as jparams
from cartpoleplusplus_tpu_torch import CartPole3D
from cartpoleplusplus_tpu_torch.agents import DDPG, DDPGConfig
from cartpoleplusplus_tpu_torch.agents.ddpg import resolve_learner
from cartpoleplusplus_tpu_torch.models import ActorMLP
from cartpoleplusplus_tpu_torch.models.from_jax import (
    actor_state_dict,
    critic_state_dict,
    ddpg_state_from_jax,
)
from cartpoleplusplus_tpu_torch.ops import _native
from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk
from cartpoleplusplus_tpu_torch.physics.params import continuous_params
from test_torch_ddpg import _column_indices, _perturb

F = 42
K = 3
BM = 64
LRS = dict(actor_lr=1e-3, critic_lr=2e-3, gamma=0.99, tau=0.05)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _trees(hidden, seed):
    """The 8 learner groups as flax trees: perturbed weights and targets,
    and warmed Adam moments (m ~ 1e-2, v ~ 1e-4)."""
    obs = np.zeros((1, F), np.float32)
    act = np.zeros((1, 2), np.float32)
    ja = JActorMLP(hidden=hidden).init(jax.random.PRNGKey(0), obs)
    jc = JCriticMLP(hidden=hidden).init(jax.random.PRNGKey(1), obs, act)
    rng = np.random.RandomState(seed)

    def moments(tree):
        m = jax.tree.map(lambda x: jnp.asarray(
            rng.normal(0, 1e-2, x.shape).astype(np.float32)), tree)
        v = jax.tree.map(lambda x: jnp.asarray(
            (rng.normal(0, 1e-2, x.shape) ** 2 + 1e-5).astype(np.float32)),
            tree)
        return m, v

    m_a, v_a = moments(ja)
    m_c, v_c = moments(jc)
    return (_perturb(ja, seed), _perturb(jc, seed + 1),
            _perturb(ja, seed + 2), _perturb(jc, seed + 3),
            m_a, v_a, m_c, v_c)


def _batches(seed, k=K, bm=BM):
    rng = np.random.RandomState(seed)
    obs = (0.3 * rng.normal(size=(k, bm, F))).astype(np.float32)
    return (obs, rng.uniform(-1, 1, (k, bm, 2)).astype(np.float32),
            rng.uniform(size=(k, bm)).astype(np.float32),
            (obs + 0.05 * rng.normal(size=obs.shape)).astype(np.float32),
            rng.uniform(size=(k, bm)) < 0.1)


_IS_ACTOR = (True, False, True, False, True, True, False, False)


def _port_list(tree, hidden, actor: bool):
    """A flax tree -> the port's parameter list (ops.learner_kernel
    layout)."""
    sd = (actor_state_dict if actor else critic_state_dict)(
        jax.device_get(tree), hidden)
    lay = (lk.actor_layout if actor else lk.critic_layout)(F, hidden)
    return [sd[name] for name, _ in lay]


def _jax_flat_to_port(flat, hidden, actor: bool):
    tree = (jlk.unflatten_actor if actor else jlk.unflatten_critic)(
        flat, hidden)
    return [t.numpy() for t in _port_list(tree, hidden, actor)]


@pytest.mark.parametrize("sched", [None, (0.1, 100)], ids=["const", "sched"])
@pytest.mark.parametrize("agc", ["updated", "pre"])
@pytest.mark.parametrize("hidden", [(32, 32), (16, 24, 8), (8,) * 5],
                         ids=["h32x2", "h16-24-8", "h8x5"])
def test_update_phase_math_matches_jax(hidden, agc, sched):
    """K = 3 updates of the torch twin against the JAX twin: all 8 groups
    and both loss vectors within rtol 1e-5, atol 1e-6 (float32 matmuls of
    both frameworks on the CPU, summed in different orders; measured
    ~1.2e-7). The bar is tight enough to tell "pre" from "updated"
    (~6e-5 apart at these shapes)."""
    trees = _trees(hidden, seed=3)
    bat = _batches(seed=4)
    t0 = 40
    kw = dict(LRS, actor_grad_critic=agc, lr_schedule=sched)
    jflat = [(jlk.flatten_actor if a else jlk.flatten_critic)(t, hidden)
             for t, a in zip(trees, _IS_ACTOR)]
    want = jlk.update_phase_math(*jflat, tuple(jnp.asarray(x) for x in bat),
                                 jnp.int32(t0), hidden, **kw)
    got = lk.update_phase_math(
        *[_port_list(t, hidden, a) for t, a in zip(trees, _IS_ACTOR)],
        tuple(torch.from_numpy(np.asarray(x)) for x in bat), t0, hidden,
        **kw)
    for g, (got_g, want_g, a) in enumerate(zip(got[:8], want[:8],
                                               _IS_ACTOR)):
        for i, (x, y) in enumerate(zip(got_g,
                                       _jax_flat_to_port(want_g, hidden, a))):
            np.testing.assert_allclose(x.numpy(), y, rtol=1e-5, atol=1e-6,
                                       err_msg=f"group {g} param {i}")
    for x, y in zip(got[8:], want[8:]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-6)
    assert float(got[8][0]) > 0.0


def _flat_groups(hidden, seed):
    """The 8 group buffers (CPU) of `_trees`."""
    return [torch.cat([p.reshape(-1) for p in _port_list(t, hidden, a)])
            for t, a in zip(_trees(hidden, seed), _IS_ACTOR)]


def test_wrapper_cpu_runs_twin_in_place():
    """On CPU buffers the wrapper runs the twin, writes its results into
    the buffers, and does not count a launch."""
    hidden = (16, 24, 8)
    groups = _flat_groups(hidden, seed=5)
    bat = tuple(torch.from_numpy(np.asarray(x)) for x in _batches(seed=6))
    lays = [(lk.actor_layout if a else lk.critic_layout)(F, hidden)
            for a in _IS_ACTOR]
    want = lk.update_phase_math(
        *[[v.clone() for v in lk.group_views(g, lay)]
          for g, lay in zip(groups, lays)], bat, 7, hidden, **LRS)
    before = lk.ddpg_update_phase.launches
    closs, aloss = lk.ddpg_update_phase(groups, bat, 7, hidden, **LRS)
    assert lk.ddpg_update_phase.launches == before
    for g, lay, want_g in zip(groups, lays, want[:8]):
        for v, w in zip(lk.group_views(g, lay), want_g):
            assert torch.equal(v, w)
    assert torch.equal(closs, want[8]) and torch.equal(aloss, want[9])


def test_b3_plan_and_workspace():
    """B3's plan on the row chains: forward items of 8 batch rows (at
    "updated" the target actor, the target critic's front and the online
    critic, 96 at the DDPG defaults, then the actor and the critic's front
    over 4 rows, 128; at "pre" all five passes in one stage, 160; 8 rows
    each), backward items
    of 4 rows (64 a stage, or 128 for both chains at "pre"); 131,376 bytes
    of shared memory a block at the defaults (the weight ring, a row
    tile's buffers with its action rows, the device table), the buffers in
    the workspace past two layers of 1468 at obs 42 or when asked; the
    workspace holds the rows the gradient stages and the backward items
    read and, on the spill route, every item's buffers of the largest
    stage."""
    hid = (256, 256)
    assert lk.ddpg_plan(F, hid, 256) == (8, (96, 64, 128, 64), False, 131376)
    assert lk.ddpg_plan(F, hid, 256, "pre") == (8, (160, 128), False, 131376)
    assert lk.ddpg_plan(F, hid, 200) == (8, (75, 50, 100, 50), False, 131376)
    assert lk.ddpg_plan(F, hid, 256, spill=True) == (
        8, (96, 64, 128, 64), True, 4 * (3 * 256 * 36 + 32 + 20))
    assert not lk.ddpg_plan(F, (1468, 1468), 256)[2]
    assert lk.ddpg_plan(F, (1469, 1469), 256)[2]
    assert lk.ddpg_plan(F, (1536, 1536), 256)[2]
    assert not lk.ddpg_plan(F, (8,) * 5, 256)[2]
    critic = (4 * 256 * 512 + 256 * 258 + 256 * 256 + 256 * 256 + 512
              + 3 * 256)
    actor = (5 * 256 * 512 + 256 * 256 + 256 * 256 + 256 * 256 + 2 * 512
             + 256)
    assert lk.ddpg_workspace_floats(F, hid, 256) == critic + actor
    assert lk.ddpg_workspace_floats(F, hid, 256, "pre") == critic + actor
    tile = 12 * 256 + 8 * 256 + 2 * 12 + 8   # rounded up to 32 floats
    assert lk.ddpg_workspace_floats(F, hid, 256, spill=True) == (
        critic + actor + 128 * tile)
    assert lk.ddpg_workspace_floats(F, hid, 256, "pre", spill=True) == (
        critic + actor + 160 * tile)
    assert lk.ddpg_workspace_floats(F, (8,) * 5, 200) == (
        4 * 200 * 40 + 6816 + 2 * 200 * 8 + 416 + 3 * 224
        + 5 * 200 * 40 + 200 * 32 + 2 * 200 * 8 + 2 * 416 + 224)


def _b3_rows(b):
    """B3's workspace floats but the items' buffers at batch b, (256,
    256), obs 42: the critic's and the actor's rows."""
    return (4 * b * 512 + b * 258 + b * 256 + b * 256 + 2 * b + 3 * b
            + 5 * b * 512 + b * 256 + b * 256 + b * 256 + 2 * 2 * b + b)


# The wide items' plan at (256, 256), obs 42, on an H100's 132 SMs: per
# case the batch, the actor's gradient mode, the keyword arguments, and
# ddpg_plan's (forward rows, items, spill, shared-memory bytes).
WIDE_SMEM = 4 * (3 * 256 * 36 + 32 + 27464 + 20)  # ring, wide buffers, table
B3_WIDE_CASES = {
    "256": (256, "updated", {}, (8, (96, 64, 128, 64), False, 131376)),
    "8192": (8192, "updated", {}, (32, (768, 256, 512, 256), False,
                                   WIDE_SMEM)),
    "8192-pre": (8192, "pre", {}, (32, (1280, 512), False, WIDE_SMEM)),
    # the critic's forward wide from 1025 (99 items of 32 rows fill three
    # quarters of 132 blocks), the actor's from 1569, the backward from 3137
    "1024": (1024, "updated", {}, (8, (384, 256, 512, 256), False, 131376)),
    "1025": (1025, "updated", {}, (32, (99, 257, 514, 257), False,
                                   WIDE_SMEM)),
    "2048": (2048, "updated", {}, (32, (192, 512, 128, 512), False,
                                   WIDE_SMEM)),
    "3136": (3136, "updated", {}, (32, (294, 784, 196, 784), False,
                                   WIDE_SMEM)),
    "3137": (3137, "updated", {}, (32, (297, 99, 198, 99), False,
                                   WIDE_SMEM)),
    "8192-bf16": (8192, "updated", {"mode": lk.BF16},
                  (8, (3072, 2048, 4096, 2048), False, 131376)),
    "8192-narrow": (8192, "updated", {"route": 1},
                    (8, (3072, 2048, 4096, 2048), False, 131376)),
    "8192-no-sms": (8192, "updated", {"sms": 0},
                    (8, (3072, 2048, 4096, 2048), False, 131376)),
    "256-wide": (256, "updated", {"route": 2}, (32, (24, 8, 16, 8), False,
                                                WIDE_SMEM)),
    "8192-spill": (8192, "updated", {"spill": True},
                   (32, (768, 256, 512, 256), True,
                    4 * (3 * 256 * 36 + 32 + 20))),
}


@pytest.mark.parametrize("case", list(B3_WIDE_CASES))
def test_b3_plan_and_workspace_by_the_wide_rule(case):
    """B3's plan by the wide items' rule: a stage takes items of 32 rows
    where they fill three quarters of the grid's blocks (one an SM), at
    float32 alone; today's items at the defaults' batch 256; the shared
    memory within MAX_SMEM less 4 KB; the workspace's rows, and on the
    spill route the largest stage's items' buffers, on both sides of the
    threshold."""
    batch, agc, kw, want = B3_WIDE_CASES[case]
    hid = (256, 256)
    got = lk.ddpg_plan(F, hid, batch, agc, **kw)
    assert got == want
    assert got[3] <= _native.MAX_SMEM - 4096
    # An item's buffers, rounded up to 32 floats: the narrow forward
    # item's, or (a stage wide) the wide backward item's: dh and dz, dQ/da
    # and d loss / d pre-tanh, the rest's rows and actions, d loss / dQ.
    tile = (68 * 256 + 2 * 32 * 8 + 36 * 256 + 2 * 36 + 32 * 8 + 24
            if got[0] == 32 else 12 * 256 + 8 * 256 + 2 * 12 + 8)
    if batch % 32 == 0:
        assert lk.ddpg_workspace_floats(F, hid, batch, agc, **kw) == (
            _b3_rows(batch) + (max(got[1]) * tile if got[2] else 0))


def test_b3_wide_plan_at_other_widths():
    """Where the wide items' buffers would not fit beside the ring but the
    narrow ones do ((512, 512), (1024,)), the rule keeps the narrow items;
    where neither fits ((1536, 1536)) the wide items go to the workspace."""
    assert lk.ddpg_plan(F, (512, 512), 8192)[:3] == (
        8, (3072, 2048, 4096, 2048), False)
    assert lk.ddpg_plan(F, (1024,), 8192)[:3] == (
        8, (3072, 2048, 4096, 2048), False)
    assert lk.ddpg_plan(F, (1536, 1536), 8192)[:3] == (
        32, (768, 256, 512, 256), True)
    assert lk.ddpg_plan(F, (512, 512), 8192, route=2)[:3] == (
        32, (768, 256, 512, 256), True)


def test_wrapper_rejects_bad_arguments():
    hidden = (16, 24)
    groups = _flat_groups(hidden, seed=7)
    bat = tuple(torch.from_numpy(np.asarray(x)) for x in _batches(seed=8))
    with pytest.raises(ValueError, match="group 1"):
        lk.ddpg_update_phase([groups[0], groups[0]] + groups[2:], bat, 0,
                             hidden, **LRS)
    with pytest.raises(ValueError, match="done"):
        lk.ddpg_update_phase(groups, bat[:4] + (bat[4].float(),), 0, hidden,
                             **LRS)
    with pytest.raises(ValueError, match="strided"):
        lk.ddpg_update_phase(groups, (bat[0].transpose(0, 1).contiguous()
                                      .transpose(0, 1),) + bat[1:], 0,
                             hidden, **LRS)
    with pytest.raises(ValueError, match="not covered"):
        lk.ddpg_update_phase(groups, bat, 0, (16,), **LRS)
    meta = [g.to("meta") for g in groups]
    with pytest.raises(ValueError, match="cuda or cpu"):
        lk.ddpg_update_phase(meta, bat, 0, hidden, **LRS)


def _agent_pair(learner, b=64, **extra):
    kw = dict(hidden=(32, 32), warmup_env_steps=0, updates_per_step=2,
              batch_size=32, rollout_steps=4, replay_capacity_per_env=16,
              **extra)
    jagent = JDDPG(JCartPole3D(jparams.continuous_params(), num_envs=b),
                   JDDPGConfig(learner=learner, **kw))
    agent = DDPG(CartPole3D(continuous_params(), num_envs=b, device="cpu"),
                 DDPGConfig(learner=learner, **kw))
    return jagent, agent


def _assert_state_matches(jagent, pst, jst, rtol, atol):
    h = tuple(jagent.cfg.hidden)
    jst = jax.device_get(jagent.state_to_tree(jst))
    for name, net, sd in [
            ("actor", pst.actor, actor_state_dict(jst.actor, h)),
            ("critic", pst.critic, critic_state_dict(jst.critic, h)),
            ("actor_target", pst.actor_target,
             actor_state_dict(jst.actor_target, h)),
            ("critic_target", pst.critic_target,
             critic_state_dict(jst.critic_target, h))]:
        for pname, p in net.state_dict().items():
            np.testing.assert_allclose(p.numpy(), sd[pname].numpy(),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{name}.{pname}")
    assert pst.actor_opt.count == int(jst.actor_opt[0].count)


def _one_step_pair(jagent, agent, k=2, t=4):
    """Two reference train steps; the port takes the second from the
    first's converted state with the reference's replay draws."""
    jstep = jax.jit(jagent.train_step)
    st1, _ = jstep(jagent.init(0))
    indices = _column_indices(jagent, st1, k, filled=2 * t, cursor=2 * t)
    st2, jm = jstep(st1)
    pst = ddpg_state_from_jax(
        agent, jax.device_get(jagent.state_to_tree(st1)))
    pst2, m = agent.train_step(pst, fused=False, indices=indices)
    return st2, jm, pst2, m


@pytest.mark.parametrize("agc", ["updated", "pre"])
def test_kernel_train_step_matches_jax_kernel(agc):
    """DDPG(learner='kernel') on the CPU (B3's twin through its wrapper)
    against the reference's kernel-mode train step (the Pallas kernel in
    interpret mode), from the reference's state after one step: losses
    and all four networks within the reference's own kernel-vs-XLA bar,
    rtol 2e-4, atol 1e-5."""
    jagent, agent = _agent_pair("kernel", actor_grad_critic=agc)
    assert jagent.kernel_mode and agent.kernel_mode
    st2, jm, pst2, m = _one_step_pair(jagent, agent)
    assert m["learner_impl"] == 1.0 == float(jm["learner_impl"])
    for key in ("critic_loss", "actor_loss", "reward_mean", "done_frac"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=2e-4,
                                   atol=1e-5, err_msg=key)
    _assert_state_matches(jagent, pst2, st2, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("extra", [
    dict(lr_decay_env_steps=40), dict(actor_grad_critic="pre"),
    dict(polyak_cadence="per_step"),
    dict(polyak_cadence="per_step", actor_grad_critic="pre",
         lr_decay_env_steps=40)],
    ids=["lr_decay", "pre", "per_step", "all"])
def test_plain_learner_settings_match_jax_xla(extra):
    """The plain learner with the remaining learner settings against the
    reference's XLA learner, as test_train_step_matches_jax_xla_learner:
    rtol 1e-4, atol 1e-6."""
    jagent, agent = _agent_pair("xla", **extra)
    st2, jm, pst2, m = _one_step_pair(jagent, agent)
    assert m["learner_impl"] == 0.0
    for key in ("critic_loss", "actor_loss", "reward_mean", "done_frac"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    _assert_state_matches(jagent, pst2, st2, rtol=1e-4, atol=1e-6)


def test_learner_resolution():
    env = CartPole3D(continuous_params(), num_envs=16, device="cpu")
    kw = dict(hidden=(16, 16), batch_size=16, rollout_steps=4,
              updates_per_step=1, warmup_env_steps=0,
              replay_capacity_per_env=8)
    for learner, impl in (("auto", 0.0), ("xla", 0.0), ("kernel", 1.0)):
        agent = DDPG(env, DDPGConfig(learner=learner, **kw))
        _, m = agent.train_step(agent.init(0))
        assert m["learner_impl"] == impl, learner
        assert np.isfinite(float(m["critic_loss"]))
    for bad in (dict(hidden=(16,)), dict(polyak_cadence="per_step"),
                dict(updates_per_step=0)):
        with pytest.raises(ValueError, match="not covered"):
            DDPG(env, DDPGConfig(learner="kernel", **dict(kw, **bad)))
    with pytest.raises(ValueError, match="unknown learner"):
        resolve_learner("fused", True, True)
    # The CUDA branches: auto takes B3 when covered and says so on stderr
    # (one line) when it cannot.
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert resolve_learner("auto", True, True) is True
        assert resolve_learner("xla", True, True) is False
        assert resolve_learner("auto", True, False) is False
        assert err.getvalue() == ""
        assert resolve_learner("auto", False, True) is False
    assert err.getvalue().count("\n") == 1
    assert "learner=auto resolved to the plain" in err.getvalue()


@pytest.mark.parametrize("hidden", [(8,) * 5, (1536, 1536)],
                         ids=["h8x5", "h1536x2"])
def test_kernel_learner_takes_any_torso(hidden):
    """learner="kernel" builds and trains at a depth and a width beyond
    the old caps of 4 layers and 1024 (B3's twin here)."""
    env = CartPole3D(continuous_params(), num_envs=16, device="cpu")
    agent = DDPG(env, DDPGConfig(learner="kernel", hidden=hidden,
                                 batch_size=16, rollout_steps=4,
                                 updates_per_step=1, warmup_env_steps=0,
                                 replay_capacity_per_env=8))
    assert agent.kernel_learner_ok()
    _, m = agent.train_step(agent.init(0))
    assert m["learner_impl"] == 1.0
    assert np.isfinite(float(m["critic_loss"]))


def test_flat_storage_views_and_state_dict_roundtrip():
    """Kernel mode keeps each group in one buffer: every module parameter
    and Adam moment is a view of its group's buffer, a state_dict round
    trip is exact, and loading a state_dict writes through to the
    buffer."""
    env = CartPole3D(continuous_params(), num_envs=8, device="cpu")
    agent = DDPG(env, DDPGConfig(hidden=(16, 24), learner="kernel"))
    st = agent.init(0)
    nets = (st.actor, st.critic, st.actor_target, st.critic_target)
    moments = (st.actor_opt.mu, st.actor_opt.nu, st.critic_opt.mu,
               st.critic_opt.nu)
    tensors = [list(n.parameters()) for n in nets] + [list(m)
                                                       for m in moments]
    for buf, ts in zip(st.groups, tensors):
        assert buf.is_contiguous() and buf.dim() == 1
        assert buf.numel() == sum(t.numel() for t in ts)
        off = 0
        for t in ts:
            assert t.untyped_storage().data_ptr() == \
                buf.untyped_storage().data_ptr()
            assert t.storage_offset() == off and t.is_contiguous()
            off += t.numel()
    sd = {k: v.clone() for k, v in st.actor.state_dict().items()}
    fresh = ActorMLP(env.obs_size, 2, (16, 24))
    fresh.load_state_dict(sd)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k])
    new = {k: v + 1.0 for k, v in sd.items()}
    st.actor.load_state_dict(new)
    views = lk.group_views(st.groups[0],
                           lk.actor_layout(env.obs_size, (16, 24)))
    for k, v in zip(sd, views):  # state_dict order is the layout's
        assert torch.equal(v, new[k])
    assert st.actor.torso[0].weight.untyped_storage().data_ptr() == \
        st.groups[0].untyped_storage().data_ptr()
