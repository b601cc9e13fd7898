"""Kernel B5's plain twin (`dqn_update_phase_math`), its wrapper on CPU
tensors, and the DQN learner plumbing against the JAX reference on the CPU.

Inputs come from numpy with a seed. The comparisons start from warmed Adam
moments (t0 > 0, nonzero m and v): from zero moments Adam's first step is
+-lr for any element whose gradient is rounding noise.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu.models import QNetMLP as JQNetMLP
from cartpoleplusplus_tpu.ops import learner_kernel as jlk
from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams
from cartpoleplusplus_tpu_torch.agents import DQN, DQNConfig
from cartpoleplusplus_tpu_torch.agents.common import resolve_learner
from cartpoleplusplus_tpu_torch.models import QNetMLP
from cartpoleplusplus_tpu_torch.models.from_jax import qnet_state_dict
from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk
from test_torch_ddpg import _perturb

F = 42
K = 3
BM = 64
LRS = dict(lr=1e-3, gamma=0.99, tau=0.05)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _trees(hidden, seed):
    """The 4 learner groups as flax trees: perturbed weights and target,
    and warmed Adam moments (m ~ 1e-2, v ~ 1e-4)."""
    tree = JQNetMLP(hidden=hidden).init(jax.random.PRNGKey(0),
                                        np.zeros((1, F), np.float32))
    rng = np.random.RandomState(seed)
    m = jax.tree.map(lambda x: jnp.asarray(
        rng.normal(0, 1e-2, x.shape).astype(np.float32)), tree)
    v = jax.tree.map(lambda x: jnp.asarray(
        (rng.normal(0, 1e-2, x.shape) ** 2 + 1e-5).astype(np.float32)), tree)
    return _perturb(tree, seed), _perturb(tree, seed + 1), m, v


def _batches(seed, k=K, bm=BM):
    rng = np.random.RandomState(seed)
    obs = (0.3 * rng.normal(size=(k, bm, F))).astype(np.float32)
    return (obs, rng.randint(0, 5, (k, bm)).astype(np.int32),
            rng.uniform(size=(k, bm)).astype(np.float32),
            (obs + 0.05 * rng.normal(size=obs.shape)).astype(np.float32),
            rng.uniform(size=(k, bm)) < 0.1)


def _port_list(tree, hidden):
    """A flax tree -> the port's parameter list (qnet_layout)."""
    sd = qnet_state_dict(jax.device_get(tree), hidden)
    return [sd[name] for name, _ in lk.qnet_layout(F, hidden)]


def _jax_flat_to_port(flat, hidden):
    tree = jlk.unflatten_actor(flat, hidden, action_dim=5)
    return [t.numpy() for t in _port_list(tree, hidden)]


def _assert_groups_close(got, want_flat, hidden, rtol, atol):
    for g, (got_g, want_g) in enumerate(zip(got, want_flat)):
        for i, (x, y) in enumerate(zip(got_g,
                                       _jax_flat_to_port(want_g, hidden))):
            np.testing.assert_allclose(x.numpy(), y, rtol=rtol, atol=atol,
                                       err_msg=f"group {g} param {i}")


def _run_both(hidden, double_dqn, seed):
    trees = _trees(hidden, seed)
    bat = _batches(seed + 10)
    jflat = [jlk.flatten_actor(t, hidden) for t in trees]
    got = lk.dqn_update_phase_math(
        *[_port_list(t, hidden) for t in trees],
        tuple(torch.from_numpy(np.asarray(x)) for x in bat), 40, hidden,
        double_dqn=double_dqn, **LRS)
    return jflat, bat, got


@pytest.mark.parametrize("double_dqn", [True, False], ids=["double", "max"])
@pytest.mark.parametrize("hidden", [(32, 32), (16, 24, 8), (24,), (8,) * 5,
                                    (2048,)],
                         ids=["h32x2", "h16-24-8", "h24", "h8x5", "h2048"])
def test_dqn_update_phase_math_matches_jax(hidden, double_dqn):
    """K = 3 updates of the torch twin against the JAX twin: all 4 groups
    and the loss vector within rtol 1e-5, atol 1e-6 (float32 matmuls of
    both frameworks on the CPU, summed in different orders; measured
    1.2e-7 on the groups and 2.4e-7 on the losses)."""
    jflat, bat, got = _run_both(hidden, double_dqn, seed=3)
    want = jlk.dqn_update_phase_math(
        *jflat, tuple(jnp.asarray(x) for x in bat), jnp.int32(40), hidden,
        double_dqn=double_dqn, **LRS)
    _assert_groups_close(got[:4], want[:4], hidden, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               rtol=1e-5, atol=1e-6)
    assert float(got[4][0]) > 0.0


@pytest.mark.parametrize("double_dqn", [True, False], ids=["double", "max"])
def test_dqn_update_phase_math_matches_jax_pallas_kernel(double_dqn):
    """The twin against the reference's kernel B5 in interpret mode, at
    the same bar (rtol 1e-5, atol 1e-6)."""
    hidden = (32, 32)
    jflat, bat, got = _run_both(hidden, double_dqn, seed=5)
    run = jlk.dqn_update_phase(hidden, F, K, BM, double_dqn=double_dqn,
                               block_size=BM, interpret=True, **LRS)
    new, loss = jax.jit(run)(tuple(jflat),
                             tuple(jnp.asarray(x) for x in bat),
                             jnp.int32(40))
    _assert_groups_close(got[:4], new, hidden, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(loss), rtol=1e-5,
                               atol=1e-6)


def test_double_dqn_changes_the_update():
    """The bar above separates double DQN from the max target."""
    hidden = (32, 32)
    _, _, a = _run_both(hidden, True, seed=3)
    _, _, b = _run_both(hidden, False, seed=3)
    assert float((a[4] - b[4]).abs().max()) > 1e-4


def _flat_groups(hidden, seed):
    return [torch.cat([p.reshape(-1) for p in _port_list(t, hidden)])
            for t in _trees(hidden, seed)]


def _torch_batches(seed):
    return tuple(torch.from_numpy(np.asarray(x)) for x in _batches(seed))


def test_wrapper_cpu_runs_twin_in_place():
    """On CPU buffers the wrapper runs the twin, writes its results into
    the buffers, and does not count a launch."""
    hidden = (16, 24, 8)
    groups = _flat_groups(hidden, seed=5)
    bat = _torch_batches(seed=6)
    lay = lk.qnet_layout(F, hidden)
    want = lk.dqn_update_phase_math(
        *[[v.clone() for v in lk.group_views(g, lay)] for g in groups], bat,
        7, hidden, **LRS)
    before = lk.dqn_update_phase.launches
    loss = lk.dqn_update_phase(groups, bat, 7, hidden, **LRS)
    assert lk.dqn_update_phase.launches == before
    for g, want_g in zip(groups, want[:4]):
        for v, w in zip(lk.group_views(g, lay), want_g):
            assert torch.equal(v, w)
    assert torch.equal(loss, want[4])


def test_wrapper_rejects_bad_arguments():
    hidden = (16, 24)
    groups = _flat_groups(hidden, seed=7)
    bat = _torch_batches(seed=8)
    with pytest.raises(ValueError, match="group 1"):
        lk.dqn_update_phase([groups[0], groups[1][:-1]] + groups[2:], bat, 0,
                            hidden, **LRS)
    with pytest.raises(ValueError, match="4 group buffers"):
        lk.dqn_update_phase(groups[:3], bat, 0, hidden, **LRS)
    with pytest.raises(ValueError, match="action"):
        lk.dqn_update_phase(groups, (bat[0], bat[1].long()) + bat[2:], 0,
                            hidden, **LRS)
    with pytest.raises(ValueError, match="strided"):
        lk.dqn_update_phase(groups, (bat[0].transpose(0, 1).contiguous()
                                     .transpose(0, 1),) + bat[1:], 0,
                            hidden, **LRS)
    with pytest.raises(ValueError, match="not covered"):
        lk.dqn_update_phase(groups, bat, 0, (), **LRS)
    meta = [g.to("meta") for g in groups]
    with pytest.raises(ValueError, match="cuda or cpu"):
        lk.dqn_update_phase(meta, bat, 0, hidden, **LRS)


def test_dqn_covers_and_layout():
    """B5 takes any torso of at least one layer, as the reference's
    kernel: any depth, and any width (a wide layer's row tiles keep their
    buffers in the workspace)."""
    assert lk.dqn_covers(F, (256, 256)) and lk.dqn_covers(F, (64,))
    assert lk.dqn_covers(F, (8,) * 4) and lk.dqn_covers(F, (8,) * 5)
    assert lk.dqn_covers(F, (2048,)) and lk.dqn_covers(F, (3,) * 12)
    assert not lk.dqn_covers(F, ())
    q = QNetMLP(F, 5, (16, 24, 8))
    assert [(n, tuple(p.shape)) for n, p in q.named_parameters()] == [
        (n, tuple(s)) for n, s in lk.qnet_layout(F, (16, 24, 8))]


def test_b5_plan_and_workspace():
    """B5's plan: forward items of one pass over 8 batch rows (96 at the
    DQN defaults, 3 passes x 32 tiles), their buffers in shared memory up
    to one layer of 1468 at obs 42 and in the workspace past it or when
    asked; the workspace holds the gradient stage's rows, the passes' Q
    values and, on the spill route, every forward item's buffers."""
    assert lk.dqn_plan(F, (256, 256), 256) == (8, 96, False)
    assert lk.dqn_plan(F, (256, 256), 200) == (8, 75, False)
    assert lk.dqn_plan(F, (256, 256), 256, spill=True) == (8, 96, True)
    assert not lk.dqn_plan(F, (1468,), 256)[2]
    assert lk.dqn_plan(F, (1469,), 256)[2] and lk.dqn_plan(F, (2048,), 256)[2]
    assert not lk.dqn_plan(F, (8,) * 5, 256)[2]
    rows = (4 * 256 * 512 + 256 * 256 + 256 * 256 + 256 * 5 + 256
            + 3 * 256 * 5)
    assert lk.dqn_workspace_floats(F, (256, 256), 256) == rows
    tile = 12 * 256 + 8 * 256
    assert lk.dqn_workspace_floats(F, (256, 256), 256, spill=True) == (
        rows + 96 * tile)
    assert lk.dqn_workspace_floats(F, (8,) * 5, 200) == (
        4 * 200 * 40 + 200 * 32 + 200 * 8 + 1024 + 224 + 3008)


def test_learner_resolution():
    env = CartPole3D(CartPoleParams(), num_envs=16)
    kw = dict(hidden=(16, 16), batch_size=16, rollout_steps=4,
              updates_per_step=1, warmup_env_steps=0,
              replay_capacity_per_env=8)
    for learner, impl in (("auto", 0.0), ("xla", 0.0), ("kernel", 1.0)):
        agent = DQN(env, DQNConfig(learner=learner, **kw))
        _, m = agent.train_step(agent.init(0))
        assert m["learner_impl"] == impl, learner
        assert np.isfinite(float(m["loss"])) and float(m["loss"]) > 0.0
    for bad in (dict(hidden=()), dict(updates_per_step=0)):
        with pytest.raises(ValueError, match="not covered by the fused "
                                             "update kernel B5"):
            DQN(env, DQNConfig(learner="kernel", **dict(kw, **bad)))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert resolve_learner("auto", True, True, "dqn", "B5") is True
        assert err.getvalue() == ""
        assert resolve_learner("auto", False, True, "dqn", "B5") is False
    assert err.getvalue().count("\n") == 1
    assert err.getvalue().startswith("dqn: learner=auto resolved to the "
                                     "plain")
    assert "kernel B5" in err.getvalue()


@pytest.mark.parametrize("hidden", [(8,) * 5, (2048,)], ids=["h8x5", "h2048"])
def test_kernel_learner_takes_any_torso(hidden):
    """learner="kernel" builds and trains at a depth and a width beyond
    the old caps of 4 layers and 1024 (B5's twin here)."""
    env = CartPole3D(CartPoleParams(), num_envs=16)
    agent = DQN(env, DQNConfig(learner="kernel", hidden=hidden,
                               batch_size=16, rollout_steps=4,
                               updates_per_step=1, warmup_env_steps=0,
                               replay_capacity_per_env=8))
    assert agent.kernel_learner_ok()
    _, m = agent.train_step(agent.init(0))
    assert m["learner_impl"] == 1.0
    assert np.isfinite(float(m["loss"])) and float(m["loss"]) > 0.0


def test_flat_storage_views():
    """Kernel mode keeps each group in one buffer: every Q-net parameter,
    target parameter and Adam moment is a view of its group's buffer, and
    loading a state_dict writes through to the buffer."""
    env = CartPole3D(CartPoleParams(), num_envs=8)
    agent = DQN(env, DQNConfig(hidden=(16, 24), learner="kernel"))
    st = agent.init(0)
    tensors = [list(st.q.parameters()), list(st.q_target.parameters()),
               list(st.opt.mu), list(st.opt.nu)]
    assert len(st.groups) == 4
    for buf, ts in zip(st.groups, tensors):
        assert buf.is_contiguous() and buf.dim() == 1
        assert buf.numel() == sum(t.numel() for t in ts)
        off = 0
        for t in ts:
            assert t.untyped_storage().data_ptr() == \
                buf.untyped_storage().data_ptr()
            assert t.storage_offset() == off
            off += t.numel()
    new = {k: v + 1.0 for k, v in st.q.state_dict().items()}
    st.q.load_state_dict(new)
    for k, v in zip(new, lk.group_views(st.groups[0],
                                        lk.qnet_layout(F, (16, 24)))):
        assert torch.equal(v, new[k])
