"""Kernel B9's plain twin (`lrpg_update_phase_math`), its wrapper on CPU
tensors, and the LRPG learner plumbing against the JAX reference on the
CPU.

Inputs come from numpy with a seed. The comparisons start from warmed Adam
moments (t0 > 0, nonzero m and v): from zero moments Adam's first step is
+-lr for any element whose gradient is rounding noise.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cartpoleplusplus_tpu import CartPole3D as JCartPole3D
from cartpoleplusplus_tpu import CartPoleParams as JCartPoleParams
from cartpoleplusplus_tpu.agents import LRPG as JLRPG
from cartpoleplusplus_tpu.agents import LRPGConfig as JLRPGConfig
from cartpoleplusplus_tpu.models import PolicyMLP as JPolicyMLP
from cartpoleplusplus_tpu.ops import learner_kernel as jlk
from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams
from cartpoleplusplus_tpu_torch.agents import LRPG, LRPGConfig
from cartpoleplusplus_tpu_torch.agents.common import resolve_learner
from cartpoleplusplus_tpu_torch.models import PolicyMLP
from cartpoleplusplus_tpu_torch.models.from_jax import policy_state_dict
from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk
from test_torch_ddpg import _perturb

F = 42
N = 128
T0 = 100
KW = dict(lr=1e-3, entropy_coef=0.1)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _trees(hidden, seed):
    """The 3 learner groups as flax trees: perturbed weights and warmed
    Adam moments (m ~ 1e-2, v ~ 1e-4)."""
    tree = JPolicyMLP(hidden=hidden).init(jax.random.PRNGKey(0),
                                          np.zeros((1, F), np.float32))
    rng = np.random.RandomState(seed)
    m = jax.tree.map(lambda x: jnp.asarray(
        rng.normal(0, 1e-2, x.shape).astype(np.float32)), tree)
    v = jax.tree.map(lambda x: jnp.asarray(
        (rng.normal(0, 1e-2, x.shape) ** 2 + 1e-5).astype(np.float32)), tree)
    return _perturb(tree, seed), m, v


def _window(seed, n=N):
    rng = np.random.RandomState(seed)
    return ((0.3 * rng.normal(size=(n, F))).astype(np.float32),
            rng.randint(0, 5, (n,)).astype(np.int32),
            rng.normal(size=(n,)).astype(np.float32))


def _port_list(tree, hidden):
    """A flax tree -> the port's parameter list (policy_layout)."""
    sd = policy_state_dict(jax.device_get(tree), hidden)
    return [sd[name] for name, _ in lk.policy_layout(F, hidden)]


def _torch_window(win):
    return tuple(torch.from_numpy(np.asarray(x)) for x in win)


def _run_port(hidden, seed):
    trees = _trees(hidden, seed)
    win = _window(seed + 10)
    got = lk.lrpg_update_phase_math(
        *[_port_list(t, hidden) for t in trees], _torch_window(win), T0,
        hidden, **KW)
    return trees, win, got


def _assert_lists_close(got, want_tree, hidden, rtol, atol, what):
    for i, (x, y) in enumerate(zip(got, _port_list(want_tree, hidden))):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=rtol,
                                   atol=atol, err_msg=f"{what} param {i}")


@pytest.mark.parametrize("hidden", [(32, 32), (24,), (16, 24, 8)],
                         ids=["h32x2", "h24", "h16-24-8"])
def test_lrpg_update_phase_math_matches_jax_grad_optax(hidden):
    """The closed-form softmax gradient + Adam against jax.grad of the
    reference agent's `_loss` + optax.adam, from warmed moments: params
    and moments within tests/test_learner_kernel.py:626's bar (rtol 2e-4,
    atol 1e-6), the loss within rtol 1e-5."""
    trees, win, got = _run_port(hidden, seed=3)
    jagent = JLRPG(JCartPole3D(JCartPoleParams(), num_envs=8),
                   JLRPGConfig(hidden=hidden, lr=KW["lr"],
                               entropy_coef=KW["entropy_coef"],
                               learner="xla"))
    params, m, v = trees
    jwin = tuple(jnp.asarray(x) for x in win)
    loss, grad = jax.value_and_grad(jagent._loss)(params, *jwin)
    adam = jagent.tx.init(params)
    opt = (adam[0]._replace(count=jnp.int32(T0), mu=m, nu=v),) \
        + tuple(adam[1:])
    upd, opt2 = jagent.tx.update(grad, opt, params)
    tol = dict(rtol=2e-4, atol=1e-6)
    _assert_lists_close(got[0], optax.apply_updates(params, upd), hidden,
                        what="params", **tol)
    _assert_lists_close(got[1], opt2[0].mu, hidden, what="m", **tol)
    _assert_lists_close(got[2], opt2[0].nu, hidden, what="v", **tol)
    np.testing.assert_allclose(float(got[3]), float(loss), rtol=1e-5)


def _jax_flat_to_port(flat, hidden):
    tree = jlk.unflatten_actor(flat, hidden, action_dim=5)
    return [t.numpy() for t in _port_list(tree, hidden)]


def _assert_groups_close(got, want_flat, hidden, rtol, atol):
    for g, (got_g, want_g) in enumerate(zip(got, want_flat)):
        for i, (x, y) in enumerate(zip(got_g,
                                       _jax_flat_to_port(want_g, hidden))):
            np.testing.assert_allclose(x.numpy(), y, rtol=rtol, atol=atol,
                                       err_msg=f"group {g} param {i}")


@pytest.mark.parametrize("hidden", [(32, 32), (24,), (16, 24, 8), (8,) * 5],
                         ids=["h32x2", "h24", "h16-24-8", "h8x5"])
def test_lrpg_update_phase_math_matches_jax_twin(hidden):
    """The torch twin against the JAX twin of the same name: all 3 groups
    within rtol 1e-5, atol 1e-7, the loss within rtol 1e-5 (float32
    matmuls of both frameworks on the CPU, summed in different orders)."""
    trees, win, got = _run_port(hidden, seed=4)
    jflat = [jlk.flatten_actor(t, hidden) for t in trees]
    want = jlk.lrpg_update_phase_math(
        *jflat, tuple(jnp.asarray(x) for x in win), jnp.int32(T0), hidden,
        num_actions=5, **KW)
    _assert_groups_close(got[:3], want[:3], hidden, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-5)


def test_lrpg_update_phase_math_matches_jax_pallas_kernel():
    """The twin against the reference's kernel B9 in interpret mode, N 128
    in blocks of 32, at the same bar."""
    hidden = (32, 32)
    trees, win, got = _run_port(hidden, seed=5)
    jflat = tuple(jlk.flatten_actor(t, hidden) for t in trees)
    run = jlk.lrpg_update_phase(hidden, F, N, num_actions=5, block_size=32,
                                interpret=True, **KW)
    new, loss = jax.jit(run)(jflat, tuple(jnp.asarray(x) for x in win),
                             jnp.int32(T0))
    _assert_groups_close(got[:3], new, hidden, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(got[3]), float(loss), rtol=1e-5)


def _flat_groups(hidden, seed):
    return [torch.cat([p.reshape(-1) for p in _port_list(t, hidden)])
            for t in _trees(hidden, seed)]


def test_wrapper_cpu_runs_twin_in_place():
    """On CPU buffers the wrapper runs the twin, writes its results into
    the 3 buffers, and does not count a launch."""
    hidden = (16, 24, 8)
    groups = _flat_groups(hidden, seed=5)
    win = _torch_window(_window(6))
    lay = lk.policy_layout(F, hidden)
    want = lk.lrpg_update_phase_math(
        *[[v.clone() for v in lk.group_views(g, lay)] for g in groups], win,
        7, hidden, **KW)
    before = lk.lrpg_update_phase.launches
    loss = lk.lrpg_update_phase(groups, win, 7, hidden, **KW)
    assert lk.lrpg_update_phase.launches == before
    for g, want_g in zip(groups, want[:3]):
        for v, w in zip(lk.group_views(g, lay), want_g):
            assert torch.equal(v, w)
    assert loss.shape == () and torch.equal(loss, want[3])


def test_wrapper_rejects_bad_arguments():
    hidden = (16, 24)
    groups = _flat_groups(hidden, seed=7)
    win = _torch_window(_window(8))
    with pytest.raises(ValueError, match="group 2"):
        lk.lrpg_update_phase(groups[:2] + [groups[2][:-1]], win, 0, hidden,
                             **KW)
    with pytest.raises(ValueError, match="3 group buffers"):
        lk.lrpg_update_phase(groups[:2], win, 0, hidden, **KW)
    with pytest.raises(ValueError, match="action"):
        lk.lrpg_update_phase(groups, (win[0], win[1].long(), win[2]), 0,
                             hidden, **KW)
    with pytest.raises(ValueError, match="advantage"):
        lk.lrpg_update_phase(groups, (win[0], win[1], win[2][:-1]), 0,
                             hidden, **KW)
    with pytest.raises(ValueError, match="strided"):
        lk.lrpg_update_phase(groups, (win[0].t().contiguous().t(),)
                             + win[1:], 0, hidden, **KW)
    with pytest.raises(ValueError, match="not covered"):
        lk.lrpg_update_phase(groups, win, 0, (), **KW)
    meta = [g.to("meta") for g in groups]
    with pytest.raises(ValueError, match="cuda or cpu"):
        lk.lrpg_update_phase(meta, win, 0, hidden, **KW)


def test_lrpg_covers_and_layout():
    """B9 takes any depth >= 1 and any width, in tiles of 64 rows: hidden
    (64, 64) keeps its weights, accumulators and tile in 171,696 bytes of
    shared memory, and so do three layers of 64 and the deep narrow
    torsos; wider networks (two layers past 84 at obs 42) take the
    workspace route."""
    assert lk.pg_tile_rows(F, (64, 64)) == 64
    assert 4 * lk.pg_smem_floats(F, (64, 64)) == 171_696
    assert lk.pg_tile_floats(F, (64, 64)) == 28_132
    assert lk.pg_tile_floats(F, (64, 64), spill=True) == 28_132 - F * 68
    for hidden in ((64, 64), (64,) * 3, (16,) * 4, (8,) * 5, (84, 84),
                   (139,), (32, 48, 16)):
        assert not lk.pg_tile_spills(F, hidden), hidden
    for hidden in ((85, 85), (140,), (66,) * 3, (256, 256), (2048, 2048),
                   (1024,) * 4):
        assert lk.lrpg_covers(F, hidden) and lk.pg_tile_spills(F, hidden)
        assert lk.pg_tile_rows(F, hidden) == 64
    assert lk.lrpg_covers(F, (8,) * 5) and lk.pg_tile_rows(F, (8,) * 5) == 64
    assert lk.lrpg_covers(F, (2048,)) and lk.lrpg_covers(F, (3,) * 12)
    assert not lk.lrpg_covers(F, ())
    net = PolicyMLP(F, 5, (16, 24, 8))
    assert [(n, tuple(p.shape)) for n, p in net.named_parameters()] == [
        (n, tuple(s)) for n, s in lk.policy_layout(F, (16, 24, 8))]


def test_b9_plan_caps_the_partial_rows():
    """B9's pass-1 plan: 128 blocks of 1024 rows (16 tiles) over the
    default window; a wide network takes fewer blocks, so that its
    workspace stays within PG_WORK_FLOATS, and on the workspace route each
    block also holds its tile there."""
    assert lk.pg_plan(F, (64, 64), 131072) == (64, 1024, 128)
    p = lk.layout_size(lk.policy_layout(F, (64, 64)))
    assert lk.pg_workspace_floats(F, (64, 64), 131072) == 128 * (p + 1)
    for hidden in ((2048, 2048), (1024,) * 4, (1024, 40)):
        rows, rpb, blocks = lk.pg_plan(F, hidden, 777)
        p = lk.layout_size(lk.policy_layout(F, hidden))
        tile = -(-lk.pg_tile_floats(F, hidden, spill=True) // 32) * 32
        assert rows == 64 and rpb % 64 == 0 and blocks * rpb >= 777
        parts = -(-blocks * (p + 1) // 32) * 32  # the tiles 128-byte aligned
        assert parts - blocks * (p + 1) < 32
        assert lk.pg_workspace_floats(F, hidden, 777) == parts + blocks * tile
        assert parts + blocks * tile <= lk.PG_WORK_FLOATS
    assert lk.pg_plan(F, (2048, 2048), 1000) == (64, 64, 16)
    assert lk.pg_plan(F, (2048, 2048), 131072) == (64, 5056, 26)


def test_learner_resolution():
    env = CartPole3D(CartPoleParams(), num_envs=16, device="cpu")
    kw = dict(hidden=(16, 16), rollout_steps=4)
    for learner, impl in (("auto", 0.0), ("xla", 0.0), ("kernel", 1.0)):
        agent = LRPG(env, LRPGConfig(learner=learner, **kw))
        st, m = agent.train_step(agent.init(0))
        assert m["learner_impl"] == impl, learner
        assert np.isfinite(float(m["loss"])) and st.opt.count == 1
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert resolve_learner("auto", True, True, "lrpg", "B9") is True
        assert err.getvalue() == ""
        assert resolve_learner("auto", False, True, "lrpg", "B9") is False
    assert err.getvalue().startswith("lrpg: learner=auto resolved to the "
                                     "plain")
    assert "kernel B9" in err.getvalue()


@pytest.mark.parametrize("hidden", [(8,) * 5, (2048,)], ids=["h8x5", "h2048"])
def test_kernel_learner_takes_any_torso(hidden):
    """learner="kernel" builds and trains at a depth beyond the old cap of
    4 layers, and at a width on the workspace route (B9's twin here)."""
    env = CartPole3D(CartPoleParams(), num_envs=16, device="cpu")
    agent = LRPG(env, LRPGConfig(learner="kernel", hidden=hidden,
                                 rollout_steps=4))
    assert agent.kernel_learner_ok()
    st, m = agent.train_step(agent.init(0))
    assert m["learner_impl"] == 1.0
    assert np.isfinite(float(m["loss"])) and st.opt.count == 1


def test_flat_storage_views():
    """Kernel mode keeps each group in one buffer: every policy parameter
    and Adam moment is a view of its group's buffer, and an update through
    the wrapper moves the module's parameters."""
    env = CartPole3D(CartPoleParams(), num_envs=8, device="cpu")
    agent = LRPG(env, LRPGConfig(hidden=(16, 24), rollout_steps=4,
                                 learner="kernel"))
    st = agent.init(0)
    tensors = [list(st.policy.parameters()), list(st.opt.mu),
               list(st.opt.nu)]
    assert len(st.groups) == 3
    for buf, ts in zip(st.groups, tensors):
        assert buf.is_contiguous() and buf.dim() == 1
        assert buf.numel() == sum(t.numel() for t in ts)
        off = 0
        for t in ts:
            assert t.untyped_storage().data_ptr() == \
                buf.untyped_storage().data_ptr()
            assert t.storage_offset() == off
            off += t.numel()
    before = st.policy.head.weight.detach().clone()
    st, _ = agent.train_step(st)
    assert not torch.equal(before, st.policy.head.weight.detach())
    assert float(st.groups[1].abs().max()) > 0.0  # the moments moved
