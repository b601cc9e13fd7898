"""Kernel B7's plain twin (`naf_update_phase_math`), its wrapper on CPU
tensors, and the NAF learner plumbing against the JAX reference on the CPU.

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

from cartpoleplusplus_tpu.models import NafNet as JNafNet
from cartpoleplusplus_tpu.ops import learner_kernel as jlk
from cartpoleplusplus_tpu_torch import CartPole3D
from cartpoleplusplus_tpu_torch.agents import NAF, NAFConfig
from cartpoleplusplus_tpu_torch.agents.common import resolve_learner
from cartpoleplusplus_tpu_torch.models import NafNet
from cartpoleplusplus_tpu_torch.models.from_jax import (naf_state_dict,
                                                         unflatten_naf)
from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk
from cartpoleplusplus_tpu_torch.physics.params import continuous_params

F = 42
K = 3
BM = 64
LRS = dict(lr=1e-3, gamma=0.99, tau=0.05)
SCHED = (0.1, 50)
# A max norm below every update's gradient norm at these inputs (the
# twin's norms are 1.6-4.4; 10.0 never fires here): the clip fires in
# every update.
FIRING = 0.2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _trees(hidden, seed):
    """The 4 learner groups as flax trees: weights and target drawn near
    unit size from a numpy seed (the head at 0.5 / sqrt(H), as chip_smoke
    draws it), and warmed Adam moments (m ~ 1e-2, v ~ 1e-4)."""
    obs0, act0 = np.zeros((1, F), np.float32), np.zeros((1, 2), np.float32)
    tree = JNafNet(hidden=hidden).init(jax.random.PRNGKey(0), obs0, act0)
    rng = np.random.RandomState(seed)

    def draw(path, x):
        head = path[1].key.startswith("Dense")
        scale = 0.5 / hidden[-1] ** 0.5 if head else 0.5
        return jnp.asarray(rng.normal(0, scale, x.shape).astype(np.float32))

    net = jax.tree_util.tree_map_with_path(draw, tree)
    target = jax.tree.map(lambda x: x + jnp.asarray(
        rng.normal(0, 0.01, x.shape).astype(np.float32)), net)
    m = jax.tree.map(lambda x: jnp.asarray(
        rng.normal(0, 1e-2, x.shape).astype(np.float32)), tree)
    v = jax.tree.map(lambda x: jnp.asarray(
        (rng.normal(0, 1e-2, x.shape) ** 2 + 1e-5).astype(np.float32)), tree)
    return net, target, m, v


def _batches(seed, k=K, bm=BM):
    rng = np.random.RandomState(seed)
    obs = (0.3 * rng.normal(size=(k, bm, F))).astype(np.float32)
    return (obs, rng.uniform(-1, 1, (k, bm, 2)).astype(np.float32),
            rng.uniform(size=(k, bm)).astype(np.float32),
            (obs + 0.05 * rng.normal(size=obs.shape)).astype(np.float32),
            rng.uniform(size=(k, bm)) < 0.1)


def _port_list(tree, hidden):
    """A flax tree -> the port's parameter list (naf_layout)."""
    sd = naf_state_dict(jax.device_get(tree), hidden)
    return [sd[name] for name, _ in lk.naf_layout(F, hidden)]


def _assert_groups_close(got, want_flat, hidden, rtol, atol):
    for g, (got_g, want_g) in enumerate(zip(got, want_flat)):
        want_l = _port_list(unflatten_naf(want_g, hidden), hidden)
        for i, (x, y) in enumerate(zip(got_g, want_l)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=rtol,
                                       atol=atol,
                                       err_msg=f"group {g} param {i}")


def _run_both(hidden, clip, seed, sched=SCHED):
    trees = _trees(hidden, seed)
    bat = _batches(seed + 10)
    jflat = [jlk.flatten_naf(t, hidden) for t in trees]
    got = lk.naf_update_phase_math(
        *[_port_list(t, hidden) for t in trees],
        tuple(torch.from_numpy(np.asarray(x)) for x in bat), 40, hidden,
        max_grad_norm=clip, lr_schedule=sched, **LRS)
    return jflat, bat, got


@pytest.mark.parametrize("clip", [10.0, 0.0, FIRING],
                         ids=["clip10", "noclip", "firing"])
@pytest.mark.parametrize("hidden", [(32, 32), (16, 24, 8), (24,), (8,) * 5,
                                    (2048,)],
                         ids=["h32x2", "h16-24-8", "h24", "h8x5", "h2048"])
def test_naf_update_phase_math_matches_jax(hidden, clip):
    """K = 3 updates of the torch twin against the JAX twin with the lr
    schedule on: all 4 groups and the loss vector within rtol 1e-5, atol
    1e-6 (float32 matmuls of both frameworks on the CPU, summed in
    different orders)."""
    jflat, bat, got = _run_both(hidden, clip, seed=3)
    want = jlk.naf_update_phase_math(
        *jflat, tuple(jnp.asarray(x) for x in bat), jnp.int32(40), hidden,
        max_grad_norm=clip, lr_schedule=SCHED, **LRS)
    _assert_groups_close(got[:4], want[:4], hidden, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               rtol=1e-5, atol=1e-6)
    assert float(got[4][0]) > 0.0
    if clip == FIRING:
        assert bool((got[5] > FIRING).all()), got[5]


def test_the_clip_changes_the_update():
    """The bar above separates a firing clip from none, and the twin's
    10.0 from none where the norms stay below it."""
    hidden = (32, 32)
    _, _, a = _run_both(hidden, 0.0, seed=3)
    _, _, b = _run_both(hidden, FIRING, seed=3)
    _, _, c = _run_both(hidden, 10.0, seed=3)
    assert bool((a[5] < 10.0).all())
    assert float((a[0][0] - b[0][0]).abs().max()) > 1e-5
    assert all(torch.equal(x, y) for x, y in zip(a[0], c[0]))


def test_naf_update_phase_math_matches_jax_pallas_kernel():
    """The twin against the reference's kernel B7 in interpret mode with
    the clip firing and the lr schedule on, at rtol 1e-5, atol 1e-6 (the
    reference's own bar for kernel against twin is 1e-5 / 1e-7 on its
    padded layout; the port's sums run in another order)."""
    hidden = (32, 32)
    jflat, bat, got = _run_both(hidden, FIRING, seed=5)
    run = jlk.naf_update_phase(hidden, F, K, BM, max_grad_norm=FIRING,
                               block_size=BM, interpret=True,
                               lr_schedule=SCHED, **LRS)
    new, loss = jax.jit(run)(tuple(jflat),
                             tuple(jnp.asarray(x) for x in bat),
                             jnp.int32(40))
    _assert_groups_close(got[:4], new, hidden, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(loss), rtol=1e-5,
                               atol=1e-6)


def test_kernel_learner_q_reads_raw_mu():
    """The reference kernel's Q (`naf_q`, twinned here) takes mu as the
    head's raw rows 1-2, where NafNet applies tanh: the two agree once the
    twin is handed tanh(mu), and differ visibly for a mu head away from
    its U[0, 3e-3) init. So the kernel learner and the plain learner are
    different arithmetic, in the reference as in the port."""
    net = NafNet(F, 2, (32, 32), generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    obs = torch.from_numpy(rng.normal(0, 1, (64, F)).astype(np.float32))
    act = torch.from_numpy(rng.uniform(-1, 1, (64, 2)).astype(np.float32))
    with torch.no_grad():
        q_net = net(obs, act)[0]
        pre = net.head(net.features(obs))
        assert float((pre[:, 1:3].abs()).max()) < 0.1  # init: tanh ~ id
        np.testing.assert_allclose(lk.naf_q(pre, act)[0][:, 0].numpy(),
                                   q_net.numpy(), rtol=1e-4, atol=1e-4)
        net.head.weight[1:3].normal_(0, 0.5)
        q_net = net(obs, act)[0]
        pre = net.head(net.features(obs))
        tanh_pre = torch.cat([pre[:, :1], torch.tanh(pre[:, 1:3]),
                              pre[:, 3:]], dim=1)
        np.testing.assert_allclose(lk.naf_q(tanh_pre, act)[0][:, 0].numpy(),
                                   q_net.numpy(), rtol=1e-5, atol=1e-5)
        assert float((lk.naf_q(pre, act)[0][:, 0] - q_net).abs().max()) > 0.1


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
    lay = lk.naf_layout(F, hidden)
    kw = dict(LRS, max_grad_norm=FIRING, lr_schedule=SCHED)
    want = lk.naf_update_phase_math(
        *[[v.clone() for v in lk.group_views(g, lay)] for g in groups], bat,
        7, hidden, **kw)
    before = lk.naf_update_phase.launches
    loss = lk.naf_update_phase(groups, bat, 7, hidden, **kw)
    assert lk.naf_update_phase.launches == before
    for g, want_g in zip(groups, want[:4]):
        for v, w in zip(lk.group_views(g, lay), want_g):
            assert torch.equal(v, w)
    assert torch.equal(loss, want[4])


def test_wrapper_rejects_bad_arguments():
    hidden = (16, 24)
    groups = _flat_groups(hidden, seed=7)
    bat = _torch_batches(seed=8)
    kw = dict(LRS, max_grad_norm=10.0)
    with pytest.raises(ValueError, match="group 1"):
        lk.naf_update_phase([groups[0], groups[1][:-1]] + groups[2:], bat, 0,
                            hidden, **kw)
    with pytest.raises(ValueError, match="4 group buffers"):
        lk.naf_update_phase(groups[:3], bat, 0, hidden, **kw)
    with pytest.raises(ValueError, match="action"):
        lk.naf_update_phase(groups, (bat[0], bat[1][..., :1]) + bat[2:], 0,
                            hidden, **kw)
    with pytest.raises(ValueError, match="strided"):
        lk.naf_update_phase(groups, (bat[0].transpose(0, 1).contiguous()
                                     .transpose(0, 1),) + bat[1:], 0,
                            hidden, **kw)
    with pytest.raises(ValueError, match="not covered"):
        lk.naf_update_phase(groups, bat, 0, (), **kw)
    meta = [g.to("meta") for g in groups]
    with pytest.raises(ValueError, match="cuda or cpu"):
        lk.naf_update_phase(meta, bat, 0, hidden, **kw)


def test_naf_covers_and_layout():
    """B7 takes any torso of at least one layer, as the reference's
    kernel: any depth, and any width (a row tile's buffers go to the
    workspace past a layer of 2449)."""
    assert lk.naf_covers(F, (256, 256)) and lk.naf_covers(F, (64,))
    assert lk.naf_covers(F, (8,) * 4) and lk.naf_covers(F, (8,) * 5)
    assert lk.naf_covers(F, (2048,)) and lk.naf_covers(F, (3,) * 12)
    assert not lk.naf_covers(F, ())
    net = NafNet(F, 2, (16, 24, 8))
    assert [(n, tuple(p.shape)) for n, p in net.named_parameters()] == [
        (n, tuple(s)) for n, s in lk.naf_layout(F, (16, 24, 8))]


def test_b7_plan_and_workspace():
    """B7's plan on the row chains: forward items of 4 batch rows (the
    target on s' and the online net on s: 128 at the NAF defaults),
    backward items of 4 rows (64); 123,056 bytes of shared memory a block
    at the defaults (the weight ring, a row tile's buffers, the device
    table), the buffers in the workspace past one layer of 2449 at obs 42
    or when asked; the workspace holds the gradient stage's rows, the
    head rows and their gradients, the flat gradient of a clipped update
    with its 256 slices' sums and counts and, on the spill route, every
    item's buffers of the larger stage."""
    hid = (256, 256)
    assert lk.naf_plan(F, hid, 256) == (4, (128, 64), False, 123056)
    assert lk.naf_plan(F, hid, 200) == (4, (100, 50), False, 123056)
    assert lk.naf_plan(F, hid, 256, spill=True) == (
        4, (128, 64), True, 4 * (3 * 256 * 36 + 32 + 12))
    assert not lk.naf_plan(F, (2449,), 256)[2]
    assert lk.naf_plan(F, (2450,), 256)[2] and lk.naf_plan(F, (4096,), 256)[2]
    assert not lk.naf_plan(F, (8,) * 5, 256)[2]
    size = lk.layout_size(lk.naf_layout(F, hid))
    assert size == 79366
    rows = (4 * 256 * 512 + 256 * 256 + 256 * 256 + 2 * 256 + 2 * 256 * 6
            + 79392 + 2 * 256)
    assert lk.naf_workspace_floats(F, hid, 256) == rows
    assert lk.naf_workspace_floats(F, hid, 256, spill=True) == (
        rows + 128 * (8 * 256 + 4 * 256))
    small = lk.layout_size(lk.naf_layout(F, (8,) * 5))
    assert lk.naf_workspace_floats(F, (8,) * 5, 200) == (
        4 * 200 * 40 + 200 * 32 + 200 * 8 + 2 * 224 + 2 * 1216
        + -(-small // 32) * 32 + 512)


def test_learner_resolution():
    """The NAF default is the plain learner, as in the reference; "kernel"
    takes B7's wrapper (its twin here) and raises where B7 does not
    cover the config; "auto" takes the plain learner off a GPU."""
    assert NAFConfig().learner == "xla"
    env = CartPole3D(continuous_params(), num_envs=16)
    kw = dict(hidden=(16, 16), batch_size=16, rollout_steps=4,
              updates_per_step=1, warmup_env_steps=0,
              replay_capacity_per_env=8)
    for learner, impl in (("auto", 0.0), ("xla", 0.0), ("kernel", 1.0)):
        agent = NAF(env, NAFConfig(learner=learner, **kw))
        _, m = agent.train_step(agent.init(0))
        assert m["learner_impl"] == impl, learner
        assert np.isfinite(float(m["loss"])) and float(m["loss"]) > 0.0
    for bad in (dict(hidden=()), dict(updates_per_step=0)):
        with pytest.raises(ValueError, match="not covered by the fused "
                                             "update kernel B7"):
            NAF(env, NAFConfig(learner="kernel", **dict(kw, **bad)))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert resolve_learner("auto", False, True, "naf", "B7") is False
    assert err.getvalue().startswith("naf: learner=auto resolved to the "
                                     "plain")
    assert "kernel B7" in err.getvalue()


@pytest.mark.parametrize("hidden", [(8,) * 5, (2048,)], ids=["h8x5", "h2048"])
def test_kernel_learner_takes_any_torso(hidden):
    """learner="kernel" builds and trains at a depth and a width beyond
    the old caps of 4 layers and 1024 (B7's twin here)."""
    env = CartPole3D(continuous_params(), num_envs=16)
    agent = NAF(env, NAFConfig(learner="kernel", hidden=hidden,
                               batch_size=16, rollout_steps=4,
                               updates_per_step=1, warmup_env_steps=0,
                               replay_capacity_per_env=8))
    assert agent.kernel_learner_ok()
    _, m = agent.train_step(agent.init(0))
    assert m["learner_impl"] == 1.0
    assert np.isfinite(float(m["loss"])) and float(m["loss"]) > 0.0


def test_flat_storage_views():
    """Kernel mode keeps each group in one buffer: every NafNet parameter,
    target parameter and Adam moment is a view of its group's buffer, and
    loading a state_dict writes through to the buffer."""
    env = CartPole3D(continuous_params(), num_envs=8)
    agent = NAF(env, NAFConfig(hidden=(16, 24), learner="kernel"))
    st = agent.init(0)
    tensors = [list(st.net.parameters()), list(st.target.parameters()),
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
    new = {k: v + 1.0 for k, v in st.net.state_dict().items()}
    st.net.load_state_dict(new)
    for k, v in zip(new, lk.group_views(st.groups[0],
                                        lk.naf_layout(F, (16, 24)))):
        assert torch.equal(v, new[k])
