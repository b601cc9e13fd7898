"""Kernels B1 to B11 against their plain torch twins on a CUDA GPU.

These need the card and skip elsewhere. The GPU machine has no JAX, so run
them there without tests/conftest.py (which imports it):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

This file imports no JAX. Batches of 1000 envs leave a ragged last tile,
B3's and B5's minibatch of 200 rows a ragged last row tile, and B9's
windows of 1000 and 777 rows a ragged last tile.
"""

import contextlib
import io
import json

import pytest
import torch

from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams
from cartpoleplusplus_tpu_torch import train
from cartpoleplusplus_tpu_torch.models import (ActorMLP, CriticMLP, NafNet,
                                               PolicyMLP, QNetMLP)
from cartpoleplusplus_tpu_torch.ops import _native
from cartpoleplusplus_tpu_torch.ops import fused_rollout as fr
from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk
from cartpoleplusplus_tpu_torch.ops import naf_rollout as nr
from cartpoleplusplus_tpu_torch.ops import pg_rollout as pg
from cartpoleplusplus_tpu_torch.ops import policy_rollout as pr
from cartpoleplusplus_tpu_torch.ops import q_rollout as qr
from cartpoleplusplus_tpu_torch.physics.params import continuous_params

pytestmark = pytest.mark.cuda

B = 1000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("params", [CartPoleParams(), continuous_params()],
                         ids=["discrete", "continuous"])
def test_b1_matches_twin(cuda, params):
    env = CartPole3D(params, num_envs=B, device=cuda)
    state, _ = env.reset(5)
    before = fr.fused_rollout.launches
    k_state, k_acc = fr.fused_rollout(env, state, 25)
    r_state, r_acc = fr.reference_rollout(env, state, 25)
    assert fr.fused_rollout.launches == before + 1
    # tests/test_ops.py's kernel-vs-twin tolerances.
    for name, tol in (("pos", 2e-5), ("s", 2e-5), ("vel", 5e-4),
                      ("sd", 5e-4)):
        torch.testing.assert_close(getattr(k_state.phys, name),
                                   getattr(r_state.phys, name), rtol=tol,
                                   atol=tol)
    assert torch.equal(k_state.steps, r_state.steps)
    assert torch.equal(k_state.episode, r_state.episode)
    assert abs(float(k_acc) - float(r_acc)) / abs(float(r_acc)) < 1e-4


def _random_actor(dev, hidden, seed):
    """An actor with its head redrawn at 0.5 (the U[0, 3e-3) init would
    hide torso errors)."""
    g = torch.Generator().manual_seed(seed)
    actor = ActorMLP(42, 2, hidden, generator=g)
    with torch.no_grad():
        for prm in actor.head.parameters():
            prm.copy_(0.5 * torch.randn(prm.shape, generator=g))
    return actor.to(dev)


@pytest.mark.parametrize("hidden", [(256, 256), (64,), (32, 48, 16), (2048,),
                                    (8,) * 5])
def test_b2_matches_twin(cuda, hidden):
    """tests/test_policy_rollout.py's tolerances (rtol 2e-4, atol 2e-5)
    on the trajectory, final state, obs and noise; dones, steps and
    episodes exact; one counted launch. (2048,) keeps its activations in
    the workspace, (8,) * 5 is deeper than the old cap of 4 layers."""
    env = CartPole3D(continuous_params(), num_envs=B, device=cuda)
    state, obs = env.reset(9)
    actor = _random_actor(cuda, hidden, seed=1)
    noise = torch.zeros((B, 2), device=cuda)
    args = (env, actor, 0.15, state, obs, noise, 7, 0.2, 3)
    before = pr.policy_rollout.launches
    k = pr.policy_rollout(*args)
    torch.cuda.synchronize()
    assert pr.policy_rollout.launches == before + 1
    r = pr.reference_policy_rollout(*args)
    # tests/test_policy_rollout.py's tolerances.
    for a, b in zip(k[3][:3], r[3][:3]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
    assert torch.equal(k[3][3], r[3][3])
    for a, b in zip((*k[0].phys, k[1], k[2]), (*r[0].phys, r[1], r[2])):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
    assert torch.equal(k[0].steps, r[0].steps)
    assert torch.equal(k[0].episode, r[0].episode)


def test_b2_rejects_uncovered_shapes(cuda):
    """An empty torso, state obs and the discrete env: what the reference's
    `fusable` rejects too."""
    noise = torch.zeros((64, 2), device=cuda)
    env = CartPole3D(continuous_params(), num_envs=64, device=cuda)
    with pytest.raises(ValueError, match="not covered by the B2"):
        pr.policy_rollout(env, ActorMLP(42, 2, ()).to(cuda), 0.15,
                          *env.reset(0), noise, 0, 0.2, 2)
    flat = CartPole3D(continuous_params(), num_envs=64, obs_mode="state",
                      device=cuda)
    with pytest.raises(ValueError, match="not covered by the B2"):
        pr.policy_rollout(flat, ActorMLP(flat.obs_size, 2, (32,)).to(cuda),
                          0.15, *flat.reset(0), noise, 0, 0.2, 2)
    disc = CartPole3D(CartPoleParams(), num_envs=64, device=cuda)
    with pytest.raises(ValueError, match="not covered by the B2"):
        pr.policy_rollout(disc, ActorMLP(42, 2, (32,)).to(cuda), 0.15,
                          *disc.reset(0), noise, 0, 0.2, 2)


def _b3_inputs(dev, hidden, batch, k, seed):
    """Group buffers (nets with redrawn LayerNorm parameters and heads,
    targets near them, warmed Adam moments) and K minibatches."""
    g = torch.Generator().manual_seed(seed)

    def flat(net):
        with torch.no_grad():
            for prm in list(net.norms.parameters()) + list(
                    net.head.parameters()):
                prm.add_(0.2 * torch.randn(prm.shape, generator=g))
        return torch.cat([p.detach().reshape(-1) for p in net.parameters()])

    nets = (flat(ActorMLP(42, 2, hidden, generator=g)),
            flat(CriticMLP(42, 2, hidden, generator=g)))
    groups = list(nets) + [x + 0.01 * torch.randn(x.shape, generator=g)
                           for x in nets]
    for x in nets:  # m ~ 1e-2, v ~ 1e-4
        groups += [1e-2 * torch.randn(x.shape, generator=g),
                   (1e-2 * torch.randn(x.shape, generator=g)) ** 2 + 1e-5]
    obs = 0.3 * torch.randn((k, batch, 42), generator=g)
    batches = (obs, torch.rand((k, batch, 2), generator=g) * 2 - 1,
               torch.rand((k, batch), generator=g),
               obs + 0.05 * torch.randn(obs.shape, generator=g),
               torch.rand((k, batch), generator=g) < 0.1)
    return [x.to(dev) for x in groups], tuple(x.to(dev) for x in batches)


@pytest.mark.parametrize("hidden,batch,k,agc,sched", [
    ((256, 256), 200, 4, "updated", None),
    ((64, 48, 32), 200, 4, "pre", (0.1, 50)),
    ((256, 256), 256, 16, "updated", None),
    ((96, 80, 64, 48), 200, 4, "updated", (0.1, 50)),
    ((256, 256), 256, 4, "pre", (0.1, 50)),
    ((64, 64), 1000, 2, "updated", None),
    ((8,) * 5, 200, 4, "updated", (0.1, 50)),
    ((1536, 1536), 200, 2, "pre", None)])
def test_b3_matches_twin(cuda, hidden, batch, k, agc, sched):
    """K updates from warmed moments: every group and both loss vectors
    within the reference's kernel-vs-XLA bar (rtol 2e-4, atol 1e-5), one
    counted launch, and the same bits from a second run. (8,) * 5 is
    deeper than the old cap of 4 layers; (1536, 1536) keeps its row
    tiles' buffers in the workspace."""
    groups, batches = _b3_inputs(cuda, hidden, batch, k, seed=2)
    kw = dict(actor_lr=1e-3, critic_lr=2e-3, gamma=0.99, tau=0.05,
              actor_grad_critic=agc, lr_schedule=sched)
    la, lc = lk.actor_layout(42, hidden), lk.critic_layout(42, hidden)
    lays = (la, lc, la, lc, la, la, lc, lc)
    want = lk.update_phase_math(
        *[lk.group_views(g, lay) for g, lay in zip(groups, lays)], batches,
        30, hidden, **kw)
    runs = []
    for _ in range(2):
        got = [g.clone() for g in groups]
        before = lk.ddpg_update_phase.launches
        losses = lk.ddpg_update_phase(got, batches, 30, hidden, **kw)
        torch.cuda.synchronize()
        assert lk.ddpg_update_phase.launches == before + 1
        runs.append((got, losses))
    (got, losses), (got2, losses2) = runs
    for g, lay, w in zip(got, lays, want[:8]):
        for v, x in zip(lk.group_views(g, lay), w):
            torch.testing.assert_close(v, x, rtol=2e-4, atol=1e-5)
    for a, b in zip(losses, want[8:]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got + list(losses),
                                                 got2 + list(losses2)))


def test_b3_plan_matches_the_kernel(cuda):
    """The kernel's workspace equals `ddpg_workspace_floats` (its plan:
    8-row forward and 4-row backward items, their buffers in shared memory
    up to two layers of 1468 at obs 42 and in the workspace past them, or
    wherever spill asks), at "updated" and "pre", batches 200 and 256, and
    on both sides of the boundary."""
    lib = _native.load_library()
    for hidden in ((256, 256), (8,) * 5, (1468, 1468), (1469, 1469),
                   (1536, 1536), (64, 48, 32)):
        la, lc = lk.actor_layout(42, hidden), lk.critic_layout(42, hidden)
        torso, (na, nc), widths = lk._learner_shape(cuda, hidden,
                                                    (tuple(la), tuple(lc)))
        for batch in (200, 256):
            for agc in ("updated", "pre"):
                for spill in (False, True):
                    dims = _native.LearnerDims(
                        obs_dim=42, batch=batch, k_updates=16,
                        merged=int(agc == "pre"), torso=torso, actor=na,
                        critic=nc, spill=int(spill))
                    size = lib.cp_ddpg_workspace_floats(
                        _native.struct_ptr(dims), widths)
                    assert size == lk.ddpg_workspace_floats(
                        42, hidden, batch, agc, spill), (hidden, batch, agc)


@pytest.mark.parametrize("agc", ["updated", "pre"])
def test_b3_routes_repeat_their_bits(cuda, agc):
    """At the DDPG defaults (batch 256, K 16, hidden (256, 256)) the items'
    buffers in shared memory and in the workspace give the same bits, and
    each route gives the same bits twice."""
    hidden = (256, 256)
    assert not lk.ddpg_plan(42, hidden, 256, agc)[2]
    groups, batches = _b3_inputs(cuda, hidden, 256, 16, seed=21)
    kw = dict(actor_lr=1e-4, critic_lr=1e-3, gamma=0.99, tau=0.01)
    runs = []
    for spill in (False, True, False, True):
        got = [g.clone() for g in groups]
        losses = lk._ddpg_launch(got, batches, 100, hidden, kw, None,
                                 agc == "pre", spill)
        torch.cuda.synchronize()
        runs.append(got + list(losses))
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], run))


def test_b3_rejects_uncovered_shapes(cuda):
    groups, batches = _b3_inputs(cuda, (32, 32), 16, 1, seed=0)
    with pytest.raises(ValueError, match="not covered"):
        lk.ddpg_update_phase(groups, batches, 0, (32,), actor_lr=1e-3,
                             critic_lr=1e-3, gamma=0.99, tau=0.01)


def _random_qnet(dev, hidden, seed, head_scale=0.5, net_cls=QNetMLP):
    """A Q-net (or another 5-action torso net, `net_cls`) with its
    LayerNorm parameters and head redrawn (a head_scale of 0.05 keeps the
    Q values near 1 and their gaps small)."""
    g = torch.Generator().manual_seed(seed)
    q = net_cls(42, 5, hidden, generator=g)
    with torch.no_grad():
        for norm in q.norms:
            norm.weight.copy_(1.0 + 0.2 * torch.randn(norm.weight.shape,
                                                      generator=g))
            norm.bias.copy_(0.1 * torch.randn(norm.bias.shape, generator=g))
        for prm in q.head.parameters():
            prm.copy_(head_scale * torch.randn(prm.shape, generator=g))
    return q.to(dev)


def _top2_gap(q, obs):
    """The twin's gap between the two largest Q values per env and step."""
    with torch.no_grad():
        top = torch.topk(q(obs), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


@pytest.mark.parametrize("eps", [0.3, 0.0], ids=["eps0.3", "greedy"])
@pytest.mark.parametrize("hidden", [(256, 256), (64,), (32, 48, 16), (2048,),
                                    (8,) * 5])
def test_b4_matches_twin(cuda, hidden, eps):
    """Actions exact, except from an env's step where the twin's top-2 Q
    gap is below 1e-5 (a near-tie that a different summation order may
    break the other way; such envs leave the float comparison); obs and
    reward within rtol 2e-4 / atol 2e-5; dones, steps and episodes exact;
    one counted launch."""
    env = CartPole3D(CartPoleParams(), num_envs=B, device=cuda)
    q = _random_qnet(cuda, hidden, seed=1, head_scale=0.05)
    # Random-action steps past the reset (whose poses are all alike), and
    # the first layer centred on those obs so that the greedy actions and
    # Q gaps vary across envs.
    state, obs, _ = qr.reference_q_rollout(env, q, *env.reset(9), 0, 1.0, 6)
    with torch.no_grad():
        q.torso[0].bias.copy_(-(q.torso[0].weight @ obs.mean(0)))
    before = qr.q_policy_rollout.launches
    k = qr.q_policy_rollout(env, q, state, obs, 7, eps, 3)
    torch.cuda.synchronize()
    assert qr.q_policy_rollout.launches == before + 1
    r = qr.reference_q_rollout(env, q, state, obs, 7, eps, 3)
    assert k[2][1].dtype == torch.int32
    diff = k[2][1] != r[2][1]
    first = diff & (diff.int().cumsum(0) == 1)  # an env's first mismatch
    assert bool((_top2_gap(q, r[2][0])[first] < 1e-5).all())
    keep = ~diff.any(0)
    for a, b in zip((k[2][0], k[2][2]), (r[2][0], r[2][2])):
        torch.testing.assert_close(a[:, keep], b[:, keep], rtol=2e-4,
                                   atol=2e-5)
    assert torch.equal(k[2][3][:, keep], r[2][3][:, keep])
    for a, b in zip((*k[0].phys, k[1]), (*r[0].phys, r[1])):
        torch.testing.assert_close(a[keep], b[keep], rtol=2e-4, atol=2e-5)
    assert torch.equal(k[0].steps[keep], r[0].steps[keep])
    assert torch.equal(k[0].episode[keep], r[0].episode[keep])


def test_b4_rejects_uncovered_shapes(cuda):
    env = CartPole3D(CartPoleParams(), num_envs=64, device=cuda)
    state, obs = env.reset(0)
    with pytest.raises(ValueError, match="not covered"):
        qr.q_policy_rollout(env, QNetMLP(42, 5, ()).to(cuda), state, obs, 0,
                            0.1, 2)
    flat = CartPole3D(CartPoleParams(), num_envs=64, obs_mode="state",
                      device=cuda)
    with pytest.raises(ValueError, match="not covered"):
        qr.q_policy_rollout(flat, QNetMLP(flat.obs_size, 5, (32,)).to(cuda),
                            *flat.reset(0), 0, 0.1, 2)
    cont = CartPole3D(continuous_params(), num_envs=64, device=cuda)
    with pytest.raises(ValueError, match="not covered"):
        qr.q_policy_rollout(cont, QNetMLP(42, 5, (32,)).to(cuda),
                            *cont.reset(0), 0, 0.1, 2)


def _b5_inputs(dev, hidden, batch, k, seed):
    """The 4 group buffers (a Q-net with redrawn LayerNorm parameters and
    head, a target near it, warmed Adam moments) and K minibatches with
    int32 actions."""
    g = torch.Generator().manual_seed(seed)
    q = _random_qnet("cpu", hidden, seed)
    flat = torch.cat([p.detach().reshape(-1) for p in q.parameters()])
    groups = [flat, flat + 0.01 * torch.randn(flat.shape, generator=g),
              1e-2 * torch.randn(flat.shape, generator=g),
              (1e-2 * torch.randn(flat.shape, generator=g)) ** 2 + 1e-5]
    obs = 0.3 * torch.randn((k, batch, 42), generator=g)
    batches = (obs, torch.randint(0, 5, (k, batch), generator=g,
                                  dtype=torch.int32),
               torch.rand((k, batch), generator=g),
               obs + 0.05 * torch.randn(obs.shape, generator=g),
               torch.rand((k, batch), generator=g) < 0.1)
    return [x.to(dev) for x in groups], tuple(x.to(dev) for x in batches)


@pytest.mark.parametrize("hidden,double_dqn", [
    ((256, 256), True), ((256, 256), False), ((64, 48, 32), True),
    ((48,), True), ((8,) * 5, True), ((2048,), False)])
def test_b5_matches_twin(cuda, hidden, double_dqn):
    """4 updates from warmed moments on a ragged batch of 200: every group
    and the loss vector within the reference's kernel-vs-XLA bar (rtol
    2e-4, atol 1e-5), one counted launch, and the same bits from a second
    run."""
    groups, batches = _b5_inputs(cuda, hidden, 200, 4, seed=2)
    kw = dict(lr=1e-3, gamma=0.99, tau=0.05, double_dqn=double_dqn)
    lay = lk.qnet_layout(42, hidden)
    want = lk.dqn_update_phase_math(
        *[lk.group_views(g, lay) for g in groups], batches, 30, hidden, **kw)
    runs = []
    for _ in range(2):
        got = [g.clone() for g in groups]
        before = lk.dqn_update_phase.launches
        loss = lk.dqn_update_phase(got, batches, 30, hidden, **kw)
        torch.cuda.synchronize()
        assert lk.dqn_update_phase.launches == before + 1
        runs.append((got, loss))
    (got, loss), (got2, loss2) = runs
    for g, w in zip(got, want[:4]):
        for v, x in zip(lk.group_views(g, lay), w):
            torch.testing.assert_close(v, x, rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(loss, want[4], rtol=2e-4, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got + [loss],
                                                 got2 + [loss2]))


def test_b5_plan_matches_the_kernel(cuda):
    """The kernel's workspace equals `dqn_workspace_floats` (its plan:
    forward items of 8 rows, their buffers in shared memory up to one layer
    of 1468 at obs 42 and in the workspace past it, or wherever spill
    asks), at batches 200 and 256 and on both sides of the boundary."""
    lib = _native.load_library()
    for hidden in ((256, 256), (8,) * 5, (1468,), (1469,), (2048,),
                   (64, 48, 32)):
        lay = lk.qnet_layout(42, hidden)
        torso, (net,), widths = lk._learner_shape(cuda, hidden, (tuple(lay),))
        for batch in (200, 256):
            for spill in (False, True):
                dims = _native.DqnDims(obs_dim=42, batch=batch, k_updates=8,
                                       double_dqn=1, torso=torso, q=net,
                                       spill=int(spill))
                size = lib.cp_dqn_workspace_floats(_native.struct_ptr(dims),
                                                   widths)
                assert size == lk.dqn_workspace_floats(42, hidden, batch,
                                                       spill), (hidden, batch)


@pytest.mark.parametrize("double_dqn", [True, False], ids=["double", "max"])
def test_b5_routes_repeat_their_bits(cuda, double_dqn):
    """At the DQN defaults (batch 256, K 8, hidden (256, 256)) the items'
    buffers in shared memory and in the workspace give the same bits, and
    each route gives the same bits twice."""
    hidden = (256, 256)
    assert not lk.dqn_plan(42, hidden, 256)[2]
    groups, batches = _b5_inputs(cuda, hidden, 256, 8, seed=21)
    runs = []
    for spill in (False, True, False, True):
        got = [g.clone() for g in groups]
        loss = lk._dqn_launch(got, batches, 100, hidden, 5e-5, 0.99, 0.01,
                              double_dqn, spill)
        torch.cuda.synchronize()
        runs.append(got + [loss])
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], run))


def test_b5_rejects_uncovered_shapes(cuda):
    groups, batches = _b5_inputs(cuda, (32, 32), 16, 1, seed=0)
    kw = dict(lr=1e-3, gamma=0.99, tau=0.01)
    with pytest.raises(ValueError, match="not covered"):
        lk.dqn_update_phase(groups, batches, 0, (), **kw)
    with pytest.raises(ValueError, match="action"):
        lk.dqn_update_phase(groups, (batches[0], batches[1].float())
                            + batches[2:], 0, (32, 32), **kw)


def _random_policy(dev, hidden, seed):
    """A PolicyMLP with its LayerNorm parameters and head redrawn, the
    head's scale falling with the width so that the logits' spread does
    not grow with it."""
    return _random_qnet(dev, hidden, seed, 0.5 * (64 / hidden[-1]) ** 0.5,
                        net_cls=PolicyMLP)


def _pg_top2_gap(net, obs, env_seed, t0):
    """The twin's gap between the two largest logits + Gumbel draws per
    step and env: the margin by which each sample was taken."""
    with torch.no_grad():
        top = torch.stack([
            torch.topk(pg.gumbel_scores(net(o), env_seed, t0 + i), 2).values
            for i, o in enumerate(obs)])
    return top[..., 0] - top[..., 1]


@pytest.mark.parametrize("hidden", [(64, 64), (256,), (32, 48, 16), (2048,),
                                    (8,) * 5])
def test_b8_matches_twin(cuda, hidden):
    """Actions exact, except from an env's step where the twin's top-2 gap
    of logits + Gumbel draws is below 1e-5 (such envs leave the float
    comparison); obs and reward within rtol 2e-4 / atol 2e-5; dones, steps
    and episodes exact; one counted launch."""
    env = CartPole3D(CartPoleParams(), num_envs=B, device=cuda)
    net = _random_policy(cuda, hidden, seed=3)
    # Sampled steps past the reset (whose poses are all alike), and the
    # first layer centred on those obs so that the samples vary by env.
    state, obs, _ = pg.reference_pg_rollout(env, net, *env.reset(9), 0, 6)
    with torch.no_grad():
        net.torso[0].bias.copy_(-(net.torso[0].weight @ obs.mean(0)))
    before = pg.pg_policy_rollout.launches
    k = pg.pg_policy_rollout(env, net, state, obs, 7, 3)
    torch.cuda.synchronize()
    assert pg.pg_policy_rollout.launches == before + 1
    r = pg.reference_pg_rollout(env, net, state, obs, 7, 3)
    assert k[2][1].dtype == torch.int32
    assert len(torch.unique(r[2][1])) >= 3  # the samples are spread
    diff = k[2][1] != r[2][1]
    first = diff & (diff.int().cumsum(0) == 1)  # an env's first mismatch
    gaps = _pg_top2_gap(net, r[2][0], state.env_seed, 7)
    assert bool((gaps[first] < 1e-5).all())
    keep = ~diff.any(0)
    for a, b in zip((k[2][0], k[2][2]), (r[2][0], r[2][2])):
        torch.testing.assert_close(a[:, keep], b[:, keep], rtol=2e-4,
                                   atol=2e-5)
    assert torch.equal(k[2][3][:, keep], r[2][3][:, keep])
    for a, b in zip((*k[0].phys, k[1]), (*r[0].phys, r[1])):
        torch.testing.assert_close(a[keep], b[keep], rtol=2e-4, atol=2e-5)
    assert torch.equal(k[0].steps[keep], r[0].steps[keep])
    assert torch.equal(k[0].episode[keep], r[0].episode[keep])


def test_b8_rejects_uncovered_shapes(cuda):
    env = CartPole3D(CartPoleParams(), num_envs=64, device=cuda)
    state, obs = env.reset(0)
    with pytest.raises(ValueError, match="not covered by the B8"):
        pg.pg_policy_rollout(env, PolicyMLP(42, 5, ()).to(cuda), state, obs,
                             0, 2)
    flat = CartPole3D(CartPoleParams(), num_envs=64, obs_mode="state",
                      device=cuda)
    with pytest.raises(ValueError, match="not covered by the B8"):
        pg.pg_policy_rollout(flat, PolicyMLP(flat.obs_size, 5, (32,)).to(
            cuda), *flat.reset(0), 0, 2)
    cont = CartPole3D(continuous_params(), num_envs=64, device=cuda)
    with pytest.raises(ValueError, match="not covered by the B8"):
        pg.pg_policy_rollout(cont, PolicyMLP(42, 5, (32,)).to(cuda),
                             *cont.reset(0), 0, 2)


@pytest.mark.parametrize("kernel", ["B4", "B8"])
@pytest.mark.parametrize("hidden", [(64, 64), (256, 256), (2048,)],
                         ids=["resident", "streamed", "workspace"])
def test_b4_and_b8_repeat_their_bits(cuda, kernel, hidden):
    """Two launches on the same inputs give the same bits: the weights
    resident in shared memory, streamed through it, and the activations in
    the workspace."""
    env = CartPole3D(CartPoleParams(), num_envs=B, device=cuda)
    state, obs = env.reset(4)
    if kernel == "B4":
        net = _random_qnet(cuda, hidden, seed=5, head_scale=0.05)
        run = lambda: qr.q_policy_rollout(env, net, state, obs, 3, 0.3, 8)
    else:
        net = _random_policy(cuda, hidden, seed=5)
        run = lambda: pg.pg_policy_rollout(env, net, state, obs, 3, 8)
    runs = [run() for _ in range(2)]
    torch.cuda.synchronize()
    a, b = ((*st.phys, st.steps, st.episode, o, *traj)
            for st, o, traj in runs)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _b9_inputs(dev, hidden, n, seed):
    """The 3 group buffers (a policy with redrawn LayerNorm parameters and
    head, warmed Adam moments) and a window of n rows."""
    g = torch.Generator().manual_seed(seed)
    net = _random_policy("cpu", hidden, seed)
    flat = torch.cat([p.detach().reshape(-1) for p in net.parameters()])
    groups = [flat, 1e-2 * torch.randn(flat.shape, generator=g),
              (1e-2 * torch.randn(flat.shape, generator=g)) ** 2 + 1e-5]
    window = (0.3 * torch.randn((n, 42), generator=g),
              torch.randint(0, 5, (n,), generator=g, dtype=torch.int32),
              torch.randn((n,), generator=g))
    return [x.to(dev) for x in groups], tuple(x.to(dev) for x in window)


@pytest.mark.parametrize("hidden,n", [
    ((64, 64), 1000), ((64, 64), 131072), ((32, 48, 16), 777), ((48,), 4096),
    ((64,) * 3, 1000), ((256, 300), 1000), ((1024, 40), 777),
    ((2048, 2048), 1000), ((1024,) * 4, 777), ((8,) * 5, 1000)])
def test_b9_matches_twin(cuda, hidden, n):
    """One update from warmed moments (Adam count 100): the 3 groups and
    the loss within the reference's kernel-vs-XLA bar (rtol 2e-4, atol
    1e-5), one counted launch, and the same bits from a second run. The
    shapes from (256, 300) on do not fit in shared memory: the workspace
    route."""
    groups, window = _b9_inputs(cuda, hidden, n, seed=2)
    kw = dict(lr=3e-4, entropy_coef=0.1)
    lay = lk.policy_layout(42, hidden)
    want = lk.lrpg_update_phase_math(
        *[lk.group_views(g, lay) for g in groups], window, 100, hidden, **kw)
    runs = []
    for _ in range(2):
        got = [g.clone() for g in groups]
        before = lk.lrpg_update_phase.launches
        loss = lk.lrpg_update_phase(got, window, 100, hidden, **kw)
        torch.cuda.synchronize()
        assert lk.lrpg_update_phase.launches == before + 1
        runs.append(got + [loss])
    for g, w in zip(runs[0][:3], want[:3]):
        for v, x in zip(lk.group_views(g, lay), w):
            torch.testing.assert_close(v, x, rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(runs[0][3], want[3], rtol=2e-4, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_b9_tile_plan_matches_the_kernel(cuda):
    """The kernel's workspace on the route `pg_tile_spills` picks equals
    `pg_workspace_floats` (its plan: 64-row tiles, block cap, spilled
    tiles), at the boundaries of the shared-memory route for one to four
    layers and past them; past them the shared-memory route takes no
    block (a zero workspace)."""
    lib = _native.load_library()
    for hidden in ((64, 64), (139,), (140,), (84, 84), (85, 85), (65,) * 3,
                   (66,) * 3, (55,) * 4, (56,) * 4, (8,) * 5, (2048,),
                   (2048, 2048)):
        lay = lk.policy_layout(42, hidden)
        assert lk.lrpg_covers(42, hidden), hidden
        spills = lk.pg_tile_spills(42, hidden)
        torso, (net,), widths = lk._learner_shape(cuda, hidden, (tuple(lay),))
        for spill in (False, True):
            dims = _native.PgDims(obs_dim=42, n_rows=4096, spill=int(spill),
                                  torso=torso, net=net)
            size = lib.cp_lrpg_workspace_floats(_native.struct_ptr(dims),
                                                widths)
            if spill == spills:
                assert size == lk.pg_workspace_floats(42, hidden, 4096), hidden
            elif spills:
                assert size == 0, hidden


@pytest.mark.parametrize("hidden", [(64, 64), (32, 48, 16)],
                         ids=["h64x2", "h32-48-16"])
def test_b9_routes_give_the_same_bits(cuda, hidden):
    """Where the shared-memory route takes the network, the workspace route
    runs the same arithmetic in the same order: the two give the same
    bits, on a window with a ragged last tile."""
    assert not lk.pg_tile_spills(42, hidden)
    groups, window = _b9_inputs(cuda, hidden, 1000, seed=4)
    runs = []
    for spill in (False, True):
        got = [g.clone() for g in groups]
        loss = lk._lrpg_launch(got, window, 100, hidden, 3e-4, 0.1, spill)
        torch.cuda.synchronize()
        runs.append(got + [loss])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_b9_rejects_uncovered_shapes(cuda):
    groups, window = _b9_inputs(cuda, (32, 32), 64, seed=0)
    kw = dict(lr=1e-3, entropy_coef=0.1)
    with pytest.raises(ValueError, match="not covered"):
        lk.lrpg_update_phase(groups, window, 0, (), **kw)
    with pytest.raises(ValueError, match="action"):
        lk.lrpg_update_phase(groups, (window[0], window[1].float(),
                                      window[2]), 0, (32, 32), **kw)
    wide, wwin = _b9_inputs(cuda, (85, 85), 64, seed=0)
    with pytest.raises(ValueError, match="rejected"):  # no block in smem
        lk._lrpg_launch(wide, wwin, 0, (85, 85), 1e-3, 0.1, False)


def test_lrpg_cli_launches_b8_and_b9_per_train_step(cuda):
    """`train --agent lrpg` on the card: each train step launches B8 once
    and B9 once, and reports both kernels in its metrics."""
    b8, b9 = pg.pg_policy_rollout.launches, lk.lrpg_update_phase.launches
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train.main(["--agent", "lrpg", "--num-envs", "1000",
                         "--total-env-steps", "96", "--log-interval", "1"])
    assert rc == 0
    steps = [json.loads(x) for x in out.getvalue().splitlines()]
    assert [m["train_step"] for m in steps] == [1, 2, 3]
    assert pg.pg_policy_rollout.launches == b8 + 3
    assert lk.lrpg_update_phase.launches == b9 + 3
    assert all(m["rollout_impl"] == 1.0 and m["learner_impl"] == 1.0
               for m in steps)


def _random_naf(dev, hidden, seed, mu_scale=None):
    """A NafNet with its LayerNorm parameters and head redrawn, so that mu
    (and the V and L rows) move with every stage; the head's scale 0.5 /
    sqrt(H) keeps its rows near unit size. A `mu_scale` redraws the mu
    rows at that scale (0.5 saturates the actions: resets and the clip
    occur within a few steps)."""
    g = torch.Generator().manual_seed(seed)
    net = NafNet(42, 2, hidden, generator=g)
    with torch.no_grad():
        for norm in net.norms:
            norm.weight.copy_(1.0 + 0.2 * torch.randn(norm.weight.shape,
                                                      generator=g))
            norm.bias.copy_(0.1 * torch.randn(norm.bias.shape, generator=g))
        for prm in net.head.parameters():
            prm.copy_(0.5 / hidden[-1] ** 0.5
                      * torch.randn(prm.shape, generator=g))
            if mu_scale is not None:
                prm[1:3] = mu_scale * torch.randn(prm[1:3].shape,
                                                  generator=g)
    return net.to(dev)


@pytest.mark.parametrize("sigma", [0.2, 0.0], ids=["sigma0.2", "greedy"])
@pytest.mark.parametrize("hidden", [(256, 256), (64,), (32, 48, 16), (2048,),
                                    (8,) * 5])
def test_b6_matches_twin(cuda, hidden, sigma):
    """tests/test_policy_rollout.py's tolerances (rtol 2e-4, atol 2e-5)
    on the trajectory, final state and obs; dones, steps and episodes
    exact (some envs reset in the window); one counted launch. (2048,)
    keeps its activations in the workspace, (8,) * 5 is deeper than the
    old cap of 4 layers."""
    env = CartPole3D(continuous_params(), num_envs=B, device=cuda)
    state, obs = env.reset(9)
    net = _random_naf(cuda, hidden, seed=1, mu_scale=0.5)
    before = nr.naf_policy_rollout.launches
    k = nr.naf_policy_rollout(env, net, state, obs, 7, sigma, 3)
    torch.cuda.synchronize()
    assert nr.naf_policy_rollout.launches == before + 1
    r = nr.reference_naf_rollout(env, net, state, obs, 7, sigma, 3)
    assert r[2][3].any()
    for a, b in zip(k[2][:3], r[2][:3]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
    assert torch.equal(k[2][3], r[2][3])
    for a, b in zip((*k[0].phys, k[1]), (*r[0].phys, r[1])):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
    assert torch.equal(k[0].steps, r[0].steps)
    assert torch.equal(k[0].episode, r[0].episode)


def test_b6_rejects_uncovered_shapes(cuda):
    """An empty torso, state obs and the discrete env: what the reference's
    `naf_fusable` rejects too."""
    env = CartPole3D(continuous_params(), num_envs=64, device=cuda)
    state, obs = env.reset(0)
    with pytest.raises(ValueError, match="not covered by the B6"):
        nr.naf_policy_rollout(env, NafNet(42, 2, ()).to(cuda), state, obs,
                              0, 0.2, 2)
    flat = CartPole3D(continuous_params(), num_envs=64, obs_mode="state",
                      device=cuda)
    with pytest.raises(ValueError, match="not covered by the B6"):
        nr.naf_policy_rollout(flat, NafNet(flat.obs_size, 2, (32,)).to(cuda),
                              *flat.reset(0), 0, 0.2, 2)
    disc = CartPole3D(CartPoleParams(), num_envs=64, device=cuda)
    with pytest.raises(ValueError, match="not covered by the B6"):
        nr.naf_policy_rollout(disc, NafNet(42, 2, (32,)).to(cuda),
                              *disc.reset(0), 0, 0.2, 2)


@pytest.mark.parametrize("kernel", ["B2", "B6"])
@pytest.mark.parametrize("hidden", [(64, 64), (256, 256), (2048,)],
                         ids=["resident", "streamed", "workspace"])
def test_b2_and_b6_repeat_their_bits(cuda, kernel, hidden):
    """Two launches on the same inputs give the same bits: the weights
    resident in shared memory, streamed through it, and the activations in
    the workspace."""
    env = CartPole3D(continuous_params(), num_envs=B, device=cuda)
    state, obs = env.reset(4)
    if kernel == "B2":
        actor = _random_actor(cuda, hidden, seed=5)
        noise = 0.1 * torch.ones((B, 2), device=cuda)
        run = lambda: pr.policy_rollout(env, actor, 0.15, state, obs, noise,
                                        3, 0.2, 8)
    else:
        net = _random_naf(cuda, hidden, seed=5, mu_scale=0.5)
        run = lambda: nr.naf_policy_rollout(env, net, state, obs, 3, 0.2, 8)
    runs = [run() for _ in range(2)]
    torch.cuda.synchronize()
    a, b = ((*out[0].phys, out[0].steps, out[0].episode, *out[1:-1],
             *out[-1]) for out in runs)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _b7_inputs(dev, hidden, batch, k, seed):
    """The 4 group buffers (a NafNet with redrawn LayerNorm parameters and
    head, a target near it, warmed Adam moments) and K minibatches with
    float32 actions in [-1, 1]."""
    g = torch.Generator().manual_seed(seed)
    net = _random_naf("cpu", hidden, seed)
    flat = torch.cat([p.detach().reshape(-1) for p in net.parameters()])
    groups = [flat, flat + 0.01 * torch.randn(flat.shape, generator=g),
              1e-2 * torch.randn(flat.shape, generator=g),
              (1e-2 * torch.randn(flat.shape, generator=g)) ** 2 + 1e-5]
    obs = 0.3 * torch.randn((k, batch, 42), generator=g)
    batches = (obs, torch.rand((k, batch, 2), generator=g) * 2 - 1,
               torch.rand((k, batch), generator=g),
               obs + 0.05 * torch.randn(obs.shape, generator=g),
               torch.rand((k, batch), generator=g) < 0.1)
    return [x.to(dev) for x in groups], tuple(x.to(dev) for x in batches)


@pytest.mark.parametrize("hidden,clip,sched", [
    ((256, 256), 10.0, (0.1, 50)), ((256, 256), 0.0, None),
    ((256, 256), 0.05, (0.1, 50)), ((64, 48, 32), 0.05, None),
    ((48,), 10.0, (0.1, 50)), ((8,) * 5, 10.0, (0.1, 50)),
    ((2048,), 0.05, None)])
def test_b7_matches_twin(cuda, hidden, clip, sched):
    """4 updates from warmed moments on a ragged batch of 200, with the
    clip off, on and firing (a max norm of 0.05 is below every update's
    gradient norm): every group and the loss vector within the reference's
    kernel-vs-XLA bar (rtol 2e-4, atol 1e-5), one counted launch, and the
    same bits from a second run."""
    groups, batches = _b7_inputs(cuda, hidden, 200, 4, seed=2)
    kw = dict(lr=1e-3, gamma=0.99, tau=0.05, max_grad_norm=clip,
              lr_schedule=sched)
    lay = lk.naf_layout(42, hidden)
    want = lk.naf_update_phase_math(
        *[lk.group_views(g, lay) for g in groups], batches, 30, hidden, **kw)
    if clip == 0.05:
        assert bool((want[5] > clip).all()), want[5]
    runs = []
    for _ in range(2):
        got = [g.clone() for g in groups]
        before = lk.naf_update_phase.launches
        loss = lk.naf_update_phase(got, batches, 30, hidden, **kw)
        torch.cuda.synchronize()
        assert lk.naf_update_phase.launches == before + 1
        runs.append((got, loss))
    (got, loss), (got2, loss2) = runs
    for g, w in zip(got, want[:4]):
        for v, x in zip(lk.group_views(g, lay), w):
            torch.testing.assert_close(v, x, rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(loss, want[4], rtol=2e-4, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got + [loss],
                                                 got2 + [loss2]))


def test_b7_covers_matches_the_kernel(cuda):
    """The kernel takes exactly the shapes `naf_covers` admits (a nonzero
    workspace): any depth and width; no torso at all is rejected."""
    lib = _native.load_library()
    for hidden in ((256, 256), (64,), (8,) * 4, (8,) * 5, (1024, 1024),
                   (1025,), (32, 1025), (3,) * 12, (4096, 4096)):
        torso, (net,), widths = lk._learner_shape(
            cuda, hidden, (tuple(lk.naf_layout(42, hidden)),))
        dims = _native.NafDims(obs_dim=42, batch=256, k_updates=8,
                               max_norm=10.0, torso=torso, q=net)
        size = lib.cp_naf_workspace_floats(_native.struct_ptr(dims), widths)
        assert (size > 0) == lk.naf_covers(42, hidden), hidden
        dims.torso.num_layers = 0
        assert lib.cp_naf_workspace_floats(_native.struct_ptr(dims),
                                           widths) == 0
    assert not lk.naf_covers(42, ())


def test_b7_plan_matches_the_kernel(cuda):
    """The kernel's workspace equals `naf_workspace_floats` (its plan:
    4-row forward and backward items, their buffers in shared memory up to
    one layer of 2449 at obs 42 and in the workspace past it, or wherever
    spill asks), at batches 200 and 256 and on both sides of the
    boundary."""
    lib = _native.load_library()
    for hidden in ((256, 256), (8,) * 5, (2449,), (2450,), (4096,),
                   (64, 48, 32)):
        torso, (net,), widths = lk._learner_shape(
            cuda, hidden, (tuple(lk.naf_layout(42, hidden)),))
        for batch in (200, 256):
            for spill in (False, True):
                dims = _native.NafDims(obs_dim=42, batch=batch, k_updates=8,
                                       max_norm=10.0, torso=torso, q=net,
                                       spill=int(spill))
                size = lib.cp_naf_workspace_floats(_native.struct_ptr(dims),
                                                   widths)
                assert size == lk.naf_workspace_floats(42, hidden, batch,
                                                       spill), (hidden, batch)


@pytest.mark.parametrize("clip", [10.0, 0.0], ids=["clip10", "noclip"])
def test_b7_routes_repeat_their_bits(cuda, clip):
    """At the NAF defaults (batch 256, K 8, hidden (256, 256), the lr
    schedule) the items' buffers in shared memory and in the workspace
    give the same bits, and each route gives the same bits twice, with
    the clip and without it."""
    hidden = (256, 256)
    assert not lk.naf_plan(42, hidden, 256)[2]
    groups, batches = _b7_inputs(cuda, hidden, 256, 8, seed=21)
    kw = dict(lr=1e-3, gamma=0.99, tau=0.01, max_grad_norm=clip,
              lr_schedule=(0.1, 50))
    runs = []
    for spill in (False, True, False, True):
        got = [g.clone() for g in groups]
        loss = lk._naf_launch(got, batches, 100, hidden, kw, spill)
        torch.cuda.synchronize()
        runs.append(got + [loss])
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], run))


def test_b7_rejects_uncovered_shapes(cuda):
    groups, batches = _b7_inputs(cuda, (32, 32), 16, 1, seed=0)
    kw = dict(lr=1e-3, gamma=0.99, tau=0.01, max_grad_norm=10.0)
    with pytest.raises(ValueError, match="not covered"):
        lk.naf_update_phase(groups, batches, 0, (), **kw)
    with pytest.raises(ValueError, match="action"):
        lk.naf_update_phase(groups, (batches[0], batches[1][..., :1])
                            + batches[2:], 0, (32, 32), **kw)


def test_naf_cli_launches_b6_and_b7_per_train_step(cuda):
    """`train --agent naf --naf.learner kernel` on the card: each train
    step launches B6 once, and each one past the 16-step warmup B7 once;
    at the default learner B7 never launches."""
    for learner, n_b7, impl in (("kernel", 3, 1.0), ("xla", 0, 0.0)):
        b6, b7 = nr.naf_policy_rollout.launches, lk.naf_update_phase.launches
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = train.main(["--agent", "naf", "--num-envs", "1000",
                             "--total-env-steps", "32", "--log-interval", "1",
                             "--naf.learner", learner])
        assert rc == 0
        steps = [json.loads(x) for x in out.getvalue().splitlines()]
        assert [m["train_step"] for m in steps] == [1, 2, 3, 4]
        assert nr.naf_policy_rollout.launches == b6 + 4
        assert lk.naf_update_phase.launches == b7 + n_b7
        assert all(m["rollout_impl"] == 1.0 and m["learner_impl"] == impl
                   for m in steps)


def _pixel_poses(cuda, n, seed):
    """n adversarial poses (positions uniform in +-2.2, tilts up to |s| =
    0.995) as a PhysState on the card."""
    from cartpoleplusplus_tpu_torch.physics import rest_state

    g = torch.Generator().manual_seed(seed)
    pos = torch.stack([torch.rand(n, generator=g) * 4.4 - 2.2,
                       torch.rand(n, generator=g) * 4.4 - 2.2,
                       torch.full((n,), 0.0978)], -1)
    s = torch.rand((n, 2), generator=g) * 1.98 - 0.99
    nrm = s.norm(dim=-1, keepdim=True)
    s = torch.where(nrm > 0.995, s * 0.995 / nrm, s)
    return rest_state(continuous_params(), (n,), device=cuda)._replace(
        pos=pos.to(cuda), s=s.to(cuda))


@pytest.mark.parametrize("size", [(48, 48), (20, 13)])
@pytest.mark.parametrize("gray", [True, False], ids=["gray", "rgb"])
def test_b10_matches_twin(cuda, gray, size):
    """B10 against render_all_cameras on adversarial poses: the same bits
    on every pixel, one counted launch, the frames' layout (N, H, W, C x
    2)."""
    from cartpoleplusplus_tpu_torch.env import pixels as px
    from cartpoleplusplus_tpu_torch.ops import render_kernel as rk

    p = continuous_params()
    cfg = px.RenderConfig(width=size[0], height=size[1], grayscale=gray)
    phys = _pixel_poses(cuda, 3 * B, seed=1)
    before = rk.render_frames.launches
    got = rk.render_frames(p, cfg, phys)
    assert rk.render_frames.launches == before + 1
    want = px.render_all_cameras(p, phys, cfg)
    nch = cfg.channels_per_camera
    assert got.shape == want.shape == (3 * B, size[1], size[0], 2 * nch)
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-5)
    assert torch.equal(got, want)
    assert float((want[1:] - want[:-1]).abs().max()) > 0.05


@pytest.mark.parametrize("gray", [True, False], ids=["gray", "rgb"])
def test_b11_matches_b10(cuda, gray):
    """B11 (row-band culling) gives B10's frames bit for bit on
    adversarial poses, one counted launch of its own."""
    from cartpoleplusplus_tpu_torch.env import pixels as px
    from cartpoleplusplus_tpu_torch.ops import render_kernel as rk

    p = continuous_params()
    cfg = px.RenderConfig(grayscale=gray)
    phys = _pixel_poses(cuda, B, seed=2)
    before = (rk.render_frames.launches, rk.render_culled.launches)
    full = rk.render_frames(p, cfg, phys)
    cut = rk.render_culled(p, cfg, phys)
    assert (rk.render_frames.launches, rk.render_culled.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(cut, full, rtol=0.0, atol=1e-6)
    assert torch.equal(cut, full)


@pytest.mark.parametrize("n", [1, 13, 33])
@pytest.mark.parametrize("gray", [True, False], ids=["gray", "rgb"])
def test_render_masks_a_ragged_env_block(cuda, gray, n):
    """Env counts below and past a block of 8 envs (kEnvs in
    csrc/render.cu): B10 equals its twin and B11 equals B10, bit for
    bit."""
    from cartpoleplusplus_tpu_torch.env import pixels as px
    from cartpoleplusplus_tpu_torch.ops import render_kernel as rk

    p = continuous_params()
    cfg = px.RenderConfig(width=20, height=13, grayscale=gray)
    phys = _pixel_poses(cuda, n, seed=5)
    got = rk.render_frames(p, cfg, phys)
    assert torch.equal(got, px.render_all_cameras(p, phys, cfg))
    assert torch.equal(rk.render_culled(p, cfg, phys), got)


def test_render_rejects_too_many_cameras(cuda):
    """The launcher keeps at most 8 camera bands: more cameras raise."""
    from cartpoleplusplus_tpu_torch.env import pixels as px
    from cartpoleplusplus_tpu_torch.ops import render_kernel as rk

    cfg = px.RenderConfig(width=8, height=8,
                          cameras=(px.CameraConfig(),) * 9)
    with pytest.raises(RuntimeError, match="CUDA error"):
        rk.render_frames(continuous_params(), cfg, _pixel_poses(cuda, 4, 3))


def test_pixel_cli_launches_b10_per_env_step(cuda, monkeypatch):
    """2 pixel train steps (512 envs, 48 x 48 gray uint8 frame-diff, block
    sampling): B10 once per env.step, once for the initial reset and once
    for the cached reset frame, the plain rollout and learner, no other
    kernel; under
    CARTPOLE_RENDER_CULL=1 the same count of B11 launches instead."""
    from cartpoleplusplus_tpu_torch.ops import render_kernel as rk

    argv = ["--obs-mode", "pixels", "--num-envs", "512",
            "--render-grayscale", "--render-obs-uint8", "--render-frame-diff",
            "--render-frame-diff-gain", "4", "--ddpg.sample", "block",
            "--ddpg.replay-capacity-per-env", "64", "--total-env-steps", "16",
            "--log-interval", "1"]
    others = (pr.policy_rollout, lk.ddpg_update_phase)
    for cull, wrapper in (("0", rk.render_frames), ("1", rk.render_culled)):
        monkeypatch.setenv("CARTPOLE_RENDER_CULL", cull)
        before = wrapper.launches
        other = [f.launches for f in others]
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            assert train.main(argv) == 0
        steps = [json.loads(x) for x in out.getvalue().splitlines()]
        assert [m["train_step"] for m in steps] == [1, 2]
        assert wrapper.launches == before + 1 + 1 + 16
        assert [f.launches for f in others] == other
        assert all(m["rollout_impl"] == 0.0 and m["learner_impl"] == 0.0
                   for m in steps)
        assert steps[1]["critic_loss"] > 0.0


def test_uncovered_rollout_runs_plain_on_the_card(cuda):
    """`--obs-mode state` (B2 does not cover it): the plain rollout on the
    card with one stderr line naming B2, `rollout_impl` 0, B2 never
    launched, B3 still taking the update phase."""
    b2, b3 = pr.policy_rollout.launches, lk.ddpg_update_phase.launches
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert train.main(["--obs-mode", "state", "--num-envs", "1000",
                           "--total-env-steps", "24", "--log-interval",
                           "1"]) == 0
    told = [ln for ln in err.getvalue().splitlines()
            if "kernel B2 does not cover" in ln]
    assert len(told) == 1, err.getvalue()
    steps = [json.loads(x) for x in out.getvalue().splitlines()]
    assert all(m["rollout_impl"] == 0.0 and m["learner_impl"] == 1.0
               for m in steps)
    assert pr.policy_rollout.launches == b2
    assert lk.ddpg_update_phase.launches == b3 + 2  # past the warmup of 16
