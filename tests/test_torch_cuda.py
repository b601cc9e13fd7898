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

import numpy as np
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


@pytest.mark.parametrize("params", [
    CartPoleParams(), continuous_params(),
    continuous_params(ground_friction=0.3, linear_damping=0.1)],
    ids=["discrete", "continuous", "friction"])
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


@pytest.mark.parametrize("params", [CartPoleParams(), continuous_params()],
                         ids=["discrete", "continuous"])
def test_b1_benchmark_length_repeats_its_bits(cuda, params):
    """B1 at the benchmark's 4096 envs x 4096 steps, where the twin would
    take minutes: two launches give the same bits in the final state and
    the checksum, every value is finite, and the steps and episodes keep
    chip_smoke.py phase_physics_rollout's invariants."""
    env = CartPole3D(params, num_envs=4096, device=cuda)
    state, _ = env.reset(0)
    before = fr.fused_rollout.launches
    (s1, c1), (s2, c2) = (fr.fused_rollout(env, state, 4096)
                          for _ in range(2))
    assert fr.fused_rollout.launches == before + 2
    for a, b in zip((*s1.phys, s1.steps, s1.episode, c1),
                    (*s2.phys, s2.steps, s2.episode, c2)):
        assert torch.equal(a, b)
    assert all(bool(torch.isfinite(x).all()) for x in (*s1.phys, c1))
    assert 0 <= int(s1.steps.min()) and int(s1.steps.max()) < 200
    assert int(s1.episode.min()) > 0


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
        losses = lk._ddpg_prepare(got, batches, 100, hidden, kw, None,
                                  agc == "pre", spill)()
        torch.cuda.synchronize()
        runs.append(got + list(losses))
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], run))


def test_b3_rejects_uncovered_shapes(cuda):
    groups, batches = _b3_inputs(cuda, (32, 32), 16, 1, seed=0)
    with pytest.raises(ValueError, match="not covered"):
        lk.ddpg_update_phase(groups, batches, 0, (32,), actor_lr=1e-3,
                             critic_lr=1e-3, gamma=0.99, tau=0.01)


# The teacher-forced DDPG check at the CLI defaults: 1024 envs (the
# reference's DDPG recipe), hidden (256, 256), K 16, batch 256, a ring of
# 1024 slots per env. Two starting states: "early", 3 CPU train steps past
# init, and "late", the end of the default recipe (5000 train steps, 40k
# env-steps per env, seed 0) trained on the card with B2 and B3.
TF_ENVS, TF_WARM, TF_LATE, TF_STEPS = 1024, 3, 5000, 32
# Bars per float leaf, normwise: max |card - cpu| <= atol + rtol * max |cpu|
# over the leaf (a product's or a sum's rounding scales with its terms, not
# with one element of the result). B2's bar on the env side (obs, env
# state, ring, noise), B3's on the learner side; integers, bools and counts
# exact; both losses within TF_LOSS_RTOL every step.
TF_ENV_BAR, TF_LEARNER_BAR, TF_LOSS_RTOL = (2e-4, 2e-5), (2e-4, 1e-5), 1e-4
TF_ENV_FIELDS = ("replay", "env_state", "obs", "noise")
# An edge step: a LayerNorm output within rounding of 0 takes the other side
# of a relu in one of the two runs, or an Adam step of a gradient within
# rounding of 0 takes the other sign; the rest of the step's updates carry
# it on. The reference and the port part so on the CPU at these shapes
# (tests/test_torch_ddpg.py's `ddpg_teacher_forced`). The learner side may
# leave its bar on at most TF_EDGE_STEPS steps, and there each leaf stays
# within TF_EDGE_REL of its own scale (max |cpu| over the leaf); the env
# side never leaves its bar.
TF_EDGE_STEPS, TF_EDGE_REL = 3, 1e-2


def _tree_parts(got, want, path, worst, parted):
    """Walks two `to_tree` dicts: worst[top field] = (max abs error, max of
    error / scale over its leaves), parted gets (path, error, scale) for
    each leaf beyond its field's bar (unequal, where exact)."""
    if isinstance(want, dict):
        for k in want:
            _tree_parts(got[k], want[k], f"{path}.{k}", worst, parted)
        return
    if isinstance(want, list):
        for a, b in zip(got, want):
            _tree_parts(a, b, path, worst, parted)
        return
    top = path.split(".")[1]
    if isinstance(want, torch.Tensor) and want.is_floating_point():
        err = float((got.double() - want.double()).abs().max())
        scale = float(want.double().abs().max())
        rtol, atol = (TF_ENV_BAR if top in TF_ENV_FIELDS else TF_LEARNER_BAR)
        beyond = not err <= atol + rtol * scale
    else:
        same = (torch.equal(got, want) if isinstance(want, torch.Tensor)
                else got == want)
        err, scale, beyond = (0.0 if same else float("inf")), 1.0, not same
    if beyond:
        parted.append((path, err, scale))
    e, r = worst.get(top, (0.0, 0.0))
    worst[top] = (max(e, err), max(r, err / scale if scale else err))


def ddpg_teacher_forced(cuda, learner, st, steps, label=""):
    """`steps` DDPG train steps, each run twice from one CPU state `st` (of
    a CPU DDPG at the CLI defaults but `learner`) with one set of replay
    draws: on the card (B2, and B3 or the plain learner) and on the CPU
    (the plain rollout, and B3's twin or the plain learner); both restart
    from the CPU's next state. Every step holds the bars above; returns the
    edge steps with their parted leaves (path, error, scale) and prints
    each step's max errors."""
    from cartpoleplusplus_tpu_torch.agents import DDPG, DDPGConfig
    from cartpoleplusplus_tpu_torch.ckpt.checkpoint import (merge_restored,
                                                            to_tree)

    cfg = DDPGConfig(learner=learner)
    n = st.obs.shape[0]
    cpu = DDPG(CartPole3D(continuous_params(), num_envs=n, device="cpu"), cfg)
    card = DDPG(CartPole3D(continuous_params(), num_envs=n, device=cuda),
                cfg)
    gst, draws = card.init(0), torch.Generator().manual_seed(1)
    cap, t = cpu.replay.capacity, cfg.rollout_steps
    b2, b3 = pr.policy_rollout.launches, lk.ddpg_update_phase.launches
    fmt = lambda d: json.dumps({k: [float(f"{x:.3g}") for x in v]  # noqa
                                for k, v in d.items()})
    overall, edge_steps = {}, []
    for step in range(1, steps + 1):
        after = st.replay._replace(cursor=(st.replay.cursor + t) % cap,
                                   filled=min(st.replay.filled + t, cap))
        indices = cpu.replay.draw_columns(after, cfg.updates_per_step,
                                          cfg.batch_size, draws)
        gst = merge_restored(gst, to_tree(st))
        gst, gm = card.train_step(gst, indices=indices)
        st, m = cpu.train_step(st, indices=indices)
        assert gm["rollout_impl"] == 1.0
        assert gm["learner_impl"] == m["learner_impl"] == float(
            learner == "kernel")
        worst, parted = {}, []
        want = {k: v for k, v in to_tree(st).items() if k != "rng"}
        got = {k: v for k, v in to_tree(gst).items() if k != "rng"}
        _tree_parts(got, want, "", worst, parted)
        for key in ("critic_loss", "actor_loss"):
            err = abs(float(gm[key]) - float(m[key]))
            worst[key] = (err, err / max(abs(float(m[key])), 1e-6))
        print(f"teacher-forced {label}{learner} step {step} (max abs error, "
              f"max error / scale): {fmt(worst)}", flush=True)
        for k, (e, r) in worst.items():
            e0, r0 = overall.get(k, (0.0, 0.0))
            overall[k] = (max(e0, e), max(r0, r))
        assert worst["critic_loss"][1] <= TF_LOSS_RTOL, (step, worst)
        assert worst["actor_loss"][1] <= TF_LOSS_RTOL, (step, worst)
        if parted:
            env_side = [p for p in parted if p[0].split(".")[1]
                        in TF_ENV_FIELDS + ("env_steps",)]
            assert not env_side, (step, env_side[:4])
            assert all(e <= TF_EDGE_REL * sc for _, e, sc in parted), (
                step, parted[:4])
            edge_steps.append((step, parted))
    edges = [(s, [(p, float(f"{e:.3g}"), float(f"{sc:.3g}"))
                  for p, e, sc in ps[:6]]) for s, ps in edge_steps]
    print(f"teacher-forced {label}{learner} max over {steps} steps: "
          f"{fmt(overall)}; edge steps (path, error, scale) {edges}",
          flush=True)
    assert pr.policy_rollout.launches == b2 + steps
    assert lk.ddpg_update_phase.launches == b3 + steps * (
        learner == "kernel")
    return edge_steps


@pytest.fixture(scope="module")
def ddpg_late_tree():
    """The default recipe's end on the card: `to_tree` of a DDPG state after
    TF_LATE train steps with B2 and B3 from seed 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cartpoleplusplus_tpu_torch.agents import DDPG, DDPGConfig
    from cartpoleplusplus_tpu_torch.ckpt.checkpoint import to_tree

    card = DDPG(CartPole3D(continuous_params(), num_envs=TF_ENVS,
                           device=torch.device("cuda", 0)),
                DDPGConfig(learner="kernel"))
    st = card.init(0)
    for _ in range(TF_LATE):
        st, m = card.train_step(st)
    print(f"late state: {TF_LATE} train steps on the card, last critic "
          f"loss {float(m['critic_loss']):.4g}", flush=True)
    return to_tree(st)


@pytest.mark.parametrize("start", ["early", "late"])
@pytest.mark.parametrize("learner", ["kernel", "xla"], ids=["b3", "plain"])
def test_ddpg_teacher_forced_at_the_defaults(cuda, request, learner, start):
    """32 DDPG train steps at the CLI defaults (`ddpg_teacher_forced`), from
    a state 3 CPU train steps past init and from the default recipe's end:
    the card's state holds the bars above against the CPU's every step,
    with at most TF_EDGE_STEPS edge steps (run with -s for the per-step
    errors)."""
    from cartpoleplusplus_tpu_torch.agents import DDPG, DDPGConfig
    from cartpoleplusplus_tpu_torch.ckpt.checkpoint import merge_restored

    cpu = DDPG(CartPole3D(continuous_params(), num_envs=TF_ENVS, device="cpu"),
               DDPGConfig(learner=learner))
    st = cpu.init(0)
    if start == "early":
        for _ in range(TF_WARM):
            st, _ = cpu.train_step(st)
    else:
        st = merge_restored(st, request.getfixturevalue("ddpg_late_tree"))
    edge_steps = ddpg_teacher_forced(cuda, learner, st, TF_STEPS,
                                     label=f"{start} ")
    assert len(edge_steps) <= TF_EDGE_STEPS, [s for s, _ in edge_steps]


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
        loss = lk._dqn_prepare(got, batches, 100, hidden, 5e-5, 0.99,
                               0.01, double_dqn, spill)()
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
        loss = lk._lrpg_prepare(got, window, 100, hidden, 3e-4, 0.1,
                                spill)()
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
        lk._lrpg_prepare(wide, wwin, 0, (85, 85), 1e-3, 0.1, False)()


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


@pytest.mark.parametrize("clip", [10.0, 0.05], ids=["clip10", "fires"])
def test_b7_at_the_suite_batch_matches_twin(cuda, clip):
    """B7 at the `naf.suite` cell's shapes, K 8 updates of batch 8192 on
    (256, 256), from warmed moments under the lr schedule, with the clip
    at 10 and firing: every group and the loss vector within the
    reference's kernel-vs-XLA bar (rtol 2e-4, atol 1e-5), and the same
    bits from a second run."""
    hidden = (256, 256)
    groups, batches = _b7_inputs(cuda, hidden, 8192, 8, seed=3)
    kw = dict(lr=5e-4, gamma=0.99, tau=0.01, max_grad_norm=clip,
              lr_schedule=(0.1, 5000))
    lay = lk.naf_layout(42, hidden)
    want = lk.naf_update_phase_math(
        *[lk.group_views(g, lay) for g in groups], batches, 30, hidden, **kw)
    if clip == 0.05:
        assert bool((want[5] > clip).all()), want[5]
    runs = []
    for _ in range(2):
        got = [g.clone() for g in groups]
        loss = lk.naf_update_phase(got, batches, 30, hidden, **kw)
        torch.cuda.synchronize()
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
    spill asks), at batches 200, 256 and 8192 and on both sides of the
    boundary."""
    lib = _native.load_library()
    for hidden in ((256, 256), (8,) * 5, (2449,), (2450,), (4096,),
                   (64, 48, 32)):
        torso, (net,), widths = lk._learner_shape(
            cuda, hidden, (tuple(lk.naf_layout(42, hidden)),))
        for batch in (200, 256, 8192):
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
        loss = lk._naf_prepare(got, batches, 100, hidden, kw, spill)()
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


@pytest.mark.parametrize("agent", ["dqn", "naf", "lrpg"])
def test_pixel_agent_cli_launches_b10_per_env_step(cuda, monkeypatch, agent):
    """2 pixel train steps of DQN, NAF or LRPG (512 envs, 48 x 48 gray
    uint8 frame-diff, block sampling for DQN and NAF, LRPG at rollout 8):
    B10 once per env.step, once for the initial reset and once for the
    cached reset frame, the plain rollout and learner, no other kernel;
    under CARTPOLE_RENDER_CULL=1 the same count of B11 launches
    instead."""
    from cartpoleplusplus_tpu_torch.ops import render_kernel as rk

    argv = ["--agent", agent, "--obs-mode", "pixels", "--num-envs", "512",
            "--render-grayscale", "--render-obs-uint8", "--render-frame-diff",
            "--render-frame-diff-gain", "4", "--total-env-steps", "16",
            "--log-interval", "1"]
    argv += (["--lrpg.rollout-steps", "8"] if agent == "lrpg" else
             [f"--{agent}.sample", "block",
              f"--{agent}.replay-capacity-per-env", "64"])
    others = (fr.fused_rollout, pr.policy_rollout, lk.ddpg_update_phase,
              qr.q_policy_rollout, lk.dqn_update_phase,
              nr.naf_policy_rollout, lk.naf_update_phase,
              pg.pg_policy_rollout, lk.lrpg_update_phase)
    for cull, wrapper, idle in (("0", rk.render_frames, rk.render_culled),
                                ("1", rk.render_culled, rk.render_frames)):
        monkeypatch.setenv("CARTPOLE_RENDER_CULL", cull)
        before, idle_before = wrapper.launches, idle.launches
        other = [f.launches for f in others]
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            assert train.main(argv) == 0
        steps = [json.loads(x) for x in out.getvalue().splitlines()]
        assert [m["train_step"] for m in steps] == [1, 2]
        assert wrapper.launches == before + 1 + 1 + 16
        assert idle.launches == idle_before
        assert [f.launches for f in others] == other
        assert all(m["rollout_impl"] == 0.0 and m["learner_impl"] == 0.0
                   for m in steps)
        assert steps[1]["loss"] != 0.0


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


# --- bfloat16 nets and the gym adapter on the card ---------------------------

BF16_NETS = ("actor", "critic", "qnet", "policy", "naf", "visual_actor",
             "visual_critic", "visual_qnet", "visual_policy", "visual_naf")


def _pixel_frames(cuda, n):
    """n uint8 frames of the pixels preset's env (48 x 48 gray, frame-diff
    gain 4) after 3 env-steps of random actions, rendered by B10."""
    from cartpoleplusplus_tpu_torch.env.pixels import RenderConfig

    env = CartPole3D(CartPoleParams(), num_envs=n, obs_mode="pixels",
                     device=cuda, render_config=RenderConfig(
                         grayscale=True, obs_uint8=True, frame_diff=True,
                         frame_diff_gain=4.0))
    st, _ = env.reset(0)
    g = torch.Generator().manual_seed(0)
    for _ in range(3):
        a = torch.randint(0, 5, (n,), generator=g, dtype=torch.int32)
        st, obs, *_ = env.step(st, a.to(cuda))
    return obs.cpu()


@pytest.mark.parametrize("name", BF16_NETS)
def test_bf16_net_on_the_card_matches_the_cpu(cuda, monkeypatch, name):
    """Each bfloat16 net at (256, 256), weights perturbed off their init,
    on 4096 rows (the pixel nets on B10's frames of the pixels preset at
    48 x 48), on the card against the same net on the CPU, end to end
    (bf16_parity.card_vs_cpu): the state nets inside bf16_parity.TIGHT
    (one ulp, 0.5 %), the pixel nets inside bf16_parity.PIXEL_CARD (4
    ulps, 40 %: through their convolutions a product's rounding flips
    compound);
    and with the rounding-order fault planted on the card
    (bf16_parity.fused_bias) outside the bar."""
    from cartpoleplusplus_tpu_torch.utils import bf16_parity as bp

    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", False)
    frames = _pixel_frames(cuda, 4096) if name.startswith("visual") else None
    ends, bar, faults = bp.card_vs_cpu(name, cuda, frames)
    print(name, ends, faults)
    naf = name.endswith("naf")
    assert bp.within(ends, bar, naf), ends
    assert not bp.within(faults, bar, naf), faults


@pytest.mark.parametrize("agent", ["ddpg", "dqn", "naf", "lrpg"])
def test_bf16_cli_launches_the_rollout_kernel_not_the_learner(cuda, agent):
    """`--<agent>.dtype bfloat16` at 1000 envs: the rollout kernel (B2,
    B4, B6, B8) launches once per train step from the float32 weights,
    the learner is the plain one (no B3, B5, B7 or B9), metrics finite."""
    rollout = {"ddpg": pr.policy_rollout, "dqn": qr.q_policy_rollout,
               "naf": nr.naf_policy_rollout, "lrpg": pg.pg_policy_rollout}
    learners = (lk.ddpg_update_phase, lk.dqn_update_phase,
                lk.naf_update_phase, lk.lrpg_update_phase)
    t = 32 if agent == "lrpg" else 8
    before = rollout[agent].launches
    other = [f.launches for f in learners]
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert train.main(["--agent", agent, f"--{agent}.dtype", "bfloat16",
                           "--num-envs", "1000", "--total-env-steps",
                           str(3 * t), "--log-interval", "1"]) == 0
    steps = [json.loads(x) for x in out.getvalue().splitlines()]
    assert [m["train_step"] for m in steps] == [1, 2, 3]
    assert rollout[agent].launches == before + 3
    assert [f.launches for f in learners] == other
    for m in steps:
        assert m["rollout_impl"] == 1.0 and m["learner_impl"] == 0.0
        assert all(v == v and abs(v) != float("inf") for v in m.values())


def test_gym_adapter_renders_through_b10(cuda):
    """GymCartPole3D on the card (its default device) runs an episode to
    termination beside the same adapter on the CPU; render() launches B10
    once and gives the CPU twin's uint8 frame."""
    import numpy as np

    from cartpoleplusplus_tpu_torch.env.gym_adapter import GymCartPole3D
    from cartpoleplusplus_tpu_torch.ops import render_kernel as rk

    card, cpu = GymCartPole3D(seed=3), GymCartPole3D(seed=3, device="cpu")
    assert card._env.device.type == "cuda"
    np.testing.assert_allclose(card.reset(), cpu.reset(), rtol=2e-5,
                               atol=2e-5)
    rng = np.random.RandomState(0)
    for steps in range(1, 301):
        a = card.action_space.sample(rng)
        got, want = card.step(a), cpu.step(a)
        assert got[2] == want[2]
        if got[2]:
            break
    assert got[2] and steps <= 200
    before = rk.render_frames.launches
    img = card.render()
    assert rk.render_frames.launches == before + 1
    assert img.dtype == np.uint8 and img.shape == (48, 48, 3)
    assert np.abs(img.astype(int) - cpu.render().astype(int)).max() <= 1


# --- learner_precision: B3, B5, B7 and B9 at bfloat16 and TF32 ----------------

PRECISIONS = ("bfloat16", "tensorfloat32", "BF16_BF16_F32_X3",
              "BF16_BF16_F32_X6", "F64_F64_F64", "F16_F16_F16")
# The modes within the learners' bar of float32 (the product probe below
# tells them apart; _check_modes requires bits other than float32's).
PROBED = ("BF16_BF16_F32_X3", "BF16_BF16_F32_X6", "F64_F64_F64")
# The modes within float32's rounding of float32: a LayerNorm output that
# close to the relu edge falls either way, so the kernel is held to the
# nearer of the twin at its mode and the float32 twin, tensor by tensor
# (chip_smoke.py's NEAR_F32_MODES).
NEAR_F32 = ("BF16_BF16_F32_X6", "F64_F64_F64")
# The relative part of the one-update normwise bar: the learners', and at
# F16 one float16 step (2^-10).
ONE_UPDATE_RTOL = {p: 2e-4 for p in PRECISIONS}
ONE_UPDATE_RTOL["F16_F16_F16"] = 2.0 ** -10
# The reference's bar for its bfloat16 kernel learner against its float32
# plain learner (tests/test_learner_kernel.py:545-578).
REF_BAR = dict(rtol=2e-2, atol=2e-3)
# The share of all the elements that a reduced-mode kernel may have past
# the learners' elementwise bar against its twin, where the float32 kernel
# must have more (_check_modes; PERF.md §6 has the readings behind each):
# after one update (B9: its one window), and B3, B5 and B7 after K 4; per
# mode where they differ.
ONE_UPDATE_SHARE = {p: 1e-5 for p in PRECISIONS}
ONE_UPDATE_SHARE["F16_F16_F16"] = 3e-4
B3_K_SHARE = {p: 0.03 for p in PRECISIONS}
B3_K_SHARE["F16_F16_F16"] = 0.015
B5_K_SHARE = {p: 0.01 for p in PRECISIONS}
B7_K_SHARE = {p: 0.0 for p in PRECISIONS}
B7_K_SHARE["F16_F16_F16"] = 1e-3


def _outside(got, want, rtol=2e-4, atol=1e-5) -> int:
    """Elements of the tensor lists outside the bar."""
    return sum(int((~torch.isclose(a, b, rtol=rtol, atol=atol)).sum())
               for a, b in zip(got, want))


def _flat(groups, losses):
    return [x for g in groups for x in g] + list(losses)


def _check_modes(run_kernel, run_twin, precision, one_update: bool,
                 nets: int, share: float):
    """The kernel at `precision` against its twin at the same mode (each
    run gives its groups' parameter lists and its losses; the first `nets`
    groups are the networks and targets, the rest Adam's moments), one
    counted launch and the same bits from a second run.

    At most `share` (per mode) of all the elements lie past the learners'
    elementwise bar (rtol 2e-4, atol 1e-5), and the float32 kernel against
    the same twin has more past it than that limit: the check tells the
    modes apart; at X3, X6 and F64, which lie within that bar of float32,
    the kernel's bits differ from float32's instead (the product probe
    tells those modes apart), and at X6 and F64 the nearer of the twin at
    the mode and the float32 twin is the reference (NEAR_F32). With
    rounded operands an ulp between two summation orders
    moves an operand by a whole bfloat16 or TF32 step where it crosses a
    rounding edge (the twin on the card and the twin on the CPU part the
    same way), so a few elements part. Besides, after one update (or
    B9's one window) each tensor is held normwise to the learners' bar
    (max error <= 1e-5 + 2e-4 x the tensor's largest magnitude); from the
    second update on the weights differ by such steps too and a few
    LayerNorm outputs flip at the relu edge, and after several updates
    the networks, targets and losses are held to the reference's
    bfloat16 bar (rtol 2e-2, atol 2e-3)."""
    want_g, want_l = run_twin(precision)
    (got_g, got_l), launched = run_kernel(precision)
    assert launched == 1
    got, want = _flat(got_g, got_l), _flat(want_g, want_l)
    if precision in NEAR_F32:
        want = [w if float((g - w).abs().max()) <= float((g - w32).abs()
                                                          .max()) else w32
                for g, w, w32 in zip(got, want, _flat(*run_twin(None)))]
    f32 = _flat(*run_kernel(None)[0])
    limit = int(share[precision] * sum(x.numel() for x in got))
    counts = (_outside(got, want), limit, _outside(f32, want))
    if precision in PROBED:
        assert counts[0] <= limit, counts
        assert not all(torch.equal(a, b) for a, b in zip(got, f32))
    else:
        assert counts[0] <= limit < counts[2], counts
    if one_update:
        rtol = ONE_UPDATE_RTOL[precision]
        for i, (a, b) in enumerate(zip(got, want)):
            err = float((a - b).abs().max())
            assert err <= 1e-5 + rtol * float(b.abs().max()), (i, err)
    else:
        n_held, n_loss = sum(len(g) for g in got_g[:nets]), len(got_l)
        for a, b in zip(got[:n_held] + got[-n_loss:],
                        want[:n_held] + want[-n_loss:]):
            torch.testing.assert_close(a, b, **REF_BAR)
    (again_g, again_l), _ = run_kernel(precision)
    assert all(torch.equal(a, b) for a, b in zip(got,
                                                 _flat(again_g, again_l)))


def _b3_case(cuda, k, agc, hidden=(256, 256), batch=200):
    """B3 at `hidden` (default (256, 256)), batch 200 (a ragged row tile),
    K updates from warmed moments: (kernel(p), twin(p)) as _check_modes
    takes them."""
    hidden = tuple(hidden)
    groups, batches = _b3_inputs(cuda, hidden, batch, k, seed=2)
    kw = dict(actor_lr=1e-3, critic_lr=2e-3, gamma=0.99, tau=0.05,
              actor_grad_critic=agc, lr_schedule=(0.1, 50))
    la, lc = lk.actor_layout(42, hidden), lk.critic_layout(42, hidden)
    lays = (la, lc, la, lc, la, la, lc, lc)

    def twin(p):
        out = lk.update_phase_math(
            *[lk.group_views(g, lay) for g, lay in zip(groups, lays)],
            batches, 30, hidden, mm_precision=p, **kw)
        return out[:8], out[8:]

    def kernel(p):
        got = [g.clone() for g in groups]
        before = lk.ddpg_update_phase.launches
        losses = lk.ddpg_update_phase(got, batches, 30, hidden,
                                      mm_precision=p, **kw)
        torch.cuda.synchronize()
        views = [lk.group_views(g, lay) for g, lay in zip(got, lays)]
        return (views, losses), lk.ddpg_update_phase.launches - before

    return kernel, twin


def _b5_case(cuda, k):
    """B5 at (256, 256), batch 200, K updates from warmed moments."""
    hidden = (256, 256)
    groups, batches = _b5_inputs(cuda, hidden, 200, k, seed=2)
    kw = dict(lr=1e-3, gamma=0.99, tau=0.05, double_dqn=True)
    lay = lk.qnet_layout(42, hidden)

    def twin(p):
        out = lk.dqn_update_phase_math(
            *[lk.group_views(g, lay) for g in groups], batches, 30, hidden,
            mm_precision=p, **kw)
        return out[:4], out[4:]

    def kernel(p):
        got = [g.clone() for g in groups]
        before = lk.dqn_update_phase.launches
        loss = lk.dqn_update_phase(got, batches, 30, hidden, mm_precision=p,
                                   **kw)
        torch.cuda.synchronize()
        views = [lk.group_views(g, lay) for g in got]
        return (views, [loss]), lk.dqn_update_phase.launches - before

    return kernel, twin


def _b7_case(cuda, k, clip):
    """B7 at (256, 256), batch 200, K updates from warmed moments, the lr
    schedule on, the clip at `clip`."""
    hidden = (256, 256)
    groups, batches = _b7_inputs(cuda, hidden, 200, k, seed=2)
    kw = dict(lr=1e-3, gamma=0.99, tau=0.05, max_grad_norm=clip,
              lr_schedule=(0.1, 50))
    lay = lk.naf_layout(42, hidden)

    def twin(p):
        out = lk.naf_update_phase_math(
            *[lk.group_views(g, lay) for g in groups], batches, 30, hidden,
            mm_precision=p, **kw)
        return out[:4], out[4:5]

    def kernel(p):
        got = [g.clone() for g in groups]
        before = lk.naf_update_phase.launches
        loss = lk.naf_update_phase(got, batches, 30, hidden, mm_precision=p,
                                   **kw)
        torch.cuda.synchronize()
        views = [lk.group_views(g, lay) for g in got]
        return (views, [loss]), lk.naf_update_phase.launches - before

    return kernel, twin


def _b9_case(cuda, hidden, n, seed=2):
    """B9's one update over n rows from warmed moments."""
    groups, window = _b9_inputs(cuda, hidden, n, seed=seed)
    kw = dict(lr=3e-4, entropy_coef=0.1)
    lay = lk.policy_layout(42, hidden)

    def twin(p):
        out = lk.lrpg_update_phase_math(
            *[lk.group_views(g, lay) for g in groups], window, 100, hidden,
            mm_precision=p, **kw)
        return out[:3], out[3:]

    def kernel(p):
        got = [g.clone() for g in groups]
        before = lk.lrpg_update_phase.launches
        loss = lk.lrpg_update_phase(got, window, 100, hidden, mm_precision=p,
                                    **kw)
        torch.cuda.synchronize()
        views = [lk.group_views(g, lay) for g in got]
        return (views, [loss]), lk.lrpg_update_phase.launches - before

    return kernel, twin


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("agc", ["updated", "pre"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_b3_at_reduced_precision_matches_its_twin(cuda, precision, agc, k):
    """B3 at (256, 256), batch 200 (a ragged row tile), K 1 and 4 from
    warmed moments, at both actor_grad_critic values."""
    _check_modes(*_b3_case(cuda, k, agc), precision, k == 1, 4,
                 ONE_UPDATE_SHARE if k == 1 else B3_K_SHARE)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_b5_at_reduced_precision_matches_its_twin(cuda, precision, k):
    """B5 at (256, 256), batch 200, K 1 and 4 from warmed moments."""
    _check_modes(*_b5_case(cuda, k), precision, k == 1, 2,
                 ONE_UPDATE_SHARE if k == 1 else B5_K_SHARE)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("clip", [10.0, 0.0], ids=["clip10", "noclip"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_b7_at_reduced_precision_matches_its_twin(cuda, precision, clip, k):
    """B7 at (256, 256), batch 200, K 1 and 4 from warmed moments, the lr
    schedule on, with the clip at 10 and off."""
    _check_modes(*_b7_case(cuda, k, clip), precision, k == 1, 2,
                 ONE_UPDATE_SHARE if k == 1 else B7_K_SHARE)


@pytest.mark.parametrize("hidden,n", [((64, 64), 1000), ((256, 300), 777)],
                         ids=["smem", "workspace"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_b9_at_reduced_precision_matches_its_twin(cuda, precision, hidden, n):
    """B9's one update from warmed moments on both of its routes (shared
    memory at (64, 64), the workspace at (256, 300))."""
    _check_modes(*_b9_case(cuda, hidden, n), precision, True, 1,
                 ONE_UPDATE_SHARE)


def _ulps(got, want) -> float:
    """Mean distance of got from want over all the elements, in ulps of
    want's element, each capped at 64 (chip_smoke.py's _ulps)."""
    total, n = 0.0, 0
    for a, b in zip(got, want):
        mag = b.abs()
        ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
        total += float(((a.double() - b.double()).abs() / ulp.double())
                       .clamp(max=64).sum())
        n += a.numel()
    return total / n


@pytest.mark.parametrize("case", [
    "B3 updated", "B3 pre", "B5", "B7 clip10", "B7 noclip", "B9 smem",
    "B9 workspace"])
def test_each_preset_runs_its_own_instance(cuda, case):
    """After one update, the kernel at each of float32, X3, X6 and F64
    against the twin at each (chip_smoke.py's _mode_identity): X3's kernel
    nearest its own twin and each other kernel nearer another twin than
    X3's, by a factor of 1.4 at least; against the nearer of the float32
    and F64 twins, F64's kernel nearer than float32's and float32's nearer
    than X6's by 1.2 at least (exact dots; one rounding a product; six)."""
    kernel, twin = {
        "B3 updated": lambda: _b3_case(cuda, 1, "updated"),
        "B3 pre": lambda: _b3_case(cuda, 1, "pre"),
        "B5": lambda: _b5_case(cuda, 1),
        "B7 clip10": lambda: _b7_case(cuda, 1, 10.0),
        "B7 noclip": lambda: _b7_case(cuda, 1, 0.0),
        "B9 smem": lambda: _b9_case(cuda, (64, 64), 1000),
        "B9 workspace": lambda: _b9_case(cuda, (256, 300), 777),
    }[case]()
    modes = (None, "BF16_BF16_F32_X3", "BF16_BF16_F32_X6", "F64_F64_F64")
    got = {p: _flat(*kernel(p)[0]) for p in modes}
    want = {q: _flat(*twin(q)) for q in modes}
    d = {p: {q: _ulps(got[p], want[q]) for q in modes} for p in modes}
    x3, x6, f64 = modes[1:]
    assert d[x3][x3] * 1.4 <= min(d[x3][q] for q in modes if q != x3), d
    for p in (None, x6, f64):
        assert min(d[p][q] for q in modes if q != x3) * 1.4 <= d[p][x3], d
    err = {p: min(d[p][None], d[p][f64]) for p in modes}
    assert err[f64] * 1.2 <= err[None] and err[None] * 1.2 <= err[x6], (
        err, d)


@pytest.mark.parametrize("agent", ["ddpg", "dqn", "naf", "lrpg"])
def test_learner_precision_cli_launches_the_learner_kernel(cuda, agent):
    """`--<agent>.learner-precision bfloat16` at 1000 envs for 8 train
    steps: the learner kernel launches as often as at float32 (7 past
    DDPG's, DQN's and NAF's warmup, 8 for LRPG), learner_impl 1.0,
    metrics finite."""
    learner = {"ddpg": lk.ddpg_update_phase, "dqn": lk.dqn_update_phase,
               "naf": lk.naf_update_phase, "lrpg": lk.lrpg_update_phase}
    t = 32 if agent == "lrpg" else 8
    launches = {}
    for precision in (None, "bfloat16"):
        argv = ["--agent", agent, "--num-envs", "1000", "--total-env-steps",
                str(8 * t), "--log-interval", "1", f"--{agent}.learner",
                "kernel"]
        if precision is not None:
            argv += [f"--{agent}.learner-precision", precision]
        before = learner[agent].launches
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            assert train.main(argv) == 0
        launches[precision] = learner[agent].launches - before
        steps = [json.loads(x) for x in out.getvalue().splitlines()]
        assert len(steps) == 8
        assert all(v == v and abs(v) != float("inf")
                   for m in steps for v in m.values())
        assert steps[-1]["learner_impl"] == 1.0
    assert launches["bfloat16"] == launches[None] == (
        8 if agent == "lrpg" else 7)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_b9_routes_give_the_same_bits_at_every_mode(cuda, precision):
    """At each product mode the shared-memory route and the workspace route
    of B9 give the same bits at (64, 64), where both take the network (at
    F64 with its accumulators in double)."""
    hidden, mode = (64, 64), lk.mm_mode(precision)
    assert not lk.pg_tile_spills(42, hidden, mode)
    groups, window = _b9_inputs(cuda, hidden, 1000, seed=4)
    runs = []
    for spill in (False, True):
        got = [g.clone() for g in groups]
        loss = lk._lrpg_prepare(got, window, 100, hidden, 3e-4, 0.1,
                                spill, mode)()
        torch.cuda.synchronize()
        runs.append(got + [loss])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_b9_at_f64_takes_the_workspace_route_where_doubles_do_not_fit(cuda):
    """At (80, 80) the float32 block fits in shared memory and F64's (its
    accumulators in double) does not: the library rejects F64's
    shared-memory route, and the wrapper takes the workspace route at F64
    (never float32's instance), within the learners' bar of the twin at
    F64 (or of the float32 twin, the nearer, as _check_modes holds F64)."""
    hidden = (80, 80)
    assert not lk.pg_tile_spills(42, hidden)
    assert lk.pg_tile_spills(42, hidden, lk.F64)
    groups, window = _b9_inputs(cuda, hidden, 1000, seed=5)
    with pytest.raises(ValueError, match="rejected"):
        lk._lrpg_prepare([g.clone() for g in groups], window, 100, hidden,
                         3e-4, 0.1, False, lk.F64)()
    _check_modes(*_b9_case(cuda, hidden, 1000, seed=5), "F64_F64_F64", True,
                 1, ONE_UPDATE_SHARE)


def test_product_probe_tells_the_modes_apart(cuda):
    """csrc/mm_probe.cu (the learners' product helpers alone) at every mode
    on lk.probe_operands: equal bit for bit to its own mode's exact chain
    (lk.mm_chain on the CPU, the probe's plain version) and apart from
    every other mode's in more than a tenth of the elements."""
    a, b = lk.probe_operands(np.random.RandomState(3), rows=32, cols=48)
    chains = [lk.mm_chain(a, b, m) for m in range(len(lk.MODE_NAMES))]
    for m, name in enumerate(lk.MODE_NAMES):
        got = lk.mm_probe(torch.from_numpy(a).to(cuda),
                          torch.from_numpy(b).to(cuda), m).cpu().numpy()
        for i, c in enumerate(chains):
            share = float((got.view(np.uint32) != c.view(np.uint32)).mean())
            assert (share == 0.0) if i == m else (share > 0.1), (name, i,
                                                                 share)


def test_split_on_the_card_is_the_cpus(cuda):
    """Each mode's operand as the card's product helpers take it (X3's and
    X6's bfloat16 parts, the rounded operand) equals the CPU's
    (split_operand, round_operand) bit for bit on 100,000 random float32
    patterns and the rounding edges; NaN where the CPU's is NaN."""
    rng = np.random.RandomState(4)
    bits = np.concatenate([
        np.array([0, 0x80000000, 1, 0x3F808000, 0x7F7F7FFF, 0x7F7F8000,
                  0x7F800000, 0xFF800000, 0x7FC00000], np.uint32),
        rng.randint(0, 2 ** 32, 100000, dtype=np.uint64).astype(np.uint32)])
    x = torch.from_numpy(bits.view(np.float32).copy())
    for m in range(len(lk.MODE_NAMES)):
        got = lk.mm_split(x.to(cuda), m).cpu().numpy()
        want = lk.mm_split(x, m).numpy()
        nan = np.isnan(want)
        assert np.array_equal(np.isnan(got), nan)
        assert np.array_equal(got[~nan].view(np.uint32),
                              want[~nan].view(np.uint32))


# --- the tensor cores' products of B3 and B9 -----------------------------

TC_PRECISIONS = ("bfloat16", "tensorfloat32", "BF16_BF16_F32_X3",
                 "BF16_BF16_F32_X6", "F16_F16_F16")
B3_TC_PRECISIONS = ("bfloat16", "BF16_BF16_F32_X3", "F16_F16_F16")


@pytest.mark.parametrize("precision", (None,) + PRECISIONS)
def test_each_mode_reports_its_instance(cuda, precision):
    """The id each instance of B3 and B9 writes from inside the kernel
    (lk.last_instance): its mode, plus lk.INSTANCE_TC where its products
    run on the tensor cores, B9 at bfloat16, TF32, X3, X6 and F16 and B3
    at bfloat16, X3 and F16 (lk.TC_MODES_OF: an fmaf instance there
    fails, and so does a tensor-core one elsewhere); float32, F64 and
    B3's TF32 and X6 keep their chains. B3 at batch 200, K 1, both
    actor_grad_critic values; B9 on both routes."""
    mode = lk.mm_mode(precision)
    want = mode + (lk.INSTANCE_TC if mode in lk.TC_MODES_OF["B3"] else 0)
    for agc in ("updated", "pre"):
        kernel, _ = _b3_case(cuda, 1, agc, hidden=(72, 40))
        lk._instances.clear()
        kernel(precision)
        assert lk.last_instance("B3", cuda) == want, (agc, precision)
    want = mode + (lk.INSTANCE_TC if mode in lk.TC_MODES_OF["B9"] else 0)
    for hidden, n in (((64, 64), 1000), ((256, 300), 777)):
        kernel, _ = _b9_case(cuda, hidden, n)
        lk._instances.clear()
        kernel(precision)
        assert lk.last_instance("B9", cuda) == want, (hidden, precision)


def test_mma_probe_matches_its_plain_version(cuda):
    """csrc/mm_probe.cu's tensor-core probe (B3's and B9's fragment
    helpers alone) at each tensor-core mode equals lk.mma_chain bit for bit
    on lk.mma_probe_operands, whose block sums are exact (the fragments'
    layouts, the passes' parts and their order), and on general operands
    (lk.probe_operands) lies within float32's summation rounding of the
    twin's product at that mode; and the operands as the hardware's
    conversions give them (lk.mma_split) equal to the CPU's split bit for
    bit on edge patterns and 100,000 random ones."""
    rng = np.random.RandomState(11)
    bits = np.concatenate([
        np.array([0, 0x80000000, 1, 0x3F808000, 0x3F801000, 0x7F7F7FFF,
                  0x7F7F8000, 0x7F7FF000, 0x477FF000, 0x7F800000,
                  0xFF800000, 0x7FC00000, 0x7F800001], np.uint32),
        rng.randint(0, 2 ** 32, 100000, dtype=np.uint64).astype(np.uint32)])
    x = torch.from_numpy(bits.view(np.float32).copy())
    for mode in lk.TC_MODES:
        got = lk.mma_split(x.to(cuda), mode).cpu().numpy()
        want = lk.mm_split(x, mode).numpy()
        nan = np.isnan(want)
        assert np.array_equal(np.isnan(got), nan)
        assert np.array_equal(got[~nan].view(np.uint32),
                              want[~nan].view(np.uint32)), lk.MODE_NAMES[mode]
        a, b = lk.mma_probe_operands(np.random.RandomState(9), mode)
        got = lk.mma_probe(torch.from_numpy(a).to(cuda),
                           torch.from_numpy(b).to(cuda), mode).cpu().numpy()
        want = lk.mma_chain(a, b, mode)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), \
            lk.MODE_NAMES[mode]
        a, b = lk.probe_operands(np.random.RandomState(10), rows=32,
                                 cols=48)
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        got = lk.mma_probe(ta.to(cuda), tb.to(cuda), mode).cpu().double()
        twin = lk._mm(ta, tb, mode).double()
        mag = (ta.double().abs() @ tb.double().abs())
        bar = 1e-5 * mag + (2.0 ** -10 * twin.abs() if mode == lk.F16
                            else 0.0)
        assert bool(((got - twin).abs() <= bar).all()), lk.MODE_NAMES[mode]


@pytest.mark.parametrize("hidden", [(72, 40), (72, 40, 20)], ids=str)
@pytest.mark.parametrize("precision", B3_TC_PRECISIONS)
def test_b3_on_the_tensor_cores_off_the_tile_widths(cuda, precision,
                                                    hidden):
    """B3 at widths that are no multiple of the mma tiles (72 and 40 of 16,
    20 of 8) and at depth 3, one update at both actor_grad_critic values,
    against its twin at the same mode (_check_modes, one update)."""
    for agc in ("updated", "pre"):
        _check_modes(*_b3_case(cuda, 1, agc, hidden=hidden), precision, True,
                     4, ONE_UPDATE_SHARE)


@pytest.mark.parametrize("precision", B3_TC_PRECISIONS)
def test_b3_on_the_tensor_cores_at_batch_8192(cuda, precision):
    """B3 at the fast preset's batch 8192 (the weight gradients' sums over
    512 k-blocks), K 1, against its twin at the same mode."""
    _check_modes(*_b3_case(cuda, 1, "updated", batch=8192), precision, True,
                 4, ONE_UPDATE_SHARE)


@pytest.mark.parametrize("hidden", [(72, 40), (72, 40, 20)], ids=str)
@pytest.mark.parametrize("precision", TC_PRECISIONS)
def test_b9_on_the_tensor_cores_off_the_tile_widths(cuda, precision,
                                                    hidden):
    """B9 at widths that are no multiple of the mma tiles and at depth 3:
    against its twin at the same mode, and its two routes (the packed
    weights in shared memory, the weights converted from the group buffer)
    give the same bits."""
    _check_modes(*_b9_case(cuda, hidden, 1000), precision, True, 1,
                 ONE_UPDATE_SHARE)
    mode = lk.mm_mode(precision)
    assert not lk.pg_tile_spills(42, hidden, mode)
    groups, window = _b9_inputs(cuda, hidden, 1000, seed=4)
    runs = []
    for spill in (False, True):
        got = [g.clone() for g in groups]
        loss = lk._lrpg_prepare(got, window, 100, hidden, 3e-4, 0.1,
                                spill, mode)()
        torch.cuda.synchronize()
        runs.append(got + [loss])
    assert all(torch.equal(a, b) for a, b in zip(*runs))



# sha256 of the learners' outputs that keep their fmaf (DFMA) instances:
# B5 and B7 at every mode, B3 at float32, TF32, X6 and F64, B9 at float32
# and F64 (learner_digests),
# recorded from the kernels as they were before B3's and B9's tensor-core
# instances, on an NVIDIA H100 80GB HBM3.
FMAF_DIGESTS = {
    "B5 float32":
        "3c9fe689ad565d12ed578b980f67484f5e02322032f90c93f78ffd5d04cb7770",
    "B5 bfloat16":
        "f38f80f8c1a99642667cf7eefc9871e5fc27bb18d2cc6217973ccfc16e8a5a99",
    "B5 tensorfloat32":
        "a088d1c8b7aef002524bffd417ba344f9126dcc6c94e5f470c3d5a8a2a5e929c",
    "B5 BF16_BF16_F32_X3":
        "686079d9099736d00b9d206ad7e34fb6d4d7bc9b8f4d2db59e9db90a9a5c0da8",
    "B5 BF16_BF16_F32_X6":
        "5eb0848cee51dfaebff2e09a7a7b8cd49b9764149f2fde4371e9d1db80831d15",
    "B5 F64_F64_F64":
        "338024b5f3ed0c41baf1d09b330b742696d620e5d99df91340f156dc4a9e1872",
    "B5 F16_F16_F16":
        "b5a09bd1d58eec3fc0578cbef642ac66f67a3b7b3e84ac89012092838e857fff",
    "B7 clip10 float32":
        "b43e29ea48e6f2e6800aabb1b5cf1d6946ddf7422b1ef4c15c3445dc59634606",
    "B7 clip10 bfloat16":
        "0196f152fe138113f8e86dc84b62c2c4a08e3e408b5cd18c30c66b66dd62707e",
    "B7 clip10 tensorfloat32":
        "7eca4e8ed642f3034634b4af673874403cd7bc6b8fcaf78a9dd2fda5e4fc6368",
    "B7 clip10 BF16_BF16_F32_X3":
        "927b5a75ceac31e24e519943e8f37e847622a62a5e67ea77f01531fd9c8d98d0",
    "B7 clip10 BF16_BF16_F32_X6":
        "e9ed5ba8ae0d9397f34056b9ae8fddb7c0e923e8f0e5158c532738f771c4bcd0",
    "B7 clip10 F64_F64_F64":
        "ba9f96afe69b24bd43fd5eeda52a9cf58b87a058b1d77492957b21a9b85b29e0",
    "B7 clip10 F16_F16_F16":
        "1e97e2660844dec7c45033343d58805a7308e16df54b7fccfe59be80eafa190c",
    "B7 noclip float32":
        "9337b91a0be83bafe106d58091094bb6bcc6ec9aa3f852851ea6125e7872cd36",
    "B7 noclip bfloat16":
        "0d95675acadb938520a84cf459a42c9a50c84085a7e4cc9e353cfdce90396952",
    "B7 noclip tensorfloat32":
        "0b934d12af8eaa5401e9f49c4faf44d7b48fa38dc6d9cbf4e291a7ad7a72d9cc",
    "B7 noclip BF16_BF16_F32_X3":
        "300563d056802b9f84486a8fc8eb5bf19aa5a3f285198e65fcfd263e855fe9ff",
    "B7 noclip BF16_BF16_F32_X6":
        "2fecd72e830f5404d5a2a46737bd1ad5adda38390c21f5d3119dc2a32112e7be",
    "B7 noclip F64_F64_F64":
        "b781ee5d03b5637fda02fb1b006257ef9bfe15bc95a449bbc44ce46c958c60a0",
    "B7 noclip F16_F16_F16":
        "227043a8a9162d660459f144aef028bdbe39ca4c7e1485bac862b4f84bccc502",
    "B3 updated float32":
        "7d410445f5e5c9b72691b1019bc05ebd16073a512288e26a40efe2b201108d80",
    "B3 updated tensorfloat32":
        "49d3c8988de147802c446d6388cd920589f9c90c42a126ee9d39209f480aad56",
    "B3 updated BF16_BF16_F32_X6":
        "cb916c06493ad940dd27f4f08b344b0d0aaba683d29ff1691dd54ca16010f757",
    "B3 updated F64_F64_F64":
        "3cdf45cdac566d49c350f1577bba5a156995546f75556af0abee9490e3f82738",
    "B3 pre float32":
        "2d71621c2fafe725c6dbd77cb6ac9dea7b167dc9c8e85fc4cb9672d086c99863",
    "B3 pre tensorfloat32":
        "5b45e0fd01ec788540867c57ee2a75ca51c53f39e0d93d9f0d0b167737adfabc",
    "B3 pre BF16_BF16_F32_X6":
        "3318b415119fe03eec6a66eac4c98b799604bc743d49fd3a71cb6a1d535f3e4f",
    "B3 pre F64_F64_F64":
        "f98ce6080f4118695b6e879149def3e6f16b2c3c3396c20a6d2278c77a651fab",
    "B9 smem float32":
        "fa999cf042b756b5a5750c9df6d980ba4d30e8cf55da66fd3539eadf4555b3e7",
    "B9 smem F64_F64_F64":
        "562cfe6a12c4e6b9949a74e9e11a78ae2ced58000efe4f1b0a4f4b05e3a7c3e2",
    "B9 workspace float32":
        "eb884109cb546f74252510e785da3b32799ec3057d154851e680dcb65366efea",
    "B9 workspace F64_F64_F64":
        "9bfaa38655b7eb05c1dd3f706ae090c2f8558d04ade453bfc6d44fe4eb8ed284"}


def learner_digests(cuda) -> dict:
    """sha256 of each case's outputs (every group after the phase, then
    the losses, as bytes) from the fixed inputs of _b3_case, _b5_case,
    _b7_case and _b9_case: B5 (K 4) and B7 (K 4, the clip at 10 and off)
    at float32 and every mode, B3 (K 4, "updated" and "pre") at float32,
    TF32, X6 and F64, and B9 (N 1000 at (64, 64), N 777 at (256, 300)) at
    float32 and F64."""
    import hashlib

    every = (None,) + PRECISIONS
    b3 = (None, "tensorfloat32", "BF16_BF16_F32_X6", "F64_F64_F64")
    cases = {"B5": (lambda: _b5_case(cuda, 4), every),
             "B7 clip10": (lambda: _b7_case(cuda, 4, 10.0), every),
             "B7 noclip": (lambda: _b7_case(cuda, 4, 0.0), every),
             "B3 updated": (lambda: _b3_case(cuda, 4, "updated"), b3),
             "B3 pre": (lambda: _b3_case(cuda, 4, "pre"), b3),
             "B9 smem": (lambda: _b9_case(cuda, (64, 64), 1000),
                         (None, "F64_F64_F64")),
             "B9 workspace": (lambda: _b9_case(cuda, (256, 300), 777),
                              (None, "F64_F64_F64"))}
    out = {}
    for name, (make, modes) in cases.items():
        kernel, _ = make()
        for p in modes:
            h = hashlib.sha256()
            for x in _flat(*kernel(p)[0]):
                h.update(x.detach().cpu().contiguous().numpy().tobytes())
            out[f"{name} {p or 'float32'}"] = h.hexdigest()
    return out


def test_fmaf_instances_keep_their_bits(cuda):
    """B5 and B7 at every mode, B3 at float32, TF32, X6 and F64 and B9 at
    float32 and F64 give the bits they gave before B3's and B9's tensor-core
    instances (FMAF_DIGESTS): the shared row chains and product helpers
    run the same arithmetic there."""
    got = learner_digests(cuda)
    assert set(got) == set(FMAF_DIGESTS)
    assert {k: v for k, v in got.items() if FMAF_DIGESTS[k] != v} == {}


# --- the host spans (utils/spans.py) --------------------------------------

def _spans_opened(run) -> dict:
    """{name: count} of the cp.* spans that `run()` opens under a
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.name.startswith("cp."):
            out[e.name] = out.get(e.name, 0) + 1
    return out


def test_each_launch_opens_one_prep_span(cuda):
    """Every kernel's wrapper, launched once under a profiler, opens its
    cp.prep.<Bn> span once and no other span."""
    from cartpoleplusplus_tpu_torch.env import pixels as px
    from cartpoleplusplus_tpu_torch.ops import render_kernel as rk

    h = (64, 64)
    cont = CartPole3D(continuous_params(), num_envs=B, device=cuda)
    disc = CartPole3D(CartPoleParams(), num_envs=B, device=cuda)
    (cs, co), (ds, do) = cont.reset(9), disc.reset(9)
    actor, q = _random_actor(cuda, h, 1), _random_qnet(cuda, h, 1)
    naf, policy = _random_naf(cuda, h, 1), _random_policy(cuda, h, 1)
    noise = torch.zeros((B, 2), device=cuda)
    g3, b3 = _b3_inputs(cuda, h, 200, 2, seed=2)
    g5, b5 = _b5_inputs(cuda, h, 200, 2, seed=2)
    g7, b7 = _b7_inputs(cuda, h, 200, 2, seed=2)
    g9, w9 = _b9_inputs(cuda, h, 1000, seed=2)
    p, phys = continuous_params(), _pixel_poses(cuda, B, seed=1)
    cfg = px.RenderConfig(width=48, height=48, grayscale=True)
    runs = {
        "B1": lambda: fr.fused_rollout(disc, ds, 3),
        "B2": lambda: pr.policy_rollout(cont, actor, 0.15, cs, co, noise, 7,
                                        0.2, 3),
        "B3": lambda: lk.ddpg_update_phase(g3, b3, 30, h, actor_lr=1e-3,
                                           critic_lr=2e-3, gamma=0.99,
                                           tau=0.05),
        "B4": lambda: qr.q_policy_rollout(disc, q, ds, do, 7, 0.3, 3),
        "B5": lambda: lk.dqn_update_phase(g5, b5, 30, h, lr=1e-3,
                                          gamma=0.99, tau=0.05),
        "B6": lambda: nr.naf_policy_rollout(cont, naf, cs, co, 7, 0.2, 3),
        "B7": lambda: lk.naf_update_phase(g7, b7, 30, h, lr=1e-3,
                                          gamma=0.99, tau=0.05,
                                          max_grad_norm=10.0),
        "B8": lambda: pg.pg_policy_rollout(disc, policy, ds, do, 7, 3),
        "B9": lambda: lk.lrpg_update_phase(g9, w9, 100, h, lr=3e-4,
                                           entropy_coef=0.1),
        "B10": lambda: rk.render_frames(p, cfg, phys),
        "B11": lambda: rk.render_culled(p, cfg, phys),
    }
    got = {k: _spans_opened(run) for k, run in runs.items()}
    assert got == {k: {f"cp.prep.{k}": 1} for k in runs}


# The suite cadence of the benchmark's `*.suite` cells.
SUITE = dict(rollout_steps=64, updates_per_step=8, batch_size=8192,
             warmup_env_steps=0)


@pytest.mark.parametrize("agent", ["ddpg", "dqn", "naf"])
def test_every_sync_of_a_train_step_lies_in_a_wait_span(cuda, agent,
                                                        monkeypatch):
    """10 train steps at the benchmark cells' settings (DDPG at its
    defaults over 4096 envs; DQN, and NAF with its kernel learner, over
    4096 envs at rollout 64 and K 8 updates of batch 8192): torch's sync
    debug mode reports no synchronisation at all, and each step crosses
    the cp.wait site `indices` once without one (the index copy is staged
    through page-locked memory), so the host never blocks on the card
    there."""
    import warnings

    from cartpoleplusplus_tpu_torch.utils import spans

    if agent == "ddpg":
        a = _card_agent(cuda, "ddpg")
    elif agent == "dqn":
        a = _card_agent(cuda, "dqn", **SUITE)
    else:
        a = _card_agent(cuda, "naf", learner="auto", **SUITE)
        assert a.kernel_mode and a.kernel_rollout
    st = a.init(5)
    for _ in range(3):   # past the warm-up and every first call's caches
        st, _ = a.train_step(st)
    torch.cuda.synchronize()
    real, crossed = spans.span, []
    before = sum(spans.wait.counts.values())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def syncs():
            return sum("called a synchronizing" in str(w.message)
                       for w in caught)

        @contextlib.contextmanager
        def watched(name, args=None):
            n = syncs()
            with real(name, args):
                yield
            if name.startswith("cp.wait."):
                crossed.append((name, syncs() - n))

        monkeypatch.setattr(spans, "span", watched)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(10):
                st, _ = a.train_step(st)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert crossed == [("cp.wait.indices", 0)] * 10
    assert sum(spans.wait.counts.values()) - before == 10
    assert syncs() == 0


# --- the staged index copy (agents/replay.py::ReplayBuffer._to_ring) -------

def _card_agent(cuda, name, **cfg):
    """The agent `name` over 4096 envs on the card, its config's defaults
    but for `cfg`."""
    from cartpoleplusplus_tpu_torch.agents import (DDPG, DQN, NAF,
                                                   DDPGConfig, DQNConfig,
                                                   NAFConfig)

    cls, cfg_cls, params = {
        "ddpg": (DDPG, DDPGConfig, continuous_params()),
        "dqn": (DQN, DQNConfig, CartPoleParams()),
        "naf": (NAF, NAFConfig, continuous_params())}[name]
    return cls(CartPole3D(params, num_envs=4096, device=cuda),
               cfg_cls(**cfg))


def _bits(x, path="") -> dict:
    """{path: (dtype, shape, bytes)} of every tensor in an agent's state or
    metrics (nets by their state_dict, generators by their state), and
    {path: value} of every other leaf."""
    if isinstance(x, torch.nn.Module):
        x = x.state_dict()
    if isinstance(x, torch.Generator):
        x = x.get_state()
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        return {path: (x.dtype, tuple(x.shape), x.numpy().tobytes())}
    if hasattr(x, "_asdict"):
        x = x._asdict()
    if isinstance(x, dict):
        items = x.items()
    elif isinstance(x, (list, tuple)):
        items = enumerate(x)
    else:
        return {path: x}
    out = {}
    for k, v in items:
        out.update(_bits(v, f"{path}.{k}"))
    return out


@pytest.mark.parametrize("name,sample", [
    ("ddpg", "column"), ("ddpg", "uniform"), ("dqn", "column"),
    ("dqn", "block"), ("naf", "column")])
def test_steps_queued_ahead_give_the_bits_of_synchronised_steps(cuda, name,
                                                                sample):
    """Six train steps queued behind a long sleep on the card, so that
    every step's staged index copy is pending at once, leave every ring
    buffer, net, target net, Adam moment, generator and returned metric
    equal, bit for bit, to the same six steps from the same seed with a
    synchronize after each. A staging buffer handed out again before its
    copy ran would change the draws and so the bits. Ring capacity 64:
    the ring wraps within the steps. NAF runs the kernel learner, as its
    benchmark cell does."""
    cfg = dict(sample=sample, replay_capacity_per_env=64)
    if name == "naf":
        cfg["learner"] = "auto"

    def run(queued: bool):
        a = _card_agent(cuda, name, **cfg)
        st = a.init(11)
        for _ in range(3):   # past the warm-up and every first call's caches
            st, _ = a.train_step(st)
        torch.cuda.synchronize()
        if queued:
            torch.cuda._sleep(3_000_000_000)
            slept = torch.cuda.Event()
            slept.record()
        metrics = []
        for _ in range(6):
            st, m = a.train_step(st)
            metrics.append({k: v for k, v in m.items()
                            if isinstance(v, torch.Tensor)})
            if not queued:
                torch.cuda.synchronize()
        if queued:
            assert not slept.query(), "the steps did not queue ahead"
        torch.cuda.synchronize()
        return _bits(st), _bits(metrics)

    synced, queued = run(False), run(True)
    for got, want in zip(queued, synced):
        assert got.keys() == want.keys()
        assert [k for k in want if got[k] != want[k]] == []


@pytest.mark.parametrize("name", ["ddpg", "dqn", "naf"])
def test_each_learning_step_stages_one_index_copy(cuda, name):
    """On the card every learning step copies its draws once, staged
    through page-locked memory, and never with a blocking copy."""
    from cartpoleplusplus_tpu_torch.agents import replay

    a = _card_agent(cuda, name, replay_capacity_per_env=64)
    st = a.init(3)
    before = dict(replay.INDEX_COPIES)
    learned = 0
    for _ in range(5):
        st, m = a.train_step(st)
        learned += m["env_steps"] >= a.cfg.warmup_env_steps
    torch.cuda.synchronize()
    assert learned == 4
    assert {k: v - before[k] for k, v in replay.INDEX_COPIES.items()} == {
        "staged": learned, "blocking": 0}
