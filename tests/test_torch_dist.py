"""The port's distribution (cartpoleplusplus_tpu_torch/dist) on the CPU:
ranks are spawned processes on gloo (tests/torch_dist_worker.py, which
imports no JAX), held against the 1-process port and against the JAX
reference on 2 or 4 of conftest's virtual CPU devices.

Every rank owns 16 envs here: below 16 rows torch's CPU matrix product
rounds a row otherwise than at 16 rows and more
(test_cpu_matmul_rounds_by_row_count shows it), which would part a
shard's rollout from the 1-process one by a last bit. With 16 rows per
rank the SPMD learner is held bit for bit.
"""

import functools
import inspect
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu import CartPole3D as JCartPole3D
from cartpoleplusplus_tpu import agents as jagents
from cartpoleplusplus_tpu.dist import (DATA_AXIS, make_mesh,
                                       make_shardmap_train_step,
                                       shard_agent_state)
from cartpoleplusplus_tpu.physics import params as jparams
from cartpoleplusplus_tpu_torch.ckpt.checkpoint import merge_restored, to_tree
from cartpoleplusplus_tpu_torch.dist import (Mesh, gather_batch_tree,
                                             shard_batch_tree,
                                             state_partition_specs)
from cartpoleplusplus_tpu_torch.models import from_jax

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as W  # noqa: E402

WORKER = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
TIMEOUT_S = 120          # each spawn's own limit: a hung collective ends it
ENVS = 32                # global envs of the 2-rank runs (16 per rank)
T = 4                    # rollout steps
AGENTS = ("ddpg", "dqn", "naf", "lrpg")
LEARNERS = ("xla", "kernel")
BATCH_FIELDS = ("replay", "env_state", "obs", "noise")
TWIN_RTOL, TWIN_ATOL = 2e-4, 1e-5       # the learner twins' bar
# tests/test_dist.py's pixel cases: 16 x 16 gray uint8 frame-diff frames,
# pixel DDPG at hidden (32, 32), rollout 2, K 2, batch 32, 8 ring slots.
PIXEL_RENDER = dict(width=16, height=16, grayscale=True, obs_uint8=True,
                    frame_diff=True, frame_diff_gain=4.0)
PIXEL_DDPG = dict(hidden=[32, 32], rollout_steps=2, updates_per_step=2,
                  batch_size=32, replay_capacity_per_env=8,
                  warmup_env_steps=0)
PIXEL_STEPS = 8
# tests/test_multihost.py's 2-process DQN learning run: 2 ranks of 32 envs
# (the port's mesh holds one shard per rank; the reference's 2 processes
# hold 2 shards of 16 envs each: the same 64 global envs).
LEARN_DQN = dict(hidden=[64, 64], rollout_steps=16, updates_per_step=8,
                 batch_size=128, replay_capacity_per_env=512, lr=5e-4,
                 eps_decay_env_steps=1200, eps_end=0.05,
                 warmup_env_steps=32, sample="uniform")
LEARN_TIMEOUT_S = 90
SHARDMAP_RTOL, SHARDMAP_ATOL = 1e-4, 2e-5  # test_dist.py's shard_map bar


def _cfg(agent, learner, **kw):
    if agent == "lrpg":
        return dict(hidden=[16, 16], rollout_steps=T, learner=learner, **kw)
    cfg = dict(hidden=[16, 16], rollout_steps=T, updates_per_step=2,
               batch_size=32, replay_capacity_per_env=16, warmup_env_steps=0,
               learner=learner)
    cfg.update(kw)
    if agent == "dqn":
        cfg["eps_decay_env_steps"] = 100
    return cfg


def spawn(world, jobs, out, timeout_s=TIMEOUT_S):
    """Start `jobs` on `world` gloo ranks (rendezvous through a file in
    `out`); `finish` waits for them."""
    os.makedirs(out, exist_ok=True)
    spec = dict(world=world, init=f"file://{out}/rendezvous", out=str(out),
                jobs=jobs, timeout_s=timeout_s)
    with open(os.path.join(out, "spec.json"), "w") as f:
        json.dump(spec, f)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, WORKER,
                               os.path.join(out, "spec.json"), str(r)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return procs, jobs, out, timeout_s


def finish(started):
    """{job: [rank 0's result, ...]} of a spawn; its ranks are killed if
    they outlive the spawn's timeout."""
    procs, jobs, out, timeout_s = started
    world = len(procs)
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return {name: [torch.load(os.path.join(out, f"{name}.{r}.pt"),
                              weights_only=False) for r in range(world)]
            for name in jobs}


def _cat_ranks(trees):
    """The rank trees' batch tensors concatenated in rank order."""
    a = trees[0]
    if isinstance(a, dict):
        return {k: _cat_ranks([t[k] for t in trees]) for k in a}
    if isinstance(a, list):
        return [_cat_ranks([t[i] for t in trees]) for i in range(len(a))]
    if isinstance(a, torch.Tensor) and a.ndim >= 1:
        return torch.cat(trees)
    return a


def global_tree(rank_trees):
    """One global state tree from every rank's tree: batch fields
    concatenated, the rest rank 0's."""
    out = dict(rank_trees[0])
    for k in BATCH_FIELDS:
        if k in out:
            out[k] = _cat_ranks([t[k] for t in rank_trees])
    return out


def assert_trees(got, want, path="", rtol=None, atol=None):
    """Equal bit for bit (rtol None), or floats within rtol/atol and every
    integer, bool and count exact."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_trees(got[k], want[k], f"{path}.{k}", rtol, atol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_trees(a, b, f"{path}[{i}]", rtol, atol)
    elif isinstance(want, torch.Tensor):
        if rtol is None or not want.is_floating_point():
            assert got.dtype == want.dtype and torch.equal(got, want), (
                path, (got.double() - want.double()).abs().max())
        else:
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                                       msg=lambda m: f"{path}: {m}")
    else:
        assert got == want, path


def _no_rng(tree):
    return {k: v for k, v in tree.items() if k != "rng"}


# --- the reference ----------------------------------------------------------

_JAX = {"ddpg": (jagents.DDPG, jagents.DDPGConfig, True),
        "dqn": (jagents.DQN, jagents.DQNConfig, False),
        "naf": (jagents.NAF, jagents.NAFConfig, True),
        "lrpg": (jagents.LRPG, jagents.LRPGConfig, False)}
_FROM_JAX = {"ddpg": from_jax.ddpg_state_from_jax,
             "dqn": from_jax.dqn_state_from_jax,
             "naf": from_jax.naf_state_from_jax,
             "lrpg": from_jax.lrpg_state_from_jax}


def _jax_agent(agent, num_envs, **kw):
    cls, cfg_cls, continuous = _JAX[agent]
    p = (jparams.continuous_params() if continuous
         else jparams.CartPoleParams())
    cfg = _cfg(agent, "xla")
    cfg["hidden"] = tuple(cfg["hidden"])
    return cls(JCartPole3D(p, num_envs=num_envs), cfg_cls(**cfg), **kw)


def port_tree(agent, host_state):
    """A reference state (numpy leaves, global) as the port's checkpoint
    tree, through the port's converter on a 1-process agent."""
    return to_tree(_FROM_JAX[agent](W.build(agent, ENVS,
                                            _cfg(agent, "xla")),
                                    host_state))


def column_draws(rng, bs, b, filled, cursor, shard=None, k_updates=2,
                 cap=16):
    """The (slots, offs) the reference's column presample draws for a
    learning step from state rng `rng` (split, then one key per update),
    each key folded with `shard` under shard_map, over `b` envs."""
    k_cols = -(-bs // b)
    n_valid = max(filled - 1, 1)
    _, k = jax.random.split(rng)
    slots, offs = [], []
    for key in jax.random.split(k, k_updates):
        if shard is not None:
            key = jax.random.fold_in(key, shard)
        k_slot, k_env = jax.random.split(key)
        ages = jax.random.randint(k_slot, (k_cols,), 1, n_valid + 1)
        offs.append(int(jax.random.randint(k_env, (), 0, k_cols * b)))
        slots.append((cursor - 1 - np.asarray(ages)) % cap)
    return np.stack(slots), np.asarray(offs)


def _step_fn(jagent):
    kw = ({"fused": False}
          if "fused" in inspect.signature(jagent.train_step).parameters
          else {})
    return functools.partial(jagent.train_step, **kw)


@functools.lru_cache(maxsize=None)
def reference_run(agent, sharded, steps=2):
    """The reference's `steps` train steps from init(0): single-device
    (the SPMD learner's result) or shard_map on 2 devices. Returns
    [(state before, draws per rank, metrics, state after)] per step, the
    states as host trees."""
    jagent = _jax_agent(agent, ENVS)
    st = jagent.init(0)
    if sharded:
        mesh = make_mesh(jax.devices()[:2])
        local = _jax_agent(agent, ENVS // 2, dist_axis=DATA_AXIS,
                           num_shards=2)
        st = shard_agent_state(st, mesh)
        step = make_shardmap_train_step(local, mesh, st)
    else:
        step = jax.jit(_step_fn(jagent))
    out = []
    for i in range(1, steps + 1):
        before = jax.device_get(st)
        draws = None
        if agent != "lrpg":
            filled, cursor = min(i * T, 16), (i * T) % 16
            draws = ([column_draws(before.rng, 16, ENVS // 2, filled,
                                   cursor, shard=r) for r in range(2)]
                     if sharded else
                     [column_draws(before.rng, 32, ENVS, filled, cursor)])
        st, m = step(st)
        out.append((before, draws, {k: float(v) for k, v in m.items()},
                    jax.device_get(st)))
    return out


def _teacher_job(agent, learner, dist, run, tmp):
    """A worker job that restarts each step from the reference's state and
    injects its draws (state files and draws written under tmp)."""
    files = []
    for i, (before, _, _, _) in enumerate(run):
        path = os.path.join(tmp, f"{agent}-{dist}-{learner}-{i}.pt")
        if not os.path.exists(path):
            torch.save(port_tree(agent, before), path)
        files.append(path)
    draws = os.path.join(tmp, f"{agent}-{dist}-draws.pt")
    torch.save([d for _, d, _, _ in run], draws)
    return dict(kind="train", agent=agent, learner=dist, num_envs=ENVS,
                cfg=_cfg(agent, learner), steps=len(run), states=files,
                indices=draws if agent != "lrpg" else None)


# --- the runs (one 2-rank and one 4-rank spawn for the whole module) ------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # Three spawns, each started as soon as its inputs exist: the port's
    # own SPMD runs at once, the layout and eval jobs after their reference
    # states, the teacher-forced jobs after the reference's runs.
    tmp = str(tmp_path_factory.mktemp("dist"))
    own, two, four = {}, {}, {}
    for agent in AGENTS:
        for learner in LEARNERS:
            own[f"spmd-{agent}-{learner}"] = dict(
                kind="train", agent=agent, learner="spmd", num_envs=ENVS,
                cfg=_cfg(agent, learner, **({"warmup_env_steps": 8}
                                            if agent != "lrpg" else {})),
                steps=3)
    own["rollout"] = dict(kind="rollout", num_envs=ENVS, steps=24)
    own["collectives"] = dict(kind="collectives", seed=2)
    own["pixel-rollout"] = dict(kind="pixel_rollout", num_envs=ENVS,
                                steps=PIXEL_STEPS, render=PIXEL_RENDER)
    for learner in ("spmd", "shardmap"):
        own[f"pixel-{learner}"] = dict(
            kind="train", agent="ddpg", learner=learner, num_envs=ENVS,
            cfg=PIXEL_DDPG, render=PIXEL_RENDER, steps=2)
    started = [spawn(2, own, os.path.join(tmp, "own"))]
    try:
        return _start_the_rest(tmp, started, two, four)
    finally:
        for procs, *_ in started:
            for p in procs:
                if p.poll() is None:
                    p.kill()


def _start_the_rest(tmp, started, two, four):
    four["collectives"] = dict(kind="collectives", seed=4)
    for jobs, n in ((two, ENVS), (four, 2 * ENVS)):
        state = os.path.join(tmp, f"layout-{n}.pt")
        torch.save(layout_run(n)[0], state)
        jobs["layout"] = dict(kind="train", agent="ddpg", learner="spmd",
                              num_envs=n, steps=1, state=state,
                              cfg=_cfg("ddpg", "xla",
                                       **{"warmup_env_steps": 1000}))
        state = os.path.join(tmp, f"eval-{n}.pt")
        torch.save(eval_state(n)[1], state)
        for learner in LEARNERS:
            jobs[f"eval-{learner}"] = dict(
                kind="eval", agent="ddpg", num_envs=n, eval_steps=200,
                eval_seed=3, cfg=_cfg("ddpg", learner), state=state)
    started.append(spawn(4, four, os.path.join(tmp, "four")))
    for agent in AGENTS:
        for learner in LEARNERS:
            two[f"spmdref-{agent}-{learner}"] = _teacher_job(
                agent, learner, "spmd", reference_run(agent, False), tmp)
            two[f"shmap-{agent}-{learner}"] = _teacher_job(
                agent, learner, "shardmap", reference_run(agent, True), tmp)
    started.append(spawn(2, two, os.path.join(tmp, "two")))
    own, four, two = [finish(s) for s in started]
    return {2: dict(own, **two), 4: four}


def test_initialize_multihost_defaults_to_the_card(monkeypatch):
    """initialize_multihost's device defaults to "cuda", as the port's
    entry points run on the card unless asked for the CPU (the spawned
    ranks pass device="cpu"); with no card visible it raises before it
    joins any group, with no fallback to the CPU."""
    from cartpoleplusplus_tpu_torch.dist import initialize_multihost

    sig = inspect.signature(initialize_multihost)
    assert sig.parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        initialize_multihost("localhost:1", 1, 0, backend="gloo")
    assert not torch.distributed.is_initialized()


def test_cpu_matmul_rounds_by_row_count():
    """Why each rank owns 16 envs in these tests: torch's CPU product of
    an (M, 16) batch with the 16 -> 2 actor head gives other bits for a
    row at M = 8 than at M = 16 or more (another kernel), and the same
    bits from 16 rows up."""
    torch.set_num_threads(1)
    g = torch.Generator().manual_seed(0)
    head = torch.nn.Linear(16, 2)
    x = torch.randn(64, 16, generator=g)
    with torch.no_grad():
        whole = head(x)
        by = {m: torch.cat([head(x[i:i + m]) for i in range(0, 64, m)])
              for m in (8, 16, 32)}
    assert not torch.equal(by[8], whole)
    assert torch.equal(by[16], whole) and torch.equal(by[32], whole)


@pytest.mark.parametrize("learner", LEARNERS)
@pytest.mark.parametrize("agent", AGENTS)
def test_spmd_is_the_unsharded_program(runs, agent, learner):
    """Three train steps of the SPMD learner on 2 ranks (the first of
    DDPG/DQN/NAF only rolling out: warmup 8) equal the 1-process port's
    bit for bit after every step: parameters, targets, optimizer moments,
    counters, the replay ring, env state, obs and noise, and the metric
    lines; both ranks hold the same parameters."""
    torch.set_num_threads(1)
    got = runs[2][f"spmd-{agent}-{learner}"]
    cfg = _cfg(agent, learner, **({"warmup_env_steps": 8}
                                  if agent != "lrpg" else {}))
    one = W.build(agent, ENVS, cfg)
    st = one.init(0)
    for k in range(3):
        st, m = one.train_step(st)
        want = to_tree(st)
        ranks = [r["steps"][k] for r in got]
        assert_trees(global_tree([r["state"] for r in ranks]), want,
                     f"step {k + 1}")
        for r in ranks:
            assert r["metrics"] == {key: float(v) for key, v in m.items()}


@pytest.mark.parametrize("learner", LEARNERS)
@pytest.mark.parametrize("agent", AGENTS)
def test_spmd_matches_the_reference_single_device(runs, agent, learner):
    """The SPMD learner on 2 ranks, each step restarted from the
    reference's single-device state with its global replay draws
    injected: every field within the twins' bar (rtol 2e-4 / atol 1e-5)
    of the reference's next state, integers exact, losses too."""
    got = runs[2][f"spmdref-{agent}-{learner}"]
    for k, (_, _, jm, after) in enumerate(reference_run(agent, False)):
        ranks = [r["steps"][k] for r in got]
        assert_trees(_no_rng(global_tree([r["state"] for r in ranks])),
                     _no_rng(port_tree(agent, after)), f"step {k + 1}",
                     TWIN_RTOL, TWIN_ATOL)
        for key in ("loss", "critic_loss", "actor_loss", "reward_mean"):
            if key in jm:
                np.testing.assert_allclose(ranks[0]["metrics"][key],
                                           jm[key], rtol=TWIN_RTOL,
                                           atol=TWIN_ATOL, err_msg=key)


@pytest.mark.parametrize("learner", LEARNERS)
@pytest.mark.parametrize("agent", AGENTS)
def test_shardmap_matches_the_reference_shard_map(runs, agent, learner):
    """The shardmap learner on 2 ranks against the reference's
    make_shardmap_train_step on a 2-device mesh: each step restarted from
    the reference's state, each rank given its shard's draws (the
    reference's keys folded with the shard index); every field within
    rtol 1e-4 / atol 2e-5 of the reference's (the reference's own bar for
    its kernel learner against its XLA learner), integers exact, and the
    parameters bit-identical on both ranks."""
    got = runs[2][f"shmap-{agent}-{learner}"]
    for k, (_, _, jm, after) in enumerate(reference_run(agent, True)):
        ranks = [r["steps"][k] for r in got]
        for r in ranks[1:]:
            assert_trees({f: v for f, v in r["state"].items()
                          if f not in BATCH_FIELDS},
                         {f: v for f, v in ranks[0]["state"].items()
                          if f not in BATCH_FIELDS}, f"step {k + 1}")
        assert_trees(_no_rng(global_tree([r["state"] for r in ranks])),
                     _no_rng(port_tree(agent, after)), f"step {k + 1}",
                     SHARDMAP_RTOL, SHARDMAP_ATOL)
        for key in ("loss", "critic_loss", "actor_loss", "reward_mean",
                    "done_frac"):
            if key in jm:
                for r in ranks:
                    np.testing.assert_allclose(
                        r["metrics"][key], jm[key], rtol=SHARDMAP_RTOL,
                        atol=SHARDMAP_ATOL, err_msg=key)


@pytest.mark.parametrize("agent", AGENTS)
def test_shardmap_kernel_twin_matches_the_plain_learner(runs, agent):
    """On the same states and per-shard draws, the kernel learner's twin
    (all-gathered union batches, or LRPG's union window) and the plain
    learner (all-reduced gradients) agree within rtol 1e-4 / atol 2e-5."""
    plain, kern = (runs[2][f"shmap-{agent}-{lr}"] for lr in LEARNERS)
    for k in range(2):
        assert_trees(plain[0]["steps"][k]["state"],
                     kern[0]["steps"][k]["state"], f"step {k + 1}",
                     SHARDMAP_RTOL, SHARDMAP_ATOL)


@functools.lru_cache(maxsize=None)
def layout_run(n):
    """The reference DDPG's init on n envs as the port's checkpoint tree,
    and its state after one train step that only rolls out (warmup above
    the budget), converted."""
    cfg = _cfg("ddpg", "xla", warmup_env_steps=1000)
    jagent = jagents.DDPG(JCartPole3D(jparams.continuous_params(),
                                      num_envs=n),
                          jagents.DDPGConfig(**dict(cfg, hidden=(16, 16))))
    jst = jagent.init(0)
    after, _ = jax.jit(jagent.train_step)(jst)
    conv = [to_tree(from_jax.ddpg_state_from_jax(W.build("ddpg", n, cfg),
                                                 jax.device_get(x)))
            for x in (jst, after)]
    return conv[0], conv[1]


@pytest.mark.parametrize("world", (2, 4))
def test_rollout_layout_independent(runs, world):
    """One DDPG train step that only rolls out (warmup above the budget)
    on 2 and 4 ranks (16 envs each): env state, obs and OU noise equal the
    1-process run bit for bit, and the reference's single-device step
    within the rollout twins' bar with dones, steps and episodes exact
    (tests/test_dist.py::test_exploration_noise_layout_independent's
    property across the two packages)."""
    torch.set_num_threads(1)
    n = 16 * world
    init, ref = layout_run(n)
    one = W.build("ddpg", n, _cfg("ddpg", "xla", warmup_env_steps=1000))
    st, _ = one.train_step(merge_restored(one.init(0), init))
    want = to_tree(st)
    got = global_tree([r["steps"][0]["state"] for r in runs[world]["layout"]])
    for key in ("env_state", "obs", "noise"):
        assert_trees(got[key], want[key], key)
        assert_trees(got[key], ref[key], key, 2e-4, 2e-5)


@functools.lru_cache(maxsize=None)
def eval_state(n):
    """The reference DDPG's init on n envs, its greedy eval (200 steps,
    seed 3), and its weights as the port's checkpoint tree."""
    jagent = jagents.DDPG(
        JCartPole3D(jparams.continuous_params(), num_envs=n),
        jagents.DDPGConfig(**dict(_cfg("ddpg", "xla"), hidden=(16, 16))))
    jst = jagent.init(0)
    ref = jax.jit(jagent.evaluate, static_argnums=(1, 2))(jst, 200, 3)
    tree = to_tree(from_jax.ddpg_state_from_jax(
        W.build("ddpg", n, _cfg("ddpg", "xla")), jax.device_get(jst)))
    return {k: float(v) for k, v in ref.items()}, tree


@pytest.mark.parametrize("learner", LEARNERS)
@pytest.mark.parametrize("world", (2, 4))
def test_sharded_eval_matches_one_process_and_reference(runs, world,
                                                        learner):
    """make_shardmap_evaluate on 2 and 4 ranks, from the reference DDPG's
    init weights on either learner's layout: episodes and the mean,
    median and max episode lengths exactly the 1-process evaluate's and
    the reference's; reward_mean and done_frac within rtol 1e-6 of the
    1-process eval's."""
    torch.set_num_threads(1)
    n = 16 * world
    ref, tree = eval_state(n)
    one = W.build("ddpg", n, _cfg("ddpg", learner))
    st = merge_restored(one.init(0), tree)
    want = one.evaluate(st, 200, 3)
    ints = ("episodes", "mean_episode_length", "median_episode_length",
            "max_episode_length")
    for r in runs[world][f"eval-{learner}"]:
        for key in ints:
            assert float(r[key]) == float(want[key]) == float(ref[key]), key
        for key in ("reward_mean", "done_frac"):
            np.testing.assert_allclose(float(r[key]), float(want[key]),
                                       rtol=1e-6, err_msg=key)
    assert float(want["episodes"]) > 0


def test_multihost_rollout_totals(runs):
    """initialize_multihost with an explicit coordinator (a rendezvous
    file) brings up 2 ranks; the sharded B1-twin rollout gives both ranks
    the same all-reduced total, the sum of the ranks' checksums, and each
    rank's envs the 1-process rollout's rows."""
    from cartpoleplusplus_tpu_torch.env import CartPole3D
    from cartpoleplusplus_tpu_torch.ops.fused_rollout import fused_rollout
    from cartpoleplusplus_tpu_torch.physics.params import CartPoleParams

    got = runs[2]["rollout"]
    assert torch.equal(got[0]["total"], got[1]["total"])
    assert float(got[0]["total"]) == float(
        (got[0]["local"] + got[1]["local"]).reshape(1))
    env = CartPole3D(CartPoleParams(), num_envs=ENVS, device="cpu")
    st, _ = fused_rollout(env, env.reset(0)[0], 24)
    assert torch.equal(torch.cat([r["pos"] for r in got]), st.phys.pos)
    rep = got[0]["scaling"]
    assert rep["devices"] == 2 and rep["rate_1dev"] > 0
    assert rep["rate_ndev"] > 0 and rep["efficiency"] > 0


@pytest.mark.parametrize("world", (2, 4))
def test_owned_rows_and_the_gather_to_rank_0(runs, world):
    """owned_rows gives every rank each row from its owner, bit for bit
    (a -0.0 and a NaN's bits kept; float32, uint8, bool and int32), out
    of ranks that hold junk in the rows they do not own; gather_batch_tree
    brings every rank's rows, in rank order, to rank 0 alone (the other
    ranks get None) and keeps scalars on every rank."""
    got = runs[world]["collectives"]
    for r in got:
        for x, want in zip(r["got"], r["full"]):
            assert x.dtype == want.dtype and x.shape == want.shape
            if x.is_floating_point():
                x, want = x.view(torch.int32), want.view(torch.int32)
            assert torch.equal(x, want)
    assert torch.equal(got[0]["gathered"]["rows"], torch.arange(4.0 * world))
    assert all(r["gathered"]["rows"] is None for r in got[1:])
    assert all(int(r["gathered"]["step"]) == 3 for r in got)


@pytest.mark.parametrize("learner", ("spmd", "shardmap"))
def test_train_scan_stacks_the_steps(learner):
    """make_distributed_train_scan / make_shardmap_train_scan: k train
    steps as one call give k single steps' state and their metrics
    stacked time-major, the trajectories (k, T, B, ...) with capture."""
    from cartpoleplusplus_tpu_torch.dist import (
        make_distributed_train_scan, make_shardmap_train_scan)

    torch.set_num_threads(1)
    make = (make_distributed_train_scan if learner == "spmd"
            else make_shardmap_train_scan)
    one = Mesh(1, 0, torch.device("cpu"))
    cfg = _cfg("ddpg", "xla", warmup_env_steps=4)
    a, b = (W.build("ddpg", 16, cfg) for _ in range(2))
    sa, ms = a.init(0), []
    for _ in range(3):
        sa, m = a.train_step(sa, capture=True)
        ms.append(m)
    sb, stacked = make(b, one, 3, capture=True)(b.init(0))
    assert_trees(to_tree(sb), to_tree(sa))
    for key in ("critic_loss", "reward_mean", "env_steps"):
        assert stacked[key].tolist() == [float(m[key]) for m in ms]
    for i, x in enumerate(stacked["traj"]):
        assert torch.equal(x, torch.stack([m["traj"][i] for m in ms]))


def test_placement_rule_and_its_inverse():
    """shard_batch_tree slices a leading axis that is longer than 1 and
    divides by the rank count and keeps every other leaf whole;
    gather_batch_tree on one rank is the identity; the partition specs of
    a DDPG state name exactly its batch fields' sharded tensors."""
    tree = {"a": torch.arange(8.0).reshape(4, 2), "b": torch.zeros(3),
            "c": torch.tensor(1.0), "d": 7}
    mesh = Mesh(2, 1, torch.device("cpu"))
    out = shard_batch_tree(tree, mesh)
    assert torch.equal(out["a"], tree["a"][2:])
    assert out["b"] is tree["b"] and out["c"] is tree["c"] and out["d"] == 7
    one = Mesh(1, 0, torch.device("cpu"))
    assert gather_batch_tree(tree, one) is tree
    agent = W.build("ddpg", ENVS, _cfg("ddpg", "xla"))
    specs = state_partition_specs(agent.init(0), mesh)
    assert specs.obs == "data" and specs.noise == "data"
    assert specs.replay.obs == "data" and specs.replay.cursor is None
    assert specs.env_state.env_seed == "data"
    assert all(s is None for s in jax.tree.leaves(
        [specs.actor_opt.count], is_leaf=lambda x: x is None))


# --- pixels and learning across ranks ---------------------------------------

def test_pixel_rollout_layout_independent(runs):
    """tests/test_dist.py::test_pixel_rollout_layout_independent on 2
    ranks of 16 envs: every step's uint8 frames and rewards over 8
    env-steps, the ranks' envs concatenated, equal one process's at 32
    envs bit for bit (rendering is a pure function of the state, and the
    randomness keys on the global env index)."""
    torch.set_num_threads(1)
    got = runs[2]["pixel-rollout"]
    env = W.make_env(W.CartPoleParams(), ENVS, PIXEL_RENDER)
    st, _ = env.reset(0)
    idx = torch.arange(ENVS, dtype=torch.int32)
    for t in range(PIXEL_STEPS):
        st, obs, reward, _, _ = env.step(st, (idx + t) % 5)
        frames = torch.cat([r["frames"][t] for r in got])
        assert frames.dtype == torch.uint8
        assert torch.equal(frames, obs), t
        assert torch.equal(torch.cat([r["rewards"][t] for r in got]),
                           reward), t


def test_spmd_pixel_ddpg_is_the_unsharded_program(runs):
    """tests/test_dist.py::test_spmd_pixel_ddpg_train_step on 2 ranks:
    2 SPMD train steps of pixel DDPG (the quantized ring, the render and
    the conv learner) equal the 1-process port's bit for bit after each
    step, the ring uint8."""
    torch.set_num_threads(1)
    got = runs[2]["pixel-spmd"]
    one = W.build("ddpg", ENVS, PIXEL_DDPG, render=PIXEL_RENDER)
    st = one.init(0)
    for k in range(2):
        st, m = one.train_step(st)
        ranks = [r["steps"][k] for r in got]
        assert_trees(global_tree([r["state"] for r in ranks]), to_tree(st),
                     f"step {k + 1}")
        assert st.replay.obs.dtype == torch.uint8
        for r in ranks:
            assert r["metrics"] == {key: float(v) for key, v in m.items()}


def test_shardmap_pixel_ddpg_train_step(runs):
    """tests/test_dist.py::test_shardmap_pixel_ddpg_train_step on 2 ranks:
    2 shardmap train steps of pixel DDPG (each rank's ring and render,
    one gradient all-reduce per net and update): the replicated fields
    bit-identical on both ranks, losses and rewards finite, the ring
    uint8 and sharded."""
    got = runs[2]["pixel-shardmap"]
    for k in range(2):
        ranks = [r["steps"][k] for r in got]
        assert_trees({f: v for f, v in ranks[1]["state"].items()
                      if f not in BATCH_FIELDS},
                     {f: v for f, v in ranks[0]["state"].items()
                      if f not in BATCH_FIELDS}, f"step {k + 1}")
        for r in ranks:
            for key in ("critic_loss", "actor_loss", "reward_mean"):
                assert np.isfinite(r["metrics"][key]), key
            ring = r["state"]["replay"]["obs"]
            assert ring.dtype == torch.uint8 and ring.shape[0] == ENVS // 2
    assert ranks[0]["metrics"]["critic_loss"] > 0.0


def test_two_rank_dqn_learns(tmp_path):
    """tests/test_multihost.py::test_two_process_dqn_learns on the port:
    DQN trained through the shardmap learner on 2 gloo ranks (2000
    env-steps at the reference's config, its scans of 5 train steps) beats
    the random agent at least 2x in mean episode length through the
    sharded eval (400 steps, seed 7), with episodes to count, and both
    ranks print the same line."""
    started = spawn(2, {"learn": dict(kind="learn", num_envs=2 * 32,
                                      cfg=LEARN_DQN, env_steps=2000,
                                      eval_steps=400)},
                    str(tmp_path), timeout_s=LEARN_TIMEOUT_S)
    got = finish(started)["learn"]
    assert got[0]["line"] == got[1]["line"], [r["line"] for r in got]
    stats, rand = got[0]["stats"], got[0]["random"]
    assert stats["episodes"] > 0
    assert stats["mean_episode_length"] > 2.0 * rand["mean_episode_length"], \
        got[0]["line"]
