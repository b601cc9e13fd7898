"""The SPMD learner and the scaling measurement
(cartpoleplusplus_tpu/dist/train.py in torch).

The reference compiles one SPMD program over sharded inputs and lets the
partitioner insert the collectives, so its result is the unsharded
program's. torch has no partitioner; here that learner is defined by its
result. Each rank rolls out its own envs and inserts them into its own
replay rows; the replay draws come from one generator replicated on every
rank, over GLOBAL env indices; each rank contributes the rows it owns and
the minibatch is assembled on every rank by one all-reduce
(agents/replay.py::presample_global); every rank then runs the identical learner, kernel or
plain, on identical inputs. The agent is built on the rank's envs with
`group=mesh, num_shards=mesh.size, spmd=True`.

Learner resolution differs from the reference's: its `learner="auto"`
under SPMD on several devices takes the plain rollout and learner because
the partitioner would cut a `pallas_call`. Nothing is cut here, so `auto`
keeps the kernels (B2-B9), which equal the plain route within their twins'
tolerances.
"""

from __future__ import annotations

import time

import torch

from .mesh import (Mesh, all_gather_cat, all_reduce_sum, make_mesh,
                   shard_batch_tree)

# Agent-state fields whose leading axis is the (sharded) env batch.
_BATCH_FIELDS = frozenset({"replay", "env_state", "obs", "noise"})


def shard_agent_state(state, mesh: Mesh):
    """A GLOBAL agent state -> this rank's: the batch fields' env rows of
    the rank (the placement rule of mesh.shard_batch_tree), parameters,
    optimizer state and counters replicated. `agent.init` of an agent
    built on the rank's envs gives the same state directly."""
    return state._replace(**{
        f: shard_batch_tree(getattr(state, f), mesh)
        for f in state._fields if f in _BATCH_FIELDS})


def _check_agent(agent, mesh: Mesh, spmd: bool) -> None:
    if agent.num_shards != mesh.size:
        raise ValueError(f"agent.num_shards={agent.num_shards} != "
                         f"mesh.size={mesh.size}")
    if mesh.size > 1 and agent.spmd != spmd:
        raise ValueError("the agent was built for the "
                         f"{'spmd' if agent.spmd else 'shardmap'} learner")


def stitch_traj(traj, mesh: Mesh):
    """A rollout's time-major (obs, action, reward, done), each (T,
    B_local, ...), stitched along the env axis in rank order: the global
    trajectory on every rank."""
    if mesh.size == 1:
        return traj
    return tuple(all_gather_cat(x, mesh, dim=1) for x in traj)


def _stepper(agent, mesh: Mesh, capture: bool, spmd: bool):
    _check_agent(agent, mesh, spmd)

    def step(state):
        state, metrics = agent.train_step(state, capture=capture)
        if capture:
            metrics["traj"] = stitch_traj(metrics["traj"], mesh)
        return state, metrics

    return step


def _scan(step, num_calls: int):
    """`num_calls` steps; metrics stacked time-major (each key (k,)), the
    trajectories (k, T, B, ...), as the reference's scans return them."""

    def run(state):
        ms = []
        for _ in range(num_calls):
            state, m = step(state)
            ms.append(m)
        out = {}
        for key in ms[0]:
            vals = [m[key] for m in ms]
            if key == "traj":
                out[key] = tuple(torch.stack(x) for x in zip(*vals))
            else:
                out[key] = torch.stack([torch.as_tensor(v) for v in vals])
        return state, out

    return run


def make_distributed_train_step(agent, mesh: Mesh, state_template=None,
                                capture: bool = False):
    """The SPMD train step: fn(state) -> (state, metrics). `agent` is
    built on this rank's envs with spmd=True; capture=True adds the
    stitched global trajectory as metrics["traj"]. state_template is kept
    for the reference's signature: the layout here never changes."""
    return _stepper(agent, mesh, capture, spmd=True)


def make_distributed_train_scan(agent, mesh: Mesh, num_calls: int,
                                state_template=None,
                                capture: bool = False):
    """`num_calls` SPMD train steps as one call, with stacked metrics (the
    reference's chunked dispatch)."""
    return _scan(_stepper(agent, mesh, capture, spmd=True), num_calls)


def measure_rollout_rate(env, num_steps: int = 256, repeats: int = 3,
                         mesh: Mesh | None = None, seed: int = 0) -> float:
    """Global env-steps/s of the physics-only rollout (B1 on a CUDA
    device, its twin on the CPU; ops/fused_rollout.py) with `env` this
    rank's shard: the best of `repeats` timed passes, each ending when the
    slowest rank ends (the checksum's all-reduce)."""
    from ..ops.fused_rollout import fused_rollout

    mesh = mesh if mesh is not None else make_mesh()
    state, _ = env.reset(seed, mesh.rank * env.num_envs)

    def run(st):
        st, acc = fused_rollout(env, st, num_steps)
        return st, float(all_reduce_sum(acc.reshape(1), mesh))

    state, _ = run(state)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        state, _ = run(state)
        best = min(best, time.perf_counter() - t0)
    return env.num_envs * mesh.size * num_steps / best


def scaling_report(make_env, num_steps: int = 256,
                   mesh: Mesh | None = None) -> dict:
    """Weak scaling: the rollout rate of one rank's envs alone beside all
    ranks' at the same envs per rank. make_env(num_envs_scale=1) builds
    one rank's env. Every rank must call it (the all-rank pass is
    collective); the one-rank pass runs on every rank at once, so on ranks
    that share a card it measures that sharing too."""
    mesh = mesh if mesh is not None else make_mesh()
    env = make_env(num_envs_scale=1)
    rate1 = measure_rollout_rate(env, num_steps, mesh=Mesh(
        1, 0, mesh.device))
    if mesh.size == 1:
        return {"devices": 1, "rate_1dev": rate1, "rate_ndev": rate1,
                "efficiency": 1.0}
    raten = measure_rollout_rate(env, num_steps, mesh=mesh)
    return {"devices": mesh.size, "rate_1dev": rate1, "rate_ndev": raten,
            "efficiency": raten / (mesh.size * rate1)}
