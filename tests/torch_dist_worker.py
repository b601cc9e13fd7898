"""One rank of the port's multi-process CPU tests (tests/test_torch_dist.py,
tests/test_torch_dist_cli.py).

Run as `python tests/torch_dist_worker.py SPEC.json RANK`: the rank joins
a gloo group of SPEC["world"] ranks through the rendezvous file
SPEC["init"], runs each job of SPEC["jobs"] and writes its results with
torch.save to SPEC["out"]/<job name>.<rank>.pt. It imports torch, numpy
and the port, never JAX, and uses one thread.
"""

from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cartpoleplusplus_tpu_torch.agents import (  # noqa: E402
    DDPG, DQN, LRPG, NAF, DDPGConfig, DQNConfig, LRPGConfig, NAFConfig)
from cartpoleplusplus_tpu_torch.ckpt.checkpoint import (  # noqa: E402
    merge_restored, to_tree)
from cartpoleplusplus_tpu_torch.dist import (  # noqa: E402
    all_reduce_sum, initialize_multihost, make_distributed_train_step,
    make_mesh, make_shardmap_evaluate, make_shardmap_train_step)
from cartpoleplusplus_tpu_torch.env import CartPole3D  # noqa: E402
from cartpoleplusplus_tpu_torch.env.pixels import RenderConfig  # noqa: E402
from cartpoleplusplus_tpu_torch.physics.params import (  # noqa: E402
    CartPoleParams, continuous_params)

AGENTS = {"ddpg": (DDPG, DDPGConfig, True), "dqn": (DQN, DQNConfig, False),
          "naf": (NAF, NAFConfig, True), "lrpg": (LRPG, LRPGConfig, False)}


def make_env(params, num_envs: int, render=None) -> CartPole3D:
    """A CPU env: pixel observations rendered with RenderConfig(**render)
    when `render` is given."""
    if render is None:
        return CartPole3D(params, num_envs=num_envs, device="cpu")
    return CartPole3D(params, num_envs=num_envs, obs_mode="pixels",
                      device="cpu", render_config=RenderConfig(**render))


def build(agent: str, num_envs: int, cfg: dict, mesh=None,
          spmd: bool = True, render=None):
    """The agent on `num_envs` envs (this rank's shard over a mesh), on
    pixel observations when `render` is given."""
    cls, cfg_cls, continuous = AGENTS[agent]
    params = continuous_params() if continuous else CartPoleParams()
    kw = cfg.copy()
    if "hidden" in kw:
        kw["hidden"] = tuple(kw["hidden"])
    shard = dict(group=mesh, num_shards=mesh.size) if mesh else {}
    env = make_env(params, num_envs // (mesh.size if mesh else 1), render)
    return cls(env, cfg_cls(**kw), spmd=spmd, **shard)


def train(job: dict, mesh) -> dict:
    """`steps` train steps of the sharded agent from its init (or from the
    global state tree in job["state"]), each restarted from the global
    state tree job["states"][step] when given (teacher forcing) and with
    the injected draws job["indices"][step][rank] (rank 0's under SPMD,
    the global draws) when given; returns the state tree (this rank's
    rows) and the metrics after every step."""
    spmd = job["learner"] == "spmd"
    agent = build(job["agent"], job["num_envs"], job["cfg"], mesh, spmd,
                  job.get("render"))
    st = agent.init(job.get("seed", 0))
    if job.get("state"):
        st = merge_restored(st, torch.load(job["state"], weights_only=True),
                            mesh=mesh)
    make = make_distributed_train_step if spmd else make_shardmap_train_step
    step = make(agent, mesh)
    draws = (torch.load(job["indices"], weights_only=False)
             if job.get("indices") else None)
    out = []
    for k in range(job["steps"]):
        if job.get("states"):
            st = merge_restored(st, torch.load(job["states"][k],
                                               weights_only=True), mesh=mesh)
        if draws is not None:
            d = draws[k][mesh.rank if not spmd else 0]
            st, m = agent.train_step(st, indices=d)
        else:
            st, m = step(st)
        m = {key: float(v) for key, v in m.items()}
        out.append({"state": to_tree(st), "metrics": m})
    return {"steps": out}


def evaluate(job: dict, mesh) -> dict:
    """The sharded eval of an agent's init (or job["state"])."""
    agent = build(job["agent"], job["num_envs"], job["cfg"], mesh,
                  spmd=False)
    st = agent.init(job.get("seed", 0))
    if job.get("state"):
        st = merge_restored(st, torch.load(job["state"], weights_only=True),
                            mesh=mesh)
    stats = make_shardmap_evaluate(agent, mesh, st, job["eval_steps"],
                                   job.get("eval_seed", 0))(st)
    return {k: v.clone() for k, v in stats.items()}


def rollout(job: dict, mesh) -> dict:
    """The sharded physics-only rollout (B1's twin on the CPU): this
    rank's and the all-reduced checksum, and the weak-scaling report."""
    from cartpoleplusplus_tpu_torch.dist import scaling_report
    from cartpoleplusplus_tpu_torch.ops.fused_rollout import fused_rollout

    n = job["num_envs"] // mesh.size
    env = CartPole3D(CartPoleParams(), num_envs=n, device="cpu")
    st, _ = env.reset(0, mesh.rank * n)
    st, acc = fused_rollout(env, st, job["steps"])
    report = scaling_report(lambda num_envs_scale: CartPole3D(
        CartPoleParams(), num_envs=n * num_envs_scale, device="cpu"),
        num_steps=4, mesh=mesh)
    return {"local": acc, "total": all_reduce_sum(acc.reshape(1), mesh),
            "pos": st.phys.pos, "scaling": report}


def pixel_rollout(job: dict, mesh) -> dict:
    """job["steps"] env-steps of this rank's pixel envs under the action
    (global env index + t) % 5: every step's frames and rewards."""
    n = job["num_envs"] // mesh.size
    env = make_env(CartPoleParams(), n, job["render"])
    st, _ = env.reset(0, mesh.rank * n)
    idx = torch.arange(n, dtype=torch.int32) + mesh.rank * n
    frames, rewards = [], []
    for t in range(job["steps"]):
        st, obs, reward, _, _ = env.step(st, (idx + t) % 5)
        frames.append(obs)
        rewards.append(reward)
    return {"frames": torch.stack(frames), "rewards": torch.stack(rewards)}


def learn(job: dict, mesh) -> dict:
    """tests/test_multihost.py's 2-process DQN learning run on the port:
    the shardmap learner for job["env_steps"] env-steps (scans of 5 train
    steps), then the sharded greedy eval (job["eval_steps"] steps, seed 7)
    and the random agent's on the global env shape; prints the LEARN line
    and returns the statistics."""
    from cartpoleplusplus_tpu_torch.agents import RandomAgent
    from cartpoleplusplus_tpu_torch.dist import make_shardmap_train_scan

    agent = build("dqn", job["num_envs"], job["cfg"], mesh, spmd=False)
    st = agent.init(0)
    k = 5
    scan = make_shardmap_train_scan(agent, mesh, k)
    for _ in range((job["env_steps"] // job["cfg"]["rollout_steps"]) // k):
        st, _ = scan(st)
    stats = {key: float(v) for key, v in make_shardmap_evaluate(
        agent, mesh, st, job["eval_steps"], 7)(st).items()}
    rand = {key: float(v) for key, v in RandomAgent(
        make_env(CartPoleParams(), job["num_envs"])).evaluate(
            7, job["eval_steps"]).items()}
    line = (f"LEARN {stats['mean_episode_length']:.4f} RAND "
            f"{rand['mean_episode_length']:.4f} EPISODES "
            f"{int(stats['episodes'])}")
    print(line, flush=True)
    return {"line": line, "stats": stats, "random": rand}


def collectives(job: dict, mesh) -> dict:
    """owned_rows and gather_batch_tree on rows made from job["seed"]:
    (K, Bm) rows of four dtypes, each owned by a random rank, every rank
    holding its own rows and junk in the others (a -0.0 and a NaN among
    the float rows); and a tree of this rank's rows and a scalar gathered
    to rank 0."""
    from cartpoleplusplus_tpu_torch.dist.mesh import (gather_batch_tree,
                                                      owned_rows)

    g = torch.Generator().manual_seed(job["seed"])
    shape = (3, 10)
    owner = torch.randint(0, mesh.size, shape, generator=g)
    full = [torch.randn(shape + (5,), generator=g),
            torch.randint(0, 256, shape + (7,), generator=g,
                          dtype=torch.uint8),
            torch.rand(shape, generator=g) < 0.5,
            torch.randint(-9, 9, shape, generator=g, dtype=torch.int32)]
    full[0][0, 0, 0], full[0][0, 1, 0] = -0.0, float("nan")
    mine = owner == mesh.rank
    held = []
    for x, junk in zip(full, (7.0 + mesh.rank, 255, True, -1)):
        x = x.clone()
        x[~mine] = junk
        held.append(x)
    rows = torch.arange(4.0) + 4 * mesh.rank
    return {"full": full, "got": list(owned_rows(held, mine, mesh)),
            "gathered": gather_batch_tree({"rows": rows,
                                           "step": torch.tensor(3)}, mesh)}


JOBS = {"train": train, "eval": evaluate, "rollout": rollout,
        "collectives": collectives, "pixel_rollout": pixel_rollout,
        "learn": learn}


def main() -> int:
    torch.set_num_threads(1)
    spec = json.load(open(sys.argv[1]))
    rank = int(sys.argv[2])
    initialize_multihost(spec["init"], spec["world"], rank, backend="gloo",
                         device="cpu", timeout_s=spec.get("timeout_s", 120))
    mesh = make_mesh()
    for name, job in spec["jobs"].items():
        res = JOBS[job["kind"]](job, mesh)
        torch.save(res, os.path.join(spec["out"], f"{name}.{rank}.pt"))
    torch.distributed.destroy_process_group()
    # The ranks run without JAX: neither it nor the reference package was
    # imported.
    assert not {"jax", "cartpoleplusplus_tpu"} & set(sys.modules)
    return 0


if __name__ == "__main__":
    sys.exit(main())
