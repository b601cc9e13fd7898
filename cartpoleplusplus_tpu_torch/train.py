"""Training CLI of the port — the `--agent ddpg`, `dqn`, `naf`, `lrpg` and
`random` flows of cartpoleplusplus_tpu/train.py, on one device or sharded
over the ranks of a torchrun launch, with its run flags: presets,
checkpoints and resume, the event log, `--eval-only`, chunked dispatch,
the canary and the profiler.

Usage:
    python -m cartpoleplusplus_tpu_torch.train                 # ddpg, cuda
    python -m cartpoleplusplus_tpu_torch.train --agent dqn     # dqn, cuda
    python -m cartpoleplusplus_tpu_torch.train --agent naf --naf.learner kernel
    python -m cartpoleplusplus_tpu_torch.train --agent lrpg    # lrpg, cuda
    python -m cartpoleplusplus_tpu_torch.train --agent random  # baseline
    python -m cartpoleplusplus_tpu_torch.train --preset fast --agent lrpg \
        --final-eval                         # a measured recipe (_PRESETS)
    python -m cartpoleplusplus_tpu_torch.train --preset pixels \
        --ckpt-dir ckpt/ --final-eval        # pixel DDPG, weights-only saves
    python -m cartpoleplusplus_tpu_torch.train --agent dqn --obs-mode pixels \
        --render-grayscale --render-obs-uint8 --render-frame-diff \
        --dqn.sample block --dqn.replay-capacity-per-env 64   # pixel DQN
    python -m cartpoleplusplus_tpu_torch.train --ckpt-dir ckpt/ \
        --event-log run.cpe --event-log-envs 64   # resumable, traced
    python -m cartpoleplusplus_tpu_torch.train --ckpt-dir ckpt/ --eval-only
    python -m cartpoleplusplus_tpu_torch.train --device cpu --num-envs 64
    torchrun --nproc-per-node 2 -m cartpoleplusplus_tpu_torch.train \
        --learner shardmap                   # 2 ranks, one card each (NCCL)
    torchrun --nproc-per-node 2 -m cartpoleplusplus_tpu_torch.train \
        --dist-backend gloo                  # 2 ranks sharing one card

Prints one JSON line of metrics every --log-interval train steps and, with
--final-eval, one line of greedy-policy episode statistics. On a CUDA
device each train step's rollout runs a kernel (B2 for DDPG, B4 for DQN,
B6 for NAF, B8 for LRPG) where it covers the config; outside that coverage
the plain torch rollout runs on the card, with one stderr line naming the
kernel it does not use (`rollout_impl` 0 in the metrics). At
`--<agent>.learner auto` (the default but for NAF, whose default is the
plain learner, `xla`, as in the reference), each learning step's update
runs the agent's fused learner kernel (B3, B5, B7, B9) where it covers the
config (`learner_impl` says which learner ran). DDPG and NAF train on the
continuous preset of the env. `--obs-mode pixels` (DDPG, DQN, NAF and
LRPG) renders every env-step's frames through kernel B10 (B11 under
CARTPOLE_RENDER_CULL=1), and the agent's plain rollout and plain learner
run the conv (or patch) nets on the card; the `--render-*` flags set the
frames, and `--render-dtype bfloat16` rounds the plain renderer's inputs
(on the card B10 renders in float32 whatever it says, as the reference's
kernel does). `--agent random` runs the
uniform-random policy for `--total-env-steps` steps per env and prints one
line of episode statistics; no kernel exists for it, so on the GPU it
steps the plain env one step at a time. `--device cuda` without a visible
GPU is an error, never a silent CPU run.

The run flags keep the reference's meaning: `--ckpt-dir` saves every
`--ckpt-interval` train steps (the reference's save policy,
ckpt/checkpoint.py) and always the final one, and a rerun resumes at the
latest step + 1;
`--no-ckpt-full` leaves the replay and the env fields off disk;
`--eval-only` restores the weights alone, at any env count, prints one
JSON line of deterministic-eval statistics and exits (`--eval-render DIR`
dumps up to 120 RGB frames of env 0, rendered through B10 on the card);
`--event-log` appends every rollout (or the first `--event-log-envs`
envs') to a .cpe log (eventlog/); `--steps-per-dispatch k` runs windows
of k train steps, logging and saving once per window; the canary
(`--canary-*`) re-seeds a collapsed run; `--profile-dir` writes a
torch.profiler Chrome trace.

Under torchrun (WORLD_SIZE > 1) with `--use-mesh` (the default) the run is
sharded (dist/): each rank owns `num_envs / world size` envs (the global
indices `rank * local ...`), its own card (or `cuda:0` shared, over gloo)
and its replay rows. `--learner spmd` (the default) gives the unsharded
run's result: global replay draws, the minibatch assembled from every
rank's rows, the same learner on every rank; `--learner shardmap` samples
per rank and all-reduces gradients (or all-gathers the minibatches for
the kernel learners). The evals are sharded, checkpoints hold the global
state (written by rank 0, restored into any rank count that divides the
envs), the event log holds the global envs, and rank 0 alone prints and
writes. `--dist-backend` picks the process group's backend; torchrun's
environment gives the rest.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time

import torch

from .agents import (DDPG, DQN, LRPG, NAF, DDPGConfig, DQNConfig,
                     LRPGConfig, NAFConfig, RandomAgent)
from .ckpt import CheckpointManager
from .ckpt.checkpoint import state_fields
from .config import RunConfig, add_dataclass_args, explicit_dests, from_args
from .dist import make_distributed_train_step, make_shardmap_train_step
from .env import CartPole3D
from .env.pixels import RenderConfig
from .eventlog import EpisodeSink, EventLogWriter, next_episode_ids
from .physics.params import CartPoleParams, continuous_params

# agent -> (class, config class).
_AGENTS = {"ddpg": (DDPG, DDPGConfig), "dqn": (DQN, DQNConfig),
           "naf": (NAF, NAFConfig), "lrpg": (LRPG, LRPGConfig)}
# The agents that train on the continuous preset (the reference's
# train.py applies it to every continuous-action agent).
_CONTINUOUS = ("ddpg", "naf")

# Named presets: the reference's measured recipes (its BASELINE.md, TPU
# runs; no rate or eval below is a number of the port), applied to unset
# fields only (explicitly-typed flags always override preset fields).
# tests/test_torch_cli.py holds this table equal to the reference's.
# - fast (ddpg): rollout 64, K 8, batch 8192 at dispatch 32; the
#   reference measured ~40-55M env-steps/s on a TPU and final evals
#   198.7/188.6/178.6/186.9 over seeds 0-3, with the end-of-budget canary
#   re-seeding a collapsed attempt.
# - fast (lrpg): 2048 envs, 120k per-env steps through the fused
#   softmax-PG update kernel at dispatch 16; reference eval 200.0 / 200
#   (TPU).
# - fast (naf): the kernel learner at dispatch 16 with the end-of-budget
#   canary (restart budget 5); reference evals 200.0/162.6/191.3/198.6
#   over 4 seeds (TPU).
# - pixels (ddpg): grayscale uint8 48x48 2-camera obs with gain-4
#   frame-diff channels, 2048 envs, block sampling, replay 64 per env,
#   200k per-env steps with lr decay over the first 100k, weights-only
#   saves and the canary; reference restored eval 198.32 / 200 median
#   (seed 0, TPU).
_PRESETS = {
    "fast": {
        "ddpg": {
            # The canary fires at 100% of the budget: a mid-run eval does
            # not separate healthy from collapsed seeds at this cadence
            # (the reference's sweep); below 150 -> re-seed and retrain.
            "run": dict(num_envs=4096, total_env_steps=320_000,
                        steps_per_dispatch=32, canary_env_steps=320_000,
                        canary_min_eval=150.0),
            "agent": dict(rollout_steps=64, updates_per_step=8,
                          batch_size=8192, ou_sigma_decay_env_steps=64_000,
                          warmup_env_steps=0),
        },
        "lrpg": {
            "run": dict(num_envs=2048, total_env_steps=120_000,
                        steps_per_dispatch=16),
            "agent": dict(learner="kernel"),
        },
        "naf": {
            # The kernel learner redraws the seed lottery at NAF's
            # basin-boundary recipe (the reference's docs/design.md §16):
            # the end-of-budget canary re-seeds collapsed attempts.
            "run": dict(num_envs=1024, total_env_steps=80_000,
                        steps_per_dispatch=16, canary_env_steps=80_000,
                        canary_min_eval=150.0, canary_max_restarts=5),
            "agent": dict(learner="kernel"),
        },
    },
    "pixels": {
        "ddpg": {
            "run": dict(num_envs=2048, obs_mode="pixels",
                        render_grayscale=True, render_obs_uint8=True,
                        render_frame_diff=True, render_frame_diff_gain=4.0,
                        total_env_steps=200_000, steps_per_dispatch=16,
                        # End-of-budget collapse canary: long pixel runs
                        # can walk off on unlucky seeds (the reference
                        # measured ~1 in 3 draws at this horizon), hence
                        # 4 restarts.
                        canary_env_steps=200_000, canary_min_eval=150.0,
                        canary_max_restarts=4,
                        # One log per 10 dispatch windows.
                        log_interval=160,
                        # Weights-only saves: a full pixel save ships the
                        # multi-GB uint8 replay ring to disk every time.
                        # Resume loses the ring (it refills in seconds);
                        # --eval-only is unaffected.
                        ckpt_full=False),
            "agent": dict(actor_lr=3e-4, critic_lr=3e-4,
                          updates_per_step=16,
                          replay_capacity_per_env=64, sample="block",
                          ou_sigma_decay_env_steps=20_000,
                          lr_decay_env_steps=100_000),
        },
    },
}
# Checkpoint keys (the reference's field names) that a weights-only save
# leaves off disk: every env-shaped field.
_ENV_FIELDS = ("replay", "env_state", "obs", "noise")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="cartpoleplusplus_tpu_torch.train",
                                 description=__doc__.split("\n")[0])
    add_dataclass_args(ap, RunConfig)
    add_dataclass_args(ap, CartPoleParams, prefix="env.")
    for name, (_, cfg_cls) in _AGENTS.items():
        add_dataclass_args(ap, cfg_cls, prefix=f"{name}.")
    return ap


def pixel_render_config(run: RunConfig) -> RenderConfig:
    """The RenderConfig of a pixel run's `--render-*` flags."""
    return RenderConfig(
        width=run.render_size, height=run.render_size,
        grayscale=run.render_grayscale, dtype=run.render_dtype,
        obs_uint8=run.render_obs_uint8, frame_diff=run.render_frame_diff,
        frame_diff_gain=run.render_frame_diff_gain)


def build(run: RunConfig, args: argparse.Namespace, provided: set,
          mesh=None, spmd: bool = True):
    """(env, agent) from parsed configuration. DDPG's and NAF's env
    defaults to the continuous preset (continuous actions, pushes, shaped
    reward), with env fields typed on the command line always winning;
    DQN, LRPG and the random agent take the discrete env as the flags give
    it. Pixel observations render with the RenderConfig the `--render-*`
    flags give, as the reference's `build` makes it. A `run.preset` lifts
    the agent fields the user did not type to the preset's. Over a `mesh`
    the env lives on the rank's device and, when num_envs divides over the
    ranks, is this rank's shard (num_envs / mesh.size envs) under the
    sharded learner (`spmd` or shardmap); otherwise every rank runs all
    envs."""
    device = mesh.device if mesh else run.device
    if mesh and run.num_envs % mesh.size == 0:
        shard = dict(group=mesh, num_shards=mesh.size)
        num_envs = run.num_envs // mesh.size
    else:
        shard, num_envs = {}, run.num_envs
    params = from_args(CartPoleParams, args, prefix="env.")
    render_config = (None if run.obs_mode != "pixels"
                     else pixel_render_config(run))
    if run.agent == "random":
        env = CartPole3D(params, num_envs=num_envs,
                         obs_mode=run.obs_mode, device=device,
                         render_config=render_config)
        return env, RandomAgent(env, **shard)
    agent_cls, cfg_cls = _AGENTS[run.agent]
    if run.agent in _CONTINUOUS:
        preset = continuous_params()
        params = CartPoleParams(**{
            f.name: (getattr(params, f.name) if ("env." + f.name) in provided
                     else getattr(preset, f.name))
            for f in dataclasses.fields(CartPoleParams)})
    env = CartPole3D(params, num_envs=num_envs, obs_mode=run.obs_mode,
                     device=device, render_config=render_config)
    cfg = from_args(cfg_cls, args, prefix=f"{run.agent}.")
    if run.preset and run.agent in _PRESETS.get(run.preset, {}):
        cfg = dataclasses.replace(cfg, **{
            k: v for k, v in _PRESETS[run.preset][run.agent]["agent"].items()
            if f"{run.agent}.{k}" not in provided})
    return env, agent_cls(env, cfg, spmd=spmd, **shard)


def ckpt_exclude(state, run: RunConfig) -> tuple:
    """Checkpoint keys a run leaves out (the reference's rules): the
    env-shaped fields for weights-only saves; under --eval-only also every
    optimizer field, the sampling generator (`rng`) and `env_steps`, so an
    eval restores the weights alone, whatever the training run's lr
    schedule or env count was."""
    exclude = set() if run.ckpt_full else set(_ENV_FIELDS)
    if run.eval_only:
        keys = {key for _, key in state_fields(state)}
        exclude |= {k for k in keys if k.endswith("opt")}
        exclude |= {"rng", "env_steps", *_ENV_FIELDS} & keys
    return tuple(sorted(exclude))


def _eval_render(run: RunConfig, env, agent, state) -> None:
    """Up to 120 RGB frames of env 0 under the greedy policy, at least 96
    pixels a side, rendered through the env's renderer (B10 on the card,
    its twin on the CPU) and written by viz.save_frame."""
    from .ops.render_kernel import render
    from .physics import PhysState
    from .viz import save_frame

    base = (env.render_config if run.obs_mode == "pixels"
            else RenderConfig())
    demo_cfg = dataclasses.replace(
        base, width=max(base.width, 96), height=max(base.height, 96),
        grayscale=False, obs_uint8=False, dtype="float32")
    policy = agent.greedy_policy(state)
    est, obs = env.reset(run.seed)
    os.makedirs(run.eval_render, exist_ok=True)
    n_frames = min(run.eval_steps, 120)
    with torch.no_grad():
        for t in range(n_frames):
            # Render only env 0: the whole batch is never rendered or
            # copied to the host.
            env0 = PhysState(*(x[:1] for x in est.phys))
            img = render(env.params, demo_cfg, env0)[0, ..., :3]
            save_frame(os.path.join(run.eval_render, f"step{t:04d}"),
                       img.cpu().numpy())
            est, obs, _, _, _ = env.step(est, policy(obs))
    print(f"wrote {n_frames} frames to {run.eval_render}", file=sys.stderr)


def _stats_line(stats: dict, prefix: str = "") -> str:
    return json.dumps({prefix + k: float(v) for k, v in stats.items()})


def _join_group(run: RunConfig):
    """The process group of a multi-rank launch (WORLD_SIZE > 1 and
    --use-mesh): its Mesh, or None for a single-process run."""
    from .dist import initialize_multihost, make_mesh

    if not run.use_mesh or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    initialize_multihost(backend=run.dist_backend, device=run.device)
    return make_mesh()


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    provided = explicit_dests(build_parser(), argv)
    run = from_args(RunConfig, args)
    if run.agent not in _AGENTS and run.agent != "random":
        print(f"agent {run.agent!r} is not ported yet; only "
              f"{', '.join(_AGENTS)} and random are", file=sys.stderr)
        return 2
    if run.preset:
        if run.agent not in _PRESETS.get(run.preset, {}):
            print(f"unknown preset {run.preset!r} for agent "
                  f"{run.agent!r}; presets: "
                  f"{sorted(p + ':' + a for p, d in _PRESETS.items() for a in d)}",
                  file=sys.stderr)
            return 2
        run = dataclasses.replace(run, **{
            k: v for k, v in _PRESETS[run.preset][run.agent]["run"].items()
            if k not in provided})
    device = torch.device(run.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("--device cuda but no CUDA device is visible (pass --device "
              "cpu to run the plain torch path)", file=sys.stderr)
        return 2
    if device.type == "cuda":
        # Full float32, as the reference's f32 nets compute: cuDNN (the
        # pixel encoders' convs) defaults to TF32. bfloat16 products
        # reduce in float32 and round once, as XLA's do.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    try:
        mesh = _join_group(run)
    except ValueError as e:
        print(f"invalid distribution: {e}", file=sys.stderr)
        return 2
    try:
        return _run(run, args, provided, mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def _run(run: RunConfig, args, provided: set, mesh) -> int:
    """main() past the flags and the process group."""
    lead = mesh is None or mesh.rank == 0

    def say(line: str, err: bool = False) -> None:
        # Rank 0 alone prints: every rank computes the same lines.
        if lead:
            print(line, file=sys.stderr if err else sys.stdout, flush=True)

    use_shardmap = False
    if run.agent != "random":
        if run.learner not in ("spmd", "shardmap"):
            say(f"unknown learner {run.learner!r}; choose spmd or shardmap",
                err=True)
            return 2
        use_shardmap = run.learner == "shardmap"
    if use_shardmap and mesh is None:
        say("--learner shardmap needs >1 device and a learning agent "
            "(ddpg/dqn/naf/lrpg); falling back to spmd", err=True)
        use_shardmap = False
    if mesh is not None and run.num_envs % mesh.size:
        if use_shardmap:
            say(f"--learner shardmap needs num_envs divisible by the "
                f"{mesh.size}-device mesh", err=True)
            return 2
        # The reference's partitioner replicates what does not divide:
        # every rank runs the unsharded program, rank 0 reports.
        say(f"num_envs {run.num_envs} does not divide over {mesh.size} "
            f"ranks: every rank runs all envs", err=True)
    try:
        env, agent = build(run, args, provided, mesh, spmd=not use_shardmap)
    except ValueError as e:
        # e.g. --preset fast pins the lrpg and naf kernel learners, which
        # reject configs outside their coverage.
        hint = (" (note: --preset {} may pin fields, e.g. learner="
                "\"kernel\" for lrpg; override with explicit flags)"
                .format(run.preset) if run.preset else "")
        say(f"invalid configuration: {e}{hint}", err=True)
        return 2
    device = env.device
    shard = agent.group   # the mesh when the envs are sharded, else None

    if run.agent == "random":
        # total_env_steps is per env, as everywhere else.
        stats = agent.evaluate(run.seed, max(run.total_env_steps, 1))
        say(_stats_line(stats))
        return 0

    state = agent.init(run.seed)
    steps_per_call = agent.cfg.rollout_steps
    mgr, start_call = None, 0
    # Saves are collective over a sharded mesh (rank 0 writes the global
    # state); replicated ranks leave them to rank 0.
    saves = shard is not None or lead
    if run.ckpt_dir:
        mgr = CheckpointManager(run.ckpt_dir,
                                save_interval_steps=run.ckpt_interval,
                                exclude=ckpt_exclude(state, run), mesh=shard)
        latest = mgr.latest_step()
        if latest is not None:
            state = mgr.restore(state, latest)
            # The checkpoint step is the train-call index: continue at
            # latest + 1 (and the save policy's skip-older-steps lines up).
            start_call = latest + 1
            say(f"resumed from step {latest}", err=True)
            # The agents insert rollout_steps-long chunks from cursor 0; a
            # checkpoint written under another rollout length is the one
            # way to break that: floor the cursor to the chunk grid.
            rs = getattr(state, "replay", None)
            if rs is not None and rs.cursor % steps_per_call:
                cur = rs.cursor
                state = state._replace(replay=rs._replace(
                    cursor=cur // steps_per_call * steps_per_call))
                say(f"realigned replay cursor {cur} -> "
                    f"{state.replay.cursor} (rollout_steps="
                    f"{steps_per_call})", err=True)

    if run.eval_only:
        # Deterministic-policy evaluation of the restored (or fresh)
        # weights, sharded over the ranks.
        say(_stats_line(agent.evaluate(state, run.eval_steps, run.seed)))
        if run.eval_render and lead:
            # Env 0 lies in rank 0's shard.
            _eval_render(run, env, agent, state)
        return 0

    capture = bool(run.event_log)
    sink, log_envs = None, run.num_envs
    if capture and lead:
        if run.event_log_envs > 0:
            log_envs = min(run.event_log_envs, run.num_envs)
        appending = start_call > 0 and os.path.exists(run.event_log)
        # On append, continue episode numbering past the ids already in
        # the file: (env_id, episode_id) pairs stay unique.
        writer = EventLogWriter(
            run.event_log,
            metadata={"run": dataclasses.asdict(run),
                      "env": dataclasses.asdict(env.params),
                      "obs_shape": list(env.obs_shape),
                      "logged_envs": log_envs},
            append=appending)
        sink = EpisodeSink(writer, log_envs,
                           obs_as_frames=env.obs_mode == "pixels",
                           initial_episode_ids=(
                               next_episode_ids(run.event_log, log_envs)
                               if appending else None))

    if shard is None:
        step = functools.partial(agent.train_step, capture=capture)
    elif use_shardmap:
        # Shard-local replay draws; the gradients all-reduced, or the
        # minibatches all-gathered for the kernel learners.
        step = make_shardmap_train_step(agent, shard, capture=capture)
    else:
        # The unsharded program's result (dist/train.py).
        step = make_distributed_train_step(agent, shard, capture=capture)

    prof = None
    if run.profile_dir and lead:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(run.profile_dir, exist_ok=True)
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else []))
        prof.start()

    spd = max(run.steps_per_dispatch, 1)
    n_calls = max(run.total_env_steps // steps_per_call, 1)
    # The canary is clamped to the budget: a preset pins canary_env_steps
    # to its own total_env_steps, and overriding --total-env-steps alone
    # must neither disarm the end-of-budget check nor make it a mid-run
    # one.
    canary_steps = (min(run.canary_env_steps, run.total_env_steps)
                    if run.canary_env_steps > 0 else 0)
    canary_call = (None if canary_steps <= 0
                   or start_call * steps_per_call >= canary_steps
                   else -(-canary_steps // steps_per_call))
    attempt, i = 0, start_call
    t0 = time.perf_counter()
    while i < n_calls:
        # One window: k train steps, the metrics of its last.
        k = min(spd, n_calls - i)
        trajs = []
        for _ in range(k):
            state, metrics = step(state)
            if capture:
                traj = metrics.pop("traj")
            if sink is not None:
                # Slice the logged envs on the device, before the host copy.
                trajs.append(tuple(x[:, :log_envs].contiguous()
                                   for x in traj))
        if sink is not None:
            sink.add_rollout(*(torch.cat(x).cpu().numpy()
                               for x in zip(*trajs)))
            trajs = None
        i += k
        if (canary_call is not None and i >= canary_call
                and attempt <= run.canary_max_restarts):
            # Every rank computes the same (all-reduced) statistics, so
            # every rank takes the same branch.
            mean_len = float(agent.evaluate(state, run.eval_steps,
                                            run.seed + 97)
                             ["mean_episode_length"])
            healthy = mean_len >= run.canary_min_eval
            say(json.dumps({"canary_eval_mean": round(mean_len, 2),
                            "canary_at_step": i,
                            "attempt": attempt,
                            "healthy": healthy}))
            if healthy or attempt == run.canary_max_restarts:
                canary_call = None   # pass (or out of restarts): train on
            else:
                # Collapse: restart from a re-seeded init, with the call
                # index and the clock. The collapsed attempt's state is
                # dropped before the fresh one is allocated, so the card
                # never holds two replay rings.
                attempt += 1
                state = metrics = None
                if device.type == "cuda":
                    torch.cuda.empty_cache()
                state = agent.init(run.seed + 1000 * attempt)
                i = start_call
                t0 = time.perf_counter()
                continue
        window = range(i - k, i)
        if mgr is not None and saves and any(mgr.should_save(j)
                                             for j in window):
            # force: the window check above is the cadence decision; the
            # policy's own re-check would skip window-end steps that are
            # no multiple of the interval.
            mgr.save(i - 1, state, force=True)
        if any((j + 1) % run.log_interval == 0 for j in window) \
                or i == n_calls:
            m = {key: float(v) for key, v in metrics.items()}  # waits
            m["env_steps_per_sec"] = round(
                run.num_envs * steps_per_call * (i - start_call)
                / (time.perf_counter() - t0))
            m["train_step"] = i
            say(json.dumps(m))

    if prof is not None:
        prof.stop()
        prof.export_chrome_trace(os.path.join(run.profile_dir, "trace.json"))
    if mgr is not None and saves and mgr.latest_step() != n_calls - 1:
        # The interval window rarely lands on the final call: the final
        # training state must always be on disk.
        mgr.save(n_calls - 1, state, force=True)
    if run.final_eval:
        stats = agent.evaluate(state, run.eval_steps, run.seed + 1)
        say(_stats_line(stats, "eval_"))
    if sink is not None:
        sink.writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
