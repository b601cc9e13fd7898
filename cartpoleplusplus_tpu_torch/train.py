"""Training CLI of the port — the `--agent ddpg`, `dqn`, `naf`, `lrpg` and
`random` flows of cartpoleplusplus_tpu.train on one device.

Usage:
    python -m cartpoleplusplus_tpu_torch.train                 # ddpg, cuda
    python -m cartpoleplusplus_tpu_torch.train --agent dqn     # dqn, cuda
    python -m cartpoleplusplus_tpu_torch.train --agent naf --naf.learner kernel
    python -m cartpoleplusplus_tpu_torch.train --agent lrpg    # lrpg, cuda
    python -m cartpoleplusplus_tpu_torch.train --agent random  # baseline
    python -m cartpoleplusplus_tpu_torch.train --obs-mode pixels \
        --num-envs 2048 --render-grayscale --render-obs-uint8 \
        --render-frame-diff --render-frame-diff-gain 4 --ddpg.sample block \
        --ddpg.replay-capacity-per-env 64    # pixel DDPG
    python -m cartpoleplusplus_tpu_torch.train --device cpu --num-envs 64

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
continuous preset of the env. `--obs-mode pixels` (DDPG only) renders
every env-step's frames through kernel B10 (B11 under
CARTPOLE_RENDER_CULL=1); the `--render-*` flags set the frames, and
`--render-dtype` takes float32 only. `--agent random` runs the
uniform-random policy for `--total-env-steps` steps per env and prints one
line of episode statistics; no kernel exists for it, so on the GPU it
steps the plain env one step at a time. `--device cuda` without a visible
GPU is an error, never a silent CPU run. Checkpoints, the event log,
presets and the canary, and the device mesh are not ported yet: their
flags are rejected.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from .agents import (DDPG, DQN, LRPG, NAF, DDPGConfig, DQNConfig,
                     LRPGConfig, NAFConfig, RandomAgent)
from .config import RunConfig, add_dataclass_args, explicit_dests, from_args
from .env import CartPole3D
from .env.pixels import RenderConfig
from .physics.params import CartPoleParams, continuous_params

# The reference CLI's run flags that have no counterpart here yet.
_NOT_PORTED = (
    "preset", "steps_per_dispatch", "ckpt_dir", "ckpt_interval", "ckpt_full",
    "event_log", "event_log_envs", "use_mesh", "learner", "eval_only",
    "eval_render", "profile_dir", "canary_env_steps", "canary_min_eval",
    "canary_max_restarts")
# agent -> (class, config class).
_AGENTS = {"ddpg": (DDPG, DDPGConfig), "dqn": (DQN, DQNConfig),
           "naf": (NAF, NAFConfig), "lrpg": (LRPG, LRPGConfig)}
# The agents that train on the continuous preset (the reference's
# train.py applies it to every continuous-action agent).
_CONTINUOUS = ("ddpg", "naf")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="cartpoleplusplus_tpu_torch.train",
                                 description=__doc__.split("\n")[0])
    add_dataclass_args(ap, RunConfig)
    add_dataclass_args(ap, CartPoleParams, prefix="env.")
    for name, (_, cfg_cls) in _AGENTS.items():
        add_dataclass_args(ap, cfg_cls, prefix=f"{name}.")
    return ap


def _not_ported(unknown) -> list:
    """The reference CLI flags among `unknown` that are not ported yet."""
    out = []
    for tok in unknown:
        if not tok.startswith("--"):
            continue
        name = tok[2:].split("=")[0]
        name = name[3:] if name.startswith("no-") else name
        dest = name.replace("-", "_")
        if dest in _NOT_PORTED:
            out.append(tok.split("=")[0])
    return out


def build(run: RunConfig, args: argparse.Namespace, provided: set):
    """(env, agent) from parsed configuration. DDPG's and NAF's env
    defaults to the continuous preset (continuous actions, pushes, shaped
    reward), with env fields typed on the command line always winning;
    DQN, LRPG and the random agent take the discrete env as the flags give
    it. Pixel observations render with the RenderConfig the `--render-*`
    flags give, as the reference's `build` makes it."""
    params = from_args(CartPoleParams, args, prefix="env.")
    render_config = None
    if run.obs_mode == "pixels":
        render_config = RenderConfig(
            width=run.render_size, height=run.render_size,
            grayscale=run.render_grayscale, dtype=run.render_dtype,
            obs_uint8=run.render_obs_uint8,
            frame_diff=run.render_frame_diff,
            frame_diff_gain=run.render_frame_diff_gain)
    if run.agent == "random":
        env = CartPole3D(params, num_envs=run.num_envs,
                         obs_mode=run.obs_mode, device=run.device,
                         render_config=render_config)
        return env, RandomAgent(env)
    agent_cls, cfg_cls = _AGENTS[run.agent]
    if run.agent in _CONTINUOUS:
        preset = continuous_params()
        params = CartPoleParams(**{
            f.name: (getattr(params, f.name) if ("env." + f.name) in provided
                     else getattr(preset, f.name))
            for f in dataclasses.fields(CartPoleParams)})
    env = CartPole3D(params, num_envs=run.num_envs, obs_mode=run.obs_mode,
                     device=run.device, render_config=render_config)
    return env, agent_cls(env, from_args(cfg_cls, args,
                                         prefix=f"{run.agent}."))


def main(argv=None) -> int:
    ap = build_parser()
    args, unknown = ap.parse_known_args(argv)
    skipped = _not_ported(unknown)
    if skipped:
        print(f"not ported to cartpoleplusplus_tpu_torch yet: "
              f"{' '.join(skipped)}", file=sys.stderr)
        return 2
    if unknown:
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")
    provided = explicit_dests(build_parser(), argv)
    run = from_args(RunConfig, args)
    if run.agent not in _AGENTS and run.agent != "random":
        print(f"agent {run.agent!r} is not ported yet; only "
              f"{', '.join(_AGENTS)} and random are", file=sys.stderr)
        return 2
    device = torch.device(run.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("--device cuda but no CUDA device is visible (pass --device "
              "cpu to run the plain torch path)", file=sys.stderr)
        return 2
    if device.type == "cuda":
        # Full float32, as the reference's f32 nets compute: cuDNN (the
        # pixel encoders' convs) defaults to TF32.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        env, agent = build(run, args, provided)
    except ValueError as e:
        print(f"invalid configuration: {e}", file=sys.stderr)
        return 2

    if run.agent == "random":
        # total_env_steps is per env, as everywhere else.
        stats = agent.evaluate(run.seed, max(run.total_env_steps, 1))
        print(json.dumps({k: float(v) for k, v in stats.items()}),
              flush=True)
        return 0

    state = agent.init(run.seed)
    steps_per_call = agent.cfg.rollout_steps
    n_calls = max(run.total_env_steps // steps_per_call, 1)
    t0 = time.perf_counter()
    for i in range(1, n_calls + 1):
        state, metrics = agent.train_step(state)
        if i % run.log_interval == 0 or i == n_calls:
            m = {k: float(v) for k, v in metrics.items()}  # waits for it
            m["env_steps_per_sec"] = round(
                run.num_envs * steps_per_call * i
                / (time.perf_counter() - t0))
            m["train_step"] = i
            print(json.dumps(m), flush=True)
    if run.final_eval:
        stats = agent.evaluate(state, run.eval_steps, run.seed + 1)
        print(json.dumps({"eval_" + k: float(v) for k, v in stats.items()}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
