"""Training CLI of the port — the `--agent ddpg` flow of
cartpoleplusplus_tpu.train on one device.

Usage:
    python -m cartpoleplusplus_tpu_torch.train                 # ddpg, cuda
    python -m cartpoleplusplus_tpu_torch.train --device cpu --num-envs 64

Prints one JSON line of metrics every --log-interval train steps and, with
--final-eval, one line of greedy-policy episode statistics. On a CUDA
device each train step's rollout runs kernel B2; a shape B2 does not
cover is an error there. `--device cuda` without a visible GPU is an
error, never a silent CPU run. Checkpoints, the event
log, presets and the canary, and the device mesh are not ported yet: their
flags are rejected.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from .agents import DDPG, DDPGConfig
from .config import RunConfig, add_dataclass_args, explicit_dests, from_args
from .env import CartPole3D
from .physics.params import CartPoleParams, continuous_params

# The reference CLI's run flags that have no counterpart here yet.
_NOT_PORTED = (
    "preset", "render_size", "render_grayscale", "render_dtype",
    "render_obs_uint8", "render_frame_diff", "render_frame_diff_gain",
    "steps_per_dispatch", "ckpt_dir", "ckpt_interval", "ckpt_full",
    "event_log", "event_log_envs", "use_mesh", "learner", "eval_only",
    "eval_render", "profile_dir", "canary_env_steps", "canary_min_eval",
    "canary_max_restarts")
_NOT_PORTED_AGENTS = ("dqn", "naf", "lrpg", "random")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="cartpoleplusplus_tpu_torch.train",
                                 description=__doc__.split("\n")[0])
    add_dataclass_args(ap, RunConfig)
    add_dataclass_args(ap, CartPoleParams, prefix="env.")
    add_dataclass_args(ap, DDPGConfig, prefix="ddpg.")
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
        if dest in _NOT_PORTED or name.split(".")[0] in _NOT_PORTED_AGENTS:
            out.append(tok.split("=")[0])
    return out


def build(run: RunConfig, args: argparse.Namespace, provided: set):
    """(env, agent) from parsed configuration. DDPG's env defaults to the
    continuous preset (continuous actions, pushes, shaped reward); env
    fields typed on the command line always win."""
    params = from_args(CartPoleParams, args, prefix="env.")
    preset = continuous_params()
    params = CartPoleParams(**{
        f.name: (getattr(params, f.name) if ("env." + f.name) in provided
                 else getattr(preset, f.name))
        for f in dataclasses.fields(CartPoleParams)})
    env = CartPole3D(params, num_envs=run.num_envs, obs_mode=run.obs_mode,
                     device=run.device)
    cfg = from_args(DDPGConfig, args, prefix="ddpg.")
    agent = DDPG(env, cfg)
    if env.device.type == "cuda" and not agent.fusable():
        raise ValueError("kernel B2 does not cover this env/actor shape "
                         "(ops.policy_rollout.fusable); the plain rollout "
                         "runs with --device cpu")
    return env, agent


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
    if run.agent != "ddpg":
        print(f"agent {run.agent!r} is not ported yet; only ddpg is",
              file=sys.stderr)
        return 2
    device = torch.device(run.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("--device cuda but no CUDA device is visible (pass --device "
              "cpu to run the plain torch path)", file=sys.stderr)
        return 2
    try:
        env, agent = build(run, args, provided)
    except ValueError as e:
        print(f"invalid configuration: {e}", file=sys.stderr)
        return 2

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
