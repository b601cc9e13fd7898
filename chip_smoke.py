#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (cartpoleplusplus_tpu_torch).

    python3 chip_smoke.py        # from the repository root, one CUDA GPU

Phases, one line of numbers each; any failure raises and exits non-zero:
  1. device: the card's name and `nvidia-smi` name and power limit;
  2. build: nvcc builds csrc/*.cu from the checkout on first use;
  3. B1 (physics-only rollout kernel) against its plain torch twin on the
     card, 4096 envs x 25 steps, discrete and continuous params;
  4. B2 (DDPG actor-in-the-loop rollout kernel) against its twin, 4096
     envs, hidden (256, 256), 3 steps, seeded random actor weights;
  5. main path with the launch counters zeroed: the train CLI
     (`train.main`) at its defaults for 64 env-steps (8 train steps) plus
     a 200-step greedy eval; B2 must launch once per train step;
  6. with the counters zeroed again: the physics-only rollout that the
     benchmark times (4096 envs x 4096 steps), which must launch B1;
  7. where a default train step's time goes (CUDA events per part, and
     torch.profiler's device time of one step).
Then one JSON line of per-kernel numbers and, last, the device line.
The script imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import statistics
import subprocess
import sys
import time

N_ENVS = 4096
B1_STEPS = 25           # compared window (tests/test_ops.py's length)
B2_STEPS = 3            # compared window (tests/test_policy_rollout.py's)
B2_TIME_STEPS = 8       # DDPG's rollout_steps: the main-path call shape
BENCH_STEPS = 4096      # the physics-only benchmark's rollout length
SPLIT_ROUNDS = 3        # round-robin passes over the train-step parts


def _time_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps runs (CUDA events), after
    one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _close(name, got, want, rtol, atol):
    import torch

    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{name}: {m}")
    return _max_err(got, want)


def phase_b1(dev):
    from cartpoleplusplus_tpu_torch import (CartPole3D, CartPoleParams,
                                            continuous_params)
    from cartpoleplusplus_tpu_torch.ops.fused_rollout import (
        fused_rollout, reference_rollout)

    out = {}
    for name, p in (("discrete", CartPoleParams()),
                    ("continuous", continuous_params())):
        env = CartPole3D(p, num_envs=N_ENVS, device=dev)
        state, _ = env.reset(7)
        ks, kc = fused_rollout(env, state, B1_STEPS)
        rs, rc = reference_rollout(env, state, B1_STEPS)
        # tests/test_ops.py's kernel-vs-twin tolerances.
        errs = [_close(f"B1 {name} {k}", getattr(ks.phys, k),
                       getattr(rs.phys, k), tol, tol)
                for k, tol in (("pos", 2e-5), ("s", 2e-5), ("vel", 5e-4),
                               ("sd", 5e-4))]
        assert bool((ks.steps == rs.steps).all()), "B1 steps differ"
        assert bool((ks.episode == rs.episode).all()), "B1 episodes differ"
        rel = abs(float(kc) - float(rc)) / max(abs(float(rc)), 1.0)
        assert rel < 1e-4, f"B1 {name} checksum rel err {rel}"
        ms = _time_ms(lambda: fused_rollout(env, state, B1_STEPS), 20)
        plain_ms = _time_ms(lambda: reference_rollout(env, state, B1_STEPS),
                            2)
        rate = N_ENVS * B1_STEPS / (ms / 1e3)
        plain_rate = N_ENVS * B1_STEPS / (plain_ms / 1e3)
        print(f"B1 {name}: max_abs_err pos/s/vel/sd "
              f"{' '.join(f'{e:.3g}' for e in errs)}, checksum rel err "
              f"{rel:.3g}, episodes ended {int(rs.episode.sum())}; "
              f"{N_ENVS}x{B1_STEPS}: kernel {ms:.4f} ms ({rate:.4g} "
              f"env-steps/s), plain {plain_ms:.2f} ms ({plain_rate:.4g} "
              f"env-steps/s)", flush=True)
        out[name] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)
    return out


def _random_actor(dev, hidden, seed):
    """DDPG's actor at its init, with the LayerNorm parameters and the head
    redrawn from the generator so that every stage moves the actions."""
    import torch

    from cartpoleplusplus_tpu_torch.models import ActorMLP

    g = torch.Generator().manual_seed(seed)
    actor = ActorMLP(42, 2, hidden, generator=g)
    with torch.no_grad():
        for norm in actor.norms:
            norm.weight.copy_(1.0 + 0.2 * torch.randn(norm.weight.shape,
                                                      generator=g))
            norm.bias.copy_(0.1 * torch.randn(norm.bias.shape, generator=g))
        for prm in actor.head.parameters():
            prm.copy_(0.5 * torch.randn(prm.shape, generator=g))
    return actor.to(dev)


def phase_b2(dev):
    import torch

    from cartpoleplusplus_tpu_torch import CartPole3D, continuous_params
    from cartpoleplusplus_tpu_torch.ops.policy_rollout import (
        policy_rollout, reference_policy_rollout)

    env = CartPole3D(continuous_params(), num_envs=N_ENVS, device=dev)
    state, obs = env.reset(3)
    actor = _random_actor(dev, (256, 256), seed=11)
    g = torch.Generator().manual_seed(12)
    noise = (0.1 * torch.randn((N_ENVS, 2), generator=g)).to(dev)
    args = (env, actor, 0.15, state, obs, noise, 40, 0.2)
    k = policy_rollout(*args, B2_STEPS)
    r = reference_policy_rollout(*args, B2_STEPS)
    # tests/test_policy_rollout.py's tolerances.
    errs = [_close(f"B2 traj {n}", a, b, 2e-4, 2e-5)
            for n, a, b in zip(("obs", "action", "reward"), k[3], r[3])]
    assert bool((k[3][3] == r[3][3]).all()), "B2 dones differ"
    errs += [_close(f"B2 final {n}", a, b, 2e-4, 2e-5)
             for n, a, b in zip(("pos", "vel", "s", "sd", "obs", "noise"),
                                (*k[0].phys, k[1], k[2]),
                                (*r[0].phys, r[1], r[2]))]
    assert bool((k[0].steps == r[0].steps).all()), "B2 steps differ"
    assert bool((k[0].episode == r[0].episode).all()), "B2 episodes differ"
    ms = _time_ms(lambda: policy_rollout(*args, B2_TIME_STEPS), 10)
    plain_ms = _time_ms(lambda: reference_policy_rollout(*args,
                                                         B2_TIME_STEPS), 2)
    flop = N_ENVS * B2_TIME_STEPS * 2 * (42 * 256 + 256 * 256 + 256 * 2)
    print(f"B2: max_abs_err obs/action/reward {errs[0]:.3g} {errs[1]:.3g} "
          f"{errs[2]:.3g}, final state/obs/noise {max(errs[3:]):.3g}, "
          f"dones ended {int(r[3][3].sum())}; {N_ENVS}x{B2_TIME_STEPS} "
          f"hidden (256, 256): kernel {ms:.4f} ms ({flop / ms / 1e9:.4g} "
          f"TFLOP/s of actor matmul), plain {plain_ms:.2f} ms", flush=True)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)


def _zero_counts():
    from cartpoleplusplus_tpu_torch.ops.fused_rollout import fused_rollout
    from cartpoleplusplus_tpu_torch.ops.policy_rollout import policy_rollout

    fused_rollout.launches = 0
    policy_rollout.launches = 0


def _read_counts() -> dict:
    from cartpoleplusplus_tpu_torch.ops.fused_rollout import fused_rollout
    from cartpoleplusplus_tpu_torch.ops.policy_rollout import policy_rollout

    return {"B1": fused_rollout.launches, "B2": policy_rollout.launches}


def phase_main_path():
    """The train CLI at its defaults: every rollout must go through B2."""
    from cartpoleplusplus_tpu_torch import train

    total_env_steps, rollout = 64, 8
    out = io.StringIO()
    _zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train.main(["--total-env-steps", str(total_env_steps),
                         "--log-interval", "1", "--final-eval",
                         "--eval-steps", "200", "--seed", "0"])
    train_s = time.perf_counter() - t0
    launches = _read_counts()

    assert rc == 0, f"train.main returned {rc}"
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    steps, ev = lines[:-1], lines[-1]
    n_train = total_env_steps // rollout
    assert [m["train_step"] for m in steps] == list(range(1, n_train + 1))
    assert launches["B2"] == n_train, f"B2 launched {launches['B2']} times"
    for m in lines:
        assert all(math.isfinite(v) for v in m.values()), m
    assert all(m["learner_impl"] == 0.0 and m["rollout_impl"] == 1.0
               for m in steps)
    learned = [m for m in steps if m["env_steps"] >= 16]  # past warmup
    assert learned and all(m["critic_loss"] > 0.0 for m in learned)
    assert 0 < ev["eval_mean_episode_length"] <= 200 and ev["eval_episodes"] > 0
    for m in steps:
        print(f"train step {m['train_step']}: critic_loss "
              f"{m['critic_loss']:.6g} actor_loss {m['actor_loss']:.6g} "
              f"reward_mean {m['reward_mean']:.6g} done_frac "
              f"{m['done_frac']:.6g} env_steps_per_sec "
              f"{m['env_steps_per_sec']}", flush=True)
    sec_per_step = N_ENVS * rollout / steps[-1]["env_steps_per_sec"]
    print(f"main path: {n_train} train steps ({sec_per_step:.4f} s per "
          f"train step over the run, train.main total {train_s:.2f} s incl. "
          f"init and eval); eval {json.dumps(ev)}; launches {launches}",
          flush=True)
    return launches["B2"]


def phase_physics_rollout(dev):
    """The physics-only rollout that bench.py times for the JAX package,
    called here through B1's wrapper until the port has its own benchmark;
    the train path does not run B1."""
    import torch

    from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams
    from cartpoleplusplus_tpu_torch.ops.fused_rollout import fused_rollout

    env = CartPole3D(CartPoleParams(), num_envs=N_ENVS, device=dev)
    state, _ = env.reset(0)
    _zero_counts()
    t0 = time.perf_counter()
    final, checksum = fused_rollout(env, state, BENCH_STEPS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _read_counts()
    assert launches == {"B1": 1, "B2": 0}, launches
    assert math.isfinite(float(checksum))
    assert int(final.steps.max()) < 200 and int(final.episode.min()) > 0
    print(f"physics-only rollout: {N_ENVS}x{BENCH_STEPS} in {secs:.4f} s "
          f"({N_ENVS * BENCH_STEPS / secs:.4g} env-steps/s, host clock, "
          f"first call); launches {launches}", flush=True)
    return launches["B1"]


def _device_ms(prof) -> tuple:
    """(device ms, device kernels) from a torch.profiler run, summed over
    the CUDA rows as key_averages().table() sums its device total."""
    ms, n = 0.0, 0
    for e in prof.key_averages():
        if (str(getattr(e, "device_type", "")).endswith("CUDA")
                and not getattr(e, "is_user_annotation", False)):
            ms += e.self_device_time_total / 1e3
            n += e.count
    return ms, n


def phase_step_split(dev):
    """Where a train step at the CLI defaults goes: the whole step and each
    of its parts, timed alone with CUDA events (mean of a few runs after a
    warm-up, past the learner's warmup), and the device time of one step
    from torch.profiler."""
    import argparse

    import torch
    from torch.profiler import ProfilerActivity, profile

    from cartpoleplusplus_tpu_torch import train
    from cartpoleplusplus_tpu_torch.config import RunConfig, from_args
    from cartpoleplusplus_tpu_torch.ops.policy_rollout import policy_rollout

    ap = train.build_parser()
    args: argparse.Namespace = ap.parse_args([])
    _, agent = train.build(from_args(RunConfig, args), args, set())
    c = agent.cfg
    st = agent.init(0)
    for _ in range(3):  # 24 env-steps: past the 16-step warmup
        st, _ = agent.train_step(st)
    sigma = agent._sigma(st.env_steps)
    traj = policy_rollout(agent.env, st.actor, c.ou_theta, st.env_state,
                          st.obs, st.noise, st.env_steps, sigma,
                          c.rollout_steps)[3]
    batches = agent.replay.presample_columns(
        st.replay, c.batch_size, c.updates_per_step, generator=st.generator)

    def updates():
        s = st
        for k in range(c.updates_per_step):
            s, _ = agent._update_once(s, tuple(x[k] for x in batches))

    parts = {
        "whole train step": (lambda: agent.train_step(st), 5),
        "B2 rollout": (lambda: policy_rollout(
            agent.env, st.actor, c.ou_theta, st.env_state, st.obs, st.noise,
            st.env_steps, sigma, c.rollout_steps), 20),
        "replay insert": (lambda: agent.replay.add_trajectory(st.replay,
                                                              *traj), 20),
        "column presample": (lambda: agent.replay.presample_columns(
            st.replay, c.batch_size, c.updates_per_step,
            generator=st.generator), 20),
        f"{c.updates_per_step} learner updates": (updates, 5),
    }
    # Host dispatch bounds these times, so they drift with the host's load:
    # time the parts round-robin and keep each one's median round.
    rounds = {name: [] for name in parts}
    for _ in range(SPLIT_ROUNDS):
        for name, (fn, reps) in parts.items():
            rounds[name].append(_time_ms(fn, reps))
    ms = {name: statistics.median(v) for name, v in rounds.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        agent.train_step(st)
        torch.cuda.synchronize()
    dev_ms, n_kernels = _device_ms(prof)
    whole = ms["whole train step"]
    rest = whole - sum(v for k, v in ms.items() if k != "whole train step")
    idle = (f"{1.0 - dev_ms / whole:.4f}" if dev_ms > 0 else "not measured")
    print("train-step split (ms, median of rounds): " + "; ".join(
        f"{k} {v:.4f} ({' '.join(f'{x:.4f}' for x in rounds[k])})"
        for k, v in ms.items())
        + f"; step minus parts {rest:.4f}; profiler: device {dev_ms:.4f} ms "
        f"in {n_kernels} kernels, device idle share {idle}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from cartpoleplusplus_tpu_torch.ops import _native

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # full-float32 twins
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"device: {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    print(smi, flush=True)

    # The wrappers' own first-use path: nvcc runs when the library is
    # missing or older than csrc/ (always in a fresh checkout).
    stale = _native._stale()
    t0 = time.perf_counter()
    _native.load_library()
    build_s = time.perf_counter() - t0 if stale else 0.0
    regs = [ln.split(":", 1)[1].strip()
            for ln in open(_native.BUILD_LOG) if "Used" in ln]
    print(f"build: {build_s:.2f} s (nvcc, sm_90a"
          f"{'' if stale else '; library current, not rebuilt'}); "
          f"ptxas: {regs}", flush=True)

    b1 = phase_b1(dev)
    b2 = phase_b2(dev)
    b2_launches = phase_main_path()
    b1_launches = phase_physics_rollout(dev)
    phase_step_split(dev)

    b1_main = b1["discrete"]  # the benchmark's default params
    kernels = [
        dict(name="B1 fused_rollout", route="cuda",
             source="cartpoleplusplus_tpu_torch/csrc/fused_rollout.cu",
             replaces="cartpoleplusplus_tpu/ops/fused_rollout.py:104",
             launches=b1_launches,
             launched_by="physics-only rollout (bench.py's path)",
             max_abs_err=max(v["max_abs_err"] for v in b1.values()),
             ms=b1_main["ms"], plain_ms=b1_main["plain_ms"]),
        dict(name="B2 policy_rollout", route="cuda",
             source="cartpoleplusplus_tpu_torch/csrc/policy_rollout.cu",
             replaces="cartpoleplusplus_tpu/ops/policy_rollout.py:114",
             launches=b2_launches, launched_by="train.main (DDPG defaults)",
             max_abs_err=b2["max_abs_err"],
             ms=b2["ms"], plain_ms=b2["plain_ms"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
