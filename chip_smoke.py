#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (cartpoleplusplus_tpu_torch).

    python3 chip_smoke.py        # from the repository root, one CUDA GPU

Phases, one line of numbers each; any failure raises and exits non-zero:
  1. device: the card's name and `nvidia-smi` name and power limit;
  2. build: nvcc builds csrc/*.cu from the checkout on first use;
  3. B1 (physics-only rollout kernel) against its plain torch twin on the
     card, 4096 envs x 25 steps, discrete and continuous params;
  4. B2 (DDPG actor-in-the-loop rollout kernel, on the q-tile of B4)
     against its twin, 4096 envs, 3 steps, seeded random actor weights,
     at hidden (256, 256), (2048,) and (8,) * 5; its time per env-step
     beside B1's (the physics' floor);
  4b. B3 (the fused K-update DDPG learner kernel on the row chains:
     forward items of 8 rows, backward items of 4, gradient tiles; 6 grid
     barriers per update) against its twin at the CLI defaults (hidden
     (256, 256), obs 42, batch 256, K 16) from warmed Adam moments: all 8
     parameter groups and both loss vectors, two runs bit for bit, the
     "pre" / lr-schedule variant at K 4, K 4 at (8,) * 5 and K 1 at (1536,
     1536) (its row tiles' buffers in the workspace);
  5. main path with the launch counters zeroed: the train CLI
     (`train.main`) at its defaults for 64 env-steps (8 train steps) plus
     a 200-step greedy eval; B2 must launch once per train step and B3
     once per learning train step (7: the warmup is 16 env-steps);
  6. with the counters zeroed again: the physics-only rollout that the
     benchmark times (4096 envs x 4096 steps), which must launch B1;
  7. where a default train step's time goes (CUDA events per part, the B3
     phase beside the plain learner's 16 updates, and torch.profiler's
     device time and kernel count of one step);
  8. B4 (DQN epsilon-greedy Q-net-in-the-loop rollout kernel) against its
     twin, 4096 envs, 3 steps, seeded random Q weights, at hidden (256,
     256) with epsilon 0.3 and 0 (greedy) and at (2048,) and (8,) * 5
     with epsilon 0.3: actions exact except at near-ties of the twin's Q
     values (top-2 gap below 1e-5, counted and left out of the float
     comparison); its time per env-step beside B1's (the physics' floor);
  9. B5 (the fused K-update double-DQN learner kernel: forward items of
     a pass x 8 rows, backward items of 4 rows, then the gradient tiles,
     3 grid barriers per update) against its twin at the DQN
     defaults (hidden (256, 256), obs 42, batch 256, K 8) from warmed Adam
     moments, double DQN on and off, and at (2048,) (its items' buffers in
     the workspace) and (8,) * 5, two runs bit for bit each;
  10. DQN main path with the counters zeroed: `train.main --agent dqn` at
     its defaults for 64 env-steps plus a 200-step greedy eval; B4 must
     launch once per train step and B5 once per learning train step (7),
     the DDPG and physics kernels never;
  11. where a default DQN train step's time goes, as phase 7;
  11b. the stage split: B5 (DQN defaults, K 8), B3 (DDPG defaults, K 16,
     "updated" and "pre") and B7 (NAF defaults, K 8, the clip at 10 and
     off), each built again from its source with -DCP_STAGE_CLOCK into a
     library of its own (clock64() marks of every block at each grid
     barrier): per grid-synced stage of an update, its work on the
     slowest block and the barrier, and B5's item phases; B9's tile phases
     the same way; B5 must take at most 3 barriers per update, B3 at most
     6 at "updated" and 3 at "pre", B7 at most 4 with the clip and 3
     without;
  12. B8 (LRPG softmax policy in the env loop, Gumbel-max sampling)
     against its twin, 4096 envs, hidden (64, 64), (2048,) and (8,) * 5,
     3 steps from a state 6 sampled steps past a reset, seeded random
     policy weights: actions exact except at near-ties of the twin's
     logits + Gumbel draws (top-2 gap below 1e-5, counted), timed at T =
     32 beside its twin and B4 re-timed in the same call, both per
     env-step beside B1's;
  13. B9 (the fused LRPG update: 64-row tiles, register-tiled products,
     weights and accumulators resident in shared memory) against its twin
     at the LRPG defaults (N = 131,072 window rows, hidden (64, 64), lr
     3e-4, entropy 0.1) and at (2048,) (the workspace route) and (8,) * 5
     from warmed Adam moments, two runs bit for bit;
  14. LRPG main path with the counters zeroed: `train.main --agent lrpg`
     for 256 env-steps (8 train steps) plus a 200-step greedy eval; B8 and
     B9 must launch once per train step, B1-B5 never; then, zeroed again,
     `train.main --agent random` for 200 steps, which launches no kernel;
  15. where a default LRPG train step's time goes, as phase 7;
  16. B6 (NAF mu + Gaussian exploration in the env loop, on the q-tile)
     against its twin, 4096 envs, 3 steps, seeded random NafNet, at hidden
     (256, 256) with sigma 0.2 and 0 (greedy mu) and at (2048,) and (8,) *
     5 with sigma 0.2, timed at T = 8 beside its twin, B2 re-timed in
     turns with it, both per env-step beside B1's;
  17. B7 (the fused K-update NAF learner kernel, on the row chains of B3
     and B5) against its twin at the
     NAF defaults (hidden (256, 256), obs 42, batch 256, K 8, lr schedule
     on) from warmed Adam moments, with the global-norm clip at 10 (the
     default), at 0.05 (below every update's norm: the clip fires; the
     pre-clip norms are printed) and off, and at (2048,) and (8,) * 5 at
     the default clip, two runs bit for bit each;
  18. NAF main path with the counters zeroed: `train.main --agent naf
     --naf.learner kernel` for 64 env-steps plus a 200-step greedy eval; B6
     must launch once per train step and B7 once per learning train step
     (7), every other kernel never; then, zeroed again, `--agent naf` at
     its default (plain) learner for 2 train steps: B6 twice, B7 never;
  19. where a NAF kernel-learner train step's time goes, as phase 7, and
     a whole NAF train step at its default (plain) learner;
  20. B10 (the per-pixel raycast renderer) against its twin at the pixels
     preset's shape, 2048 envs x 3 repeat snapshots, 48 x 48, 2 cameras,
     grayscale and RGB, on adversarial poses and on poses of a short plain
     rollout: max abs error 1e-5 on every pixel (the pixels beyond it are
     counted and must be none);
     its ms per env-step beside the twin's and its bound;
  21. B11 (B10 with row-band culling) against B10 on the same poses, atol
     1e-6, both timed in turns, and the share of pixels culled;
  22. pixel main path with the counters zeroed: `train.main --obs-mode
     pixels` at the pixels preset's env and agent fields for 64 env-steps
     plus a 200-step greedy eval; B10 must launch once per env.step and
     env.reset and once for the cached reset frame (267 times), every other
     kernel never, and the rollout and the learner are the plain ones; then
     2 train steps under CARTPOLE_RENDER_CULL=1 (B11 18 times, B10 never);
     then `--obs-mode
     state` at the DDPG defaults for 2 train steps: one stderr line, the
     plain rollout on the card, B2 never, B3 once;
  23. where a pixel train step's time goes, as phase 7;
  24. the presets through `train.main` with the run flags, each at its
     full widths with only `--total-env-steps` cut (to 2 dispatch
     windows), in a temporary directory: `--preset fast --agent ddpg`
     (4096 envs, rollout 64, K 8, batch 8192, dispatch 32) with
     checkpoints every 16 train steps, the event log of 64 envs, the
     final eval and the profiler (B2 and B3 every train step, the saved
     steps the reference's save policy gives, a valid log of exactly 64
     env ids, a Chrome trace), its resume with a larger budget, and
     `--eval-only` at 256 envs on the kernel and the plain learner
     layouts (equal lines); `--preset fast --agent lrpg` (2048 envs, B8
     + B9) with the canary forced to fail: 3 attempts, the card memory
     the run holds at the last canary eval within 5 % of the first's;
     `--preset fast --agent naf` (1024 envs, B6 + B7); `--preset pixels`
     (B10) with its weights-only saves (no replay or env field on disk);
     the fast ddpg train step, each preset's checkpoint save and the
     event-log sink timed; and the presets' new kernel shapes against
     their twins: B3 at batch 8192, K 8 from warmed moments and B9 over a
     65,536-row window. The canary is disarmed (`--canary-env-steps 0`)
     in the runs that count launches and saves: an untrained policy fails
     it.
Then one JSON line of per-kernel numbers (each with its bound: the larger
of its float32 operations over 67 TFLOP/s and its bytes over 3.35 TB/s,
counted from this run's shapes) and, last, the device line. The script
imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
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
B3_BATCH, B3_K = 256, 16  # DDPG's batch_size and updates_per_step
B3_T0 = 100             # Adam count of the warmed state B3 starts from
# B3 against its twin after K updates: the reference's kernel-vs-XLA bar
# (tests/test_learner_kernel.py), float32 sums in different orders.
B3_RTOL, B3_ATOL = 2e-4, 1e-5
BENCH_STEPS = 4096      # the physics-only benchmark's rollout length
SPLIT_ROUNDS = 3        # round-robin passes over the train-step parts
B4_EPS = (0.3, 0.0)     # compared exploration rates: mixed, then greedy
B4_TIE = 1e-5           # a twin top-2 Q gap below this is a near-tie
# Torsos compared beside the main-path shapes of the rollout kernels (B2,
# B4, B6, B8) and of B5 and B7: one 2048 wide (the rollouts' activations
# and B5's row tiles' buffers in the workspace) and one five layers deep.
WIDE_TORSOS = ((2048,), (8,) * 5)
# B3's, each with its compared update count: five layers deep, and two
# layers of 1536 (its row tiles' buffers in the workspace). One update at
# (1536, 1536) runs the workspace route; from the 2nd update on, one
# of its ~0.8 M LayerNorm outputs per pass sits within the twins'
# accumulated rounding of the relu edge (under 1e-6 at seed 21) and flips
# there, which moves a row of the critic's gradient, and the actor loss
# through it, past the bar (PERF.md, §6).
B3_WIDE = (((8,) * 5, 4), ((1536, 1536), 1))
B5_BATCH, B5_K = 256, 8  # DQN's batch_size and updates_per_step
LRPG_HIDDEN = (64, 64)  # LRPG's hidden, rollout_steps and window rows
LRPG_T = 32
B9_N = N_ENVS * LRPG_T
NAF_SIGMAS = (0.2, 0.0)  # compared exploration scales: default, greedy mu
B7_BATCH, B7_K = 256, 8  # NAF's batch_size and updates_per_step
# The phase marks of B5's, B7's and B3's items and of B9's tile (CP_MARK
# ids 3, 4, ... in csrc/dqn_update.cu, naf_update.cu, ddpg_update.cu and
# lrpg_update.cu), for the stage split.
B5_PHASES = ("inputs", "torso forward", "head", "TD and backward")
B7_PHASES = ("forward item", "backward item", "gradient items",
             "completed slices' sums", "norm", "Adam and Polyak")
B3_PHASES = ("actor torso", "actor head", "critic front",
             "critic on (s, a)", "critic rest", "TD and critic backward",
             "actor backward")
B9_PHASES = ("obs in", "torso forward", "head", "softmax", "head backward",
             "LayerNorm backward", "layer grads", "dh = dz W")
B7_CLIPS = (10.0, 0.05, 0.0)  # the default clip, one that fires, none
# The row chains' grid barriers per update at most, by stage-split label.
SPLIT_BARRIERS = {"B5": 3, "B3": 6, "B3 pre": 3, "B7": 4, "B7 no clip": 3}
# The H100 SXM's published peaks (NVIDIA's data sheet): float32 outside
# the tensor cores and HBM3 bandwidth. A kernel's bound is the larger of
# its operations and its bytes over these.
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12
# Float operations of the env math, counted from csrc/cartpole_env.cuh (an
# add, multiply, divide, sqrt or transcendental counts one; min, max and
# comparisons none): one substep without the optional terms, its friction
# (2 tanh terms), linear and angular damping terms, one pose frame, one
# push draw, and an env-step's termination and shaped reward.
SUBSTEP_FLOP, FRICTION_FLOP, DAMPING_FLOP = 103, 10, 4
FRAME_FLOP, PUSH_FLOP, STEP_TAIL_FLOP = 24, 8, 13


def _kernel_name(mangled: str) -> str:
    """A mangled entry function -> its name, with `<0>`/`<1>` for a bool
    template flag: the identifier ending in `_kernel` that its length
    prefix delimits (names in an anonymous namespace carry a file hash
    before it)."""
    import re

    end = mangled.find("_kernel") + len("_kernel")
    for n in range(len("_kernel") + 1, end + 1):
        if mangled[:end - n].endswith(str(n)):
            flag = re.match(r"ILb([01])E", mangled[end:])
            return mangled[end - n:end] + (f"<{flag.group(1)}>" if flag
                                           else "")
    return mangled


def _ptxas_report(build_log: str) -> dict:
    """Kernel name -> the compiler's register and shared-memory line, from
    the `-Xptxas -v` output in the build log."""
    import re

    out, name = {}, None
    for ln in open(build_log):
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = _kernel_name(m.group(1))
        elif "Used" in ln and name is not None:
            out[name] = ln.split(":", 1)[1].strip()
    return out


def _bound_keys(result: dict) -> dict:
    return {k: result[k] for k in ("bound_ms", "bound_by", "library_ms")}


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


def _env_step_flop(p) -> int:
    """Float operations of one env-step (R repeats of S substeps, a frame
    and a push draw per repeat, termination and reward)."""
    sub = (SUBSTEP_FLOP + FRICTION_FLOP * (p.ground_friction != 0.0)
           + DAMPING_FLOP * ((p.linear_damping != 0.0)
                             + (p.angular_damping != 0.0)))
    rep = (p.steps_per_repeat * sub + FRAME_FLOP
           + PUSH_FLOP * (p.push_prob_per_repeat > 0.0))
    return p.action_repeats * rep + STEP_TAIL_FLOP


def _mlp_macs(dims) -> int:
    """Multiply-adds of one row through dense layers of widths dims."""
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def _nbytes(*tensors) -> int:
    import torch

    return sum(x.numel() * x.element_size() for x in tensors
               if isinstance(x, torch.Tensor))


def _bound(flop: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the HBM rate."""
    t_ops, t_bytes = flop / F32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=None)


def _rollout_bound(env, state, obs, params, num_steps, act_width,
                   extra_flop_per_step, net_macs, carry=()):
    """Bound of a policy-in-the-loop rollout: the network, the env math
    and the exploration per env-step; the state, obs, weights and carries
    read once, the trajectory, final state and obs written once."""
    b, f = env.num_envs, env.obs_size
    flop = b * num_steps * (2 * net_macs + _env_step_flop(env.params)
                            + extra_flop_per_step)
    state_bytes = _nbytes(*state.phys, state.steps, state.episode)
    traj = num_steps * b * (4 * f + 4 * act_width + 4 + 1)
    nbytes = (2 * state_bytes + _nbytes(state.env_seed) + 2 * _nbytes(obs)
              + _nbytes(params) + 2 * _nbytes(*carry) + traj)
    return _bound(flop, nbytes)


def _listed_ms(times: dict) -> str:
    """'kernel at <shape> <ms> ms, ...' for a dict of shape -> ms."""
    return ", ".join(f"kernel at {k} {v:.4f} ms" for k, v in times.items())


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
        st_bytes = _nbytes(*state.phys, state.steps, state.episode)
        out[name] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                         **_bound(N_ENVS * B1_STEPS * (_env_step_flop(p) + 2),
                                  2 * st_bytes + _nbytes(state.env_seed)
                                  + 4))
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


def _b2_compare(env, actor, state, obs, noise, label=""):
    """B2 and its twin over B2_STEPS from the same state: the trajectory,
    final state, obs and noise within tests/test_policy_rollout.py's bars,
    dones, steps and episodes exact. Returns the max abs error."""
    import torch

    from cartpoleplusplus_tpu_torch.ops.policy_rollout import (
        policy_rollout, reference_policy_rollout)

    args = (env, actor, 0.15, state, obs, noise, 40, 0.2, B2_STEPS)
    k = policy_rollout(*args)
    r = reference_policy_rollout(*args)
    torch.cuda.synchronize()
    errs = [_close(f"B2{label} traj {n}", a, b, 2e-4, 2e-5)
            for n, a, b in zip(("obs", "action", "reward"), k[3], r[3])]
    assert bool((k[3][3] == r[3][3]).all()), f"B2{label} dones differ"
    errs += [_close(f"B2{label} final {n}", a, b, 2e-4, 2e-5)
             for n, a, b in zip(("pos", "vel", "s", "sd", "obs", "noise"),
                                (*k[0].phys, k[1], k[2]),
                                (*r[0].phys, r[1], r[2]))]
    assert bool((k[0].steps == r[0].steps).all()), f"B2{label} steps differ"
    assert bool((k[0].episode == r[0].episode).all()), \
        f"B2{label} episodes differ"
    print(f"B2{label}: max_abs_err obs/action/reward {errs[0]:.3g} "
          f"{errs[1]:.3g} {errs[2]:.3g}, final state/obs/noise "
          f"{max(errs[3:]):.3g}, dones ended {int(r[3][3].sum())}",
          flush=True)
    return max(errs)


def phase_b2(dev, floor_us):
    """B2 against its twin at the DDPG default (256, 256) and at WIDE_TORSOS,
    the torsos the old tile did not take; then timed at the main path's
    shape, its time per env-step beside `floor_us` (B1's in this call)."""
    import torch

    from cartpoleplusplus_tpu_torch import CartPole3D, continuous_params
    from cartpoleplusplus_tpu_torch.ops.policy_rollout import (
        pack_actor, policy_rollout, reference_policy_rollout)

    env = CartPole3D(continuous_params(), num_envs=N_ENVS, device=dev)
    state, obs = env.reset(3)
    g = torch.Generator().manual_seed(12)
    noise = (0.1 * torch.randn((N_ENVS, 2), generator=g)).to(dev)
    errs, wide_ms = [], {}
    for hidden in WIDE_TORSOS:
        wide = _random_actor(dev, hidden, seed=11)
        errs.append(_b2_compare(env, wide, state, obs, noise, f" {hidden}"))
        wide_ms[hidden] = _time_ms(lambda: policy_rollout(
            env, wide, 0.15, state, obs, noise, 40, 0.2, B2_TIME_STEPS), 10)
        del wide
    actor = _random_actor(dev, (256, 256), seed=11)
    errs.append(_b2_compare(env, actor, state, obs, noise))
    args = (env, actor, 0.15, state, obs, noise, 40, 0.2)
    ms = _time_ms(lambda: policy_rollout(*args, B2_TIME_STEPS), 10)
    plain_ms = _time_ms(lambda: reference_policy_rollout(*args,
                                                         B2_TIME_STEPS), 2)
    flop = N_ENVS * B2_TIME_STEPS * 2 * (42 * 256 + 256 * 256 + 256 * 2)
    step_us = ms / B2_TIME_STEPS * 1e3
    print(f"B2: {N_ENVS}x{B2_TIME_STEPS} hidden (256, 256): kernel {ms:.4f} "
          f"ms ({flop / ms / 1e9:.4g} TFLOP/s of actor matmul), plain "
          f"{plain_ms:.2f} ms; per env-step {step_us:.2f} us, B1's "
          f"{floor_us:.2f} us in this call, {step_us - floor_us:.2f} us "
          f"above it; {_listed_ms(wide_ms)}", flush=True)
    # OU: two counter normals (log, sqrt, cos and 4 more each) and the
    # update and clip per component.
    bound = _rollout_bound(env, state, obs, pack_actor(actor), B2_TIME_STEPS,
                           2, 2 * 7 + 2 * 5, _mlp_macs((42, 256, 256, 2)),
                           carry=(noise,))
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, **bound)


def _b3_inputs(dev, hidden, batch, k, seed):
    """The 8 learner group buffers and K minibatches, from a seed: DDPG's
    nets with the LayerNorm parameters and heads redrawn, targets near
    them, and warmed Adam moments (m ~ 1e-2, v ~ 1e-4)."""
    import torch

    from cartpoleplusplus_tpu_torch.models import ActorMLP, CriticMLP

    g = torch.Generator().manual_seed(seed)

    def flat(net):
        with torch.no_grad():
            for prm in list(net.norms.parameters()) + list(
                    net.head.parameters()):
                prm.add_(0.2 * torch.randn(prm.shape, generator=g))
        return torch.cat([p.detach().reshape(-1) for p in net.parameters()])

    actor = flat(ActorMLP(42, 2, hidden, generator=g))
    critic = flat(CriticMLP(42, 2, hidden, generator=g))

    def near(x):
        return x + 0.01 * torch.randn(x.shape, generator=g)

    def moments(x):
        return (1e-2 * torch.randn(x.shape, generator=g),
                (1e-2 * torch.randn(x.shape, generator=g)) ** 2 + 1e-5)

    groups = [actor, critic, near(actor), near(critic), *moments(actor),
              *moments(critic)]
    obs = 0.3 * torch.randn((k, batch, 42), generator=g)
    batches = (obs, torch.rand((k, batch, 2), generator=g) * 2 - 1,
               torch.rand((k, batch), generator=g),
               obs + 0.05 * torch.randn(obs.shape, generator=g),
               torch.rand((k, batch), generator=g) < 0.1)
    return ([x.to(dev) for x in groups], tuple(x.to(dev) for x in batches))


def _b3_compare(dev, hidden, k, batch=B3_BATCH, **kw):
    """B3 and its twin on the same inputs: max abs error over the 8 groups
    and both loss vectors (held to B3_RTOL/B3_ATOL), and whether a second
    run of the kernel gave the same bits."""
    import torch

    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk

    groups, batches = _b3_inputs(dev, hidden, batch, k, seed=21)
    lay_a, lay_c = lk.actor_layout(42, hidden), lk.critic_layout(42, hidden)
    lays = (lay_a, lay_c, lay_a, lay_c, lay_a, lay_a, lay_c, lay_c)
    want = lk.update_phase_math(
        *[lk.group_views(g, lay) for g, lay in zip(groups, lays)], batches,
        B3_T0, hidden, **kw)
    runs = []
    for _ in range(2):
        got = [g.clone() for g in groups]
        losses = lk.ddpg_update_phase(got, batches, B3_T0, hidden, **kw)
        torch.cuda.synchronize()
        runs.append((got, losses))
    (got, (closs, aloss)), (got2, losses2) = runs
    bitwise = (all(torch.equal(a, b) for a, b in zip(got, got2))
               and all(torch.equal(a, b) for a, b in zip((closs, aloss),
                                                          losses2)))
    names = ("actor", "critic", "actor_t", "critic_t", "m_a", "v_a", "m_c",
             "v_c")
    errs = {}
    for name, g, lay, w in zip(names, got, lays, want[:8]):
        errs[name] = max(_close(f"B3 {name} {pname}", v, x, B3_RTOL, B3_ATOL)
                         for (pname, _), v, x in zip(
                             lay, lk.group_views(g, lay), w))
    errs["closs"] = _close("B3 closs", closs, want[8], B3_RTOL, B3_ATOL)
    errs["aloss"] = _close("B3 aloss", aloss, want[9], B3_RTOL, B3_ATOL)
    return errs, bitwise, groups, batches


def phase_b3(dev):
    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk

    hidden = (256, 256)
    kw = dict(actor_lr=1e-4, critic_lr=1e-3, gamma=0.99, tau=0.01)
    errs, bitwise, groups, batches = _b3_compare(dev, hidden, B3_K, **kw)
    assert bitwise, "B3: two runs on the same inputs differ"
    v_errs, v_bitwise, _, _ = _b3_compare(
        dev, hidden, 4, actor_grad_critic="pre", lr_schedule=(0.1, 50), **kw)
    assert v_bitwise, "B3 pre/schedule: two runs differ"
    wide_errs = {}
    for wide, k in B3_WIDE:
        w_errs, w_bitwise, w_groups, w_batches = _b3_compare(dev, wide, k,
                                                             **kw)
        assert w_bitwise, f"B3 {wide}: two runs differ"
        wide_errs.update({f"{wide} {key}": v for key, v in w_errs.items()})
        w_ms = _time_ms(lambda: lk.ddpg_update_phase(
            w_groups, w_batches, B3_T0, wide, **kw), 5)
        print(f"B3 {wide}: max_abs_err {max(w_errs.values()):.3g} at K {k} "
              f"(rtol {B3_RTOL}, atol {B3_ATOL}); two runs bitwise equal; "
              f"kernel {w_ms:.4f} ms per K {k} phase, {w_ms / k:.4f} ms per "
              f"update", flush=True)
        del w_groups, w_batches
    args = (batches, B3_T0, hidden)
    ms = _time_ms(lambda: lk.ddpg_update_phase(groups, *args, **kw), 20)
    lay_a, lay_c = lk.actor_layout(42, hidden), lk.critic_layout(42, hidden)
    views = [lk.group_views(g, lay) for g, lay in zip(
        groups, (lay_a, lay_c, lay_a, lay_c, lay_a, lay_a, lay_c, lay_c))]
    plain_ms = _time_ms(lambda: lk.update_phase_math(*views, *args, **kw), 3)
    flop = B3_K * _b3_update_flop(hidden, B3_BATCH)
    print(f"B3: max_abs_err {' '.join(f'{k} {v:.3g}' for k, v in errs.items())}"
          f" (rtol {B3_RTOL}, atol {B3_ATOL}); two runs bitwise equal; pre + "
          f"lr schedule at K 4: max_abs_err {max(v_errs.values()):.3g}, "
          f"bitwise equal; batch {B3_BATCH} x K {B3_K}, hidden (256, 256): "
          f"kernel {ms:.4f} ms ({flop / ms / 1e9:.4g} TFLOP/s of learner "
          f"matmul), plain {plain_ms:.2f} ms", flush=True)
    nbytes = 2 * _nbytes(*groups) + _nbytes(*batches) + 8 * B3_K
    return dict(max_abs_err=max(list(errs.values()) + list(v_errs.values())
                                + list(wide_errs.values())),
                ms=ms, plain_ms=plain_ms, **_bound(flop, nbytes))


def _b3_update_flop(hidden, batch) -> int:
    """Matrix-product FLOPs of one DDPG update at two hidden layers (~344
    MFLOP at the defaults): the target actor and critic, the critic's
    forward, backward to layer 0 and weight grads, then the actor's and
    the critic's forward, dQ/da, and the actor's backward and weight
    grads."""
    h0, h1 = hidden
    actor = 42 * h0 + h0 * h1 + 2 * h1          # forward MACs per row
    critic = 42 * h0 + (h0 + 2) * h1 + h1
    macs = (actor + critic
            + critic + (h1 + h0 * h1) + critic
            + actor + critic + (h1 + 2 * h1)
            + (2 * h1 + h0 * h1) + actor)
    return 2 * batch * macs


def _wrappers() -> dict:
    """Every kernel's wrapper, whose `launches` counts its kernel."""
    from cartpoleplusplus_tpu_torch.ops.fused_rollout import fused_rollout
    from cartpoleplusplus_tpu_torch.ops.learner_kernel import (
        ddpg_update_phase, dqn_update_phase, lrpg_update_phase,
        naf_update_phase)
    from cartpoleplusplus_tpu_torch.ops.naf_rollout import naf_policy_rollout
    from cartpoleplusplus_tpu_torch.ops.pg_rollout import pg_policy_rollout
    from cartpoleplusplus_tpu_torch.ops.policy_rollout import policy_rollout
    from cartpoleplusplus_tpu_torch.ops.q_rollout import q_policy_rollout
    from cartpoleplusplus_tpu_torch.ops.render_kernel import (render_culled,
                                                              render_frames)

    return {"B1": fused_rollout, "B2": policy_rollout,
            "B3": ddpg_update_phase, "B4": q_policy_rollout,
            "B5": dqn_update_phase, "B6": naf_policy_rollout,
            "B7": naf_update_phase, "B8": pg_policy_rollout,
            "B9": lrpg_update_phase, "B10": render_frames,
            "B11": render_culled}


def _only(launches: dict, **want) -> bool:
    """Whether the kernels in `want` launched that often and every other
    kernel never."""
    return all(n == want.get(k, 0) for k, n in launches.items())


def _zero_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def _read_counts() -> dict:
    return {k: fn.launches for k, fn in _wrappers().items()}


def phase_main_path():
    """The train CLI at its defaults: every rollout must go through B2 and
    every learning step's update phase through B3."""
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
    assert all(launches[k] == 0 for k in ("B1", "B4", "B5", "B6", "B7", "B8",
                                          "B9")), launches
    for m in lines:
        assert all(math.isfinite(v) for v in m.values()), m
    learned = [m for m in steps if m["env_steps"] >= 16]  # past warmup
    assert launches["B3"] == len(learned) == n_train - 1, \
        f"B3 launched {launches['B3']} times for {len(learned)} learning steps"
    assert all(m["learner_impl"] == 1.0 and m["rollout_impl"] == 1.0
               for m in steps)
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
    return launches


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
    assert _only(launches, B1=1), launches
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
    warm-up, past the learner's warmup), with the plain learner's 16
    updates beside the B3 phase that replaced them, and the device time and
    kernel count of one step from torch.profiler."""
    import argparse

    from cartpoleplusplus_tpu_torch import train
    from cartpoleplusplus_tpu_torch.config import RunConfig, from_args
    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk
    from cartpoleplusplus_tpu_torch.ops.policy_rollout import policy_rollout

    ap = train.build_parser()
    args: argparse.Namespace = ap.parse_args([])
    _, agent = train.build(from_args(RunConfig, args), args, set())
    c = agent.cfg
    assert agent.kernel_mode, "the CLI defaults did not resolve to B3"
    st = agent.init(0)
    for _ in range(3):  # 24 env-steps: past the 16-step warmup
        st, _ = agent.train_step(st)
    sigma = agent._sigma(st.env_steps)
    traj = policy_rollout(agent.env, st.actor, c.ou_theta, st.env_state,
                          st.obs, st.noise, st.env_steps, sigma,
                          c.rollout_steps)[3]
    batches = agent.replay.presample_columns(
        st.replay, c.batch_size, c.updates_per_step, generator=st.generator)

    def plain_updates():
        s = st
        for k in range(c.updates_per_step):
            s, _ = agent._update_once(s, tuple(x[k] for x in batches))

    def b3_phase():
        lk.ddpg_update_phase(st.groups, batches, st.actor_opt.count,
                             c.hidden, actor_lr=c.actor_lr,
                             critic_lr=c.critic_lr, gamma=c.gamma, tau=c.tau)

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
        f"B3 learner phase (K = {c.updates_per_step})": (b3_phase, 20),
        f"plain learner, {c.updates_per_step} updates (not in the step)": (
            plain_updates, 3),
    }
    _print_split("train-step split", parts, lambda: agent.train_step(st))


def _print_split(title, parts, step):
    """Times each part alone, round-robin (host dispatch bounds these times,
    so they drift with the host's load: each keeps its median round), and
    profiles one `step()` for its device time and kernel count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    rounds = {name: [] for name in parts}
    for _ in range(SPLIT_ROUNDS):
        for name, (fn, reps) in parts.items():
            rounds[name].append(_time_ms(fn, reps))
    ms = {name: statistics.median(v) for name, v in rounds.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    dev_ms, n_kernels = _device_ms(prof)
    whole = ms["whole train step"]
    rest = whole - sum(v for k, v in ms.items()
                       if k != "whole train step" and "not in" not in k
                       and not k.startswith("of which"))
    idle = (f"{1.0 - dev_ms / whole:.4f}" if dev_ms > 0 else "not measured")
    print(f"{title} (ms, median of rounds): " + "; ".join(
        f"{k} {v:.4f} ({' '.join(f'{x:.4f}' for x in rounds[k])})"
        for k, v in ms.items())
        + f"; step minus parts {rest:.4f}; profiler: device {dev_ms:.4f} ms "
        f"in {n_kernels} kernels, device idle share {idle}", flush=True)


def _random_qnet(dev, hidden, seed, head_scale=0.5, net_cls=None):
    """DQN's Q-net (or another 5-action torso net, `net_cls`, such as
    LRPG's PolicyMLP) at its init, with the LayerNorm parameters and the
    head redrawn from the generator so that every stage moves the argmax
    (a head_scale of 0.05 keeps the Q values near 1 and their gaps
    small)."""
    import torch

    from cartpoleplusplus_tpu_torch.models import QNetMLP

    g = torch.Generator().manual_seed(seed)
    q = (net_cls or QNetMLP)(42, 5, hidden, generator=g)
    with torch.no_grad():
        for norm in q.norms:
            norm.weight.copy_(1.0 + 0.2 * torch.randn(norm.weight.shape,
                                                      generator=g))
            norm.bias.copy_(0.1 * torch.randn(norm.bias.shape, generator=g))
        for prm in q.head.parameters():
            prm.copy_(head_scale * torch.randn(prm.shape, generator=g))
    return q.to(dev)


def _b4_setup(env, dev, hidden=(256, 256)):
    """A seeded random Q-net and a state 6 random-action steps past a
    reset (a reset pose is the same in every env, so the obs of a fresh
    batch are identical). The first layer's bias is centred on those obs,
    so the Q-net tells the envs apart: greedy actions spread over all 5
    and the Q gaps reach down to ~1e-5."""
    import torch

    from cartpoleplusplus_tpu_torch.ops.q_rollout import reference_q_rollout

    q = _random_qnet(dev, hidden, seed=13, head_scale=0.05)
    state, obs, _ = reference_q_rollout(env, q, *env.reset(3), 0, 1.0, 6)
    with torch.no_grad():
        q.torso[0].bias.copy_(-(q.torso[0].weight @ obs.mean(0)))
    return q, state, obs


def _b4_compare(env, q, state, obs, eps, label=""):
    """B4 and its twin over B2_STEPS from the same state: the action
    streams must agree except from a step where the twin's top-2 Q gap is
    below B4_TIE (such envs leave the float comparison), floats within
    tests/test_policy_rollout.py's bars, integer state exact. Returns
    (max abs error, near-tie envs)."""
    import torch

    from cartpoleplusplus_tpu_torch.ops.q_rollout import (
        q_policy_rollout, reference_q_rollout)

    k = q_policy_rollout(env, q, state, obs, 40, eps, B2_STEPS)
    r = reference_q_rollout(env, q, state, obs, 40, eps, B2_STEPS)
    torch.cuda.synchronize()
    assert k[2][1].dtype == torch.int32
    diff = k[2][1] != r[2][1]
    # An env's first mismatch must be a near-tie; its trajectory differs
    # from there on.
    first = diff & (diff.int().cumsum(0) == 1)
    with torch.no_grad():
        top = torch.topk(q(r[2][0]), 2, dim=-1).values
    gaps = top[..., 0] - top[..., 1]
    gap = gaps[first]
    assert bool((gap < B4_TIE).all()), \
        f"B4{label} eps {eps}: actions differ at Q gaps {gap.tolist()[:8]}"
    keep = ~diff.any(0)
    errs = [_close(f"B4{label} eps {eps} traj {n}", a[:, keep], b[:, keep],
                   2e-4, 2e-5)
            for n, a, b in (("obs", k[2][0], r[2][0]),
                            ("reward", k[2][2], r[2][2]))]
    assert torch.equal(k[2][3][:, keep], r[2][3][:, keep]), "B4 dones differ"
    errs += [_close(f"B4{label} eps {eps} final {n}", a[keep], b[keep],
                    2e-4, 2e-5)
             for n, a, b in zip(("pos", "vel", "s", "sd", "obs"),
                                (*k[0].phys, k[1]), (*r[0].phys, r[1]))]
    assert torch.equal(k[0].steps[keep], r[0].steps[keep]), "B4 steps differ"
    assert torch.equal(k[0].episode[keep], r[0].episode[keep]), \
        "B4 episodes differ"
    n_tie = int((~keep).sum())
    explored = float((r[2][1] != torch.argmax(q(r[2][0]), -1)).float().mean())
    per_action = torch.bincount(r[2][1].reshape(-1).long(), minlength=5)
    print(f"B4{label} eps {eps}: actions exact in {int(keep.sum())} of "
          f"{env.num_envs} envs x {B2_STEPS} steps; near-tie envs {n_tie} "
          f"(their twin top-2 Q gaps {gap.tolist()[:8]}; smallest gap over "
          f"all envs and steps {float(gaps.min()):.3g}); max_abs_err "
          f"obs/reward {errs[0]:.3g} {errs[1]:.3g}, final state/obs "
          f"{max(errs[2:]):.3g}; explored share {explored:.3f}, actions per "
          f"index {per_action.tolist()}, dones {int(r[2][3].sum())}",
          flush=True)
    return max(errs), n_tie


def phase_b4(dev, floor_us):
    """B4 against its twin at the DQN default (256, 256), eps 0.3 and 0,
    and at the shapes the old kernel did not cover, (2048,) (activations
    in the workspace) and (8,) * 5, eps 0.3; then timed at the main
    path's shape, its time per env-step beside `floor_us`, B1's per
    env-step time in this call (the physics' floor)."""
    import torch

    from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams
    from cartpoleplusplus_tpu_torch.ops.q_rollout import (
        pack_qnet, q_policy_rollout, reference_q_rollout)

    env = CartPole3D(CartPoleParams(), num_envs=N_ENVS, device=dev)
    with torch.no_grad():
        errs = []
        for hidden in WIDE_TORSOS:
            wq, wstate, wobs = _b4_setup(env, dev, hidden)
            errs.append(_b4_compare(env, wq, wstate, wobs, 0.3,
                                    f" {hidden}")[0])
            del wq
        q, state, obs = _b4_setup(env, dev)
        errs += [_b4_compare(env, q, state, obs, eps)[0] for eps in B4_EPS]
    args = (env, q, state, obs, 40, 0.3)
    ms = _time_ms(lambda: q_policy_rollout(*args, B2_TIME_STEPS), 10)
    plain_ms = _time_ms(lambda: reference_q_rollout(*args, B2_TIME_STEPS), 2)
    flop = N_ENVS * B2_TIME_STEPS * 2 * (42 * 256 + 256 * 256 + 256 * 5)
    step_us = ms / B2_TIME_STEPS * 1e3
    print(f"B4: {N_ENVS}x{B2_TIME_STEPS} hidden (256, 256): kernel {ms:.4f} "
          f"ms ({flop / ms / 1e9:.4g} TFLOP/s of Q-net matmul), plain "
          f"{plain_ms:.2f} ms; per env-step {step_us:.2f} us, B1's "
          f"{floor_us:.2f} us in this call, {step_us - floor_us:.2f} us "
          f"above it", flush=True)
    # Epsilon gate and random action: one uniform scale per env-step.
    bound = _rollout_bound(env, state, obs, pack_qnet(q), B2_TIME_STEPS, 1,
                           2, _mlp_macs((42, 256, 256, 5)))
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, **bound)


def _b5_inputs(dev, hidden, batch, k, seed):
    """The 4 DQN learner group buffers and K minibatches, from a seed: a
    Q-net with the LayerNorm parameters and head redrawn, a target near
    it, warmed Adam moments (m ~ 1e-2, v ~ 1e-4), int32 actions."""
    import torch

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
    return ([x.to(dev) for x in groups], tuple(x.to(dev) for x in batches))


def _b5_compare(groups, batches, hidden, double_dqn, tag) -> dict:
    """B5 and its twin on the same inputs: max abs error per group and of
    the loss (held to B3_RTOL/B3_ATOL); two runs must give the same
    bits."""
    import torch

    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk

    lay = lk.qnet_layout(42, hidden)
    kw = dict(lr=5e-5, gamma=0.99, tau=0.01, double_dqn=double_dqn)
    want = lk.dqn_update_phase_math(
        *[lk.group_views(g, lay) for g in groups], batches, B3_T0, hidden,
        **kw)
    runs = []
    for _ in range(2):
        got = [g.clone() for g in groups]
        loss = lk.dqn_update_phase(got, batches, B3_T0, hidden, **kw)
        torch.cuda.synchronize()
        runs.append(got + [loss])
    assert all(torch.equal(a, b) for a, b in zip(*runs)), \
        f"B5 {tag}: two runs on the same inputs differ"
    errs = {}
    for name, g, w in zip(("q", "q_t", "m", "v"), runs[0][:4], want[:4]):
        errs[f"{tag} {name}"] = max(
            _close(f"B5 {tag} {name} {pname}", v, x, B3_RTOL, B3_ATOL)
            for (pname, _), v, x in zip(lay, lk.group_views(g, lay), w))
    errs[f"{tag} loss"] = _close(f"B5 {tag} loss", runs[0][4], want[4],
                                 B3_RTOL, B3_ATOL)
    return errs


def phase_b5(dev):
    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk

    hidden = (256, 256)
    lay = lk.qnet_layout(42, hidden)
    # At seed 23 one LayerNorm output of the online net on s lands 3.4e-8
    # below the relu edge in the twin and above it in the kernel (update 2):
    # a rounding-order flip of one row's gradient, which moves m by up to
    # 1e-3, far past the bar. PERF.md records the sweep that found it.
    groups, batches = _b5_inputs(dev, hidden, B5_BATCH, B5_K, seed=21)
    errs = {}
    for double_dqn in (True, False):
        tag = "double" if double_dqn else "max"
        errs.update(_b5_compare(groups, batches, hidden, double_dqn, tag))
    for wide in WIDE_TORSOS:
        w_groups, w_batches = _b5_inputs(dev, wide, B5_BATCH, B5_K, seed=21)
        w_errs = _b5_compare(w_groups, w_batches, wide, True, f"{wide}")
        errs.update(w_errs)
        w_ms = _time_ms(lambda: lk.dqn_update_phase(
            w_groups, w_batches, B3_T0, wide, lr=5e-5, gamma=0.99, tau=0.01),
            10)
        print(f"B5 {wide}: max_abs_err {max(w_errs.values()):.3g} (rtol "
              f"{B3_RTOL}, atol {B3_ATOL}); two runs bitwise equal; kernel "
              f"{w_ms:.4f} ms per K {B5_K} phase", flush=True)
        del w_groups, w_batches
    kw = dict(lr=5e-5, gamma=0.99, tau=0.01)
    args = (batches, B3_T0, hidden)
    ms = _time_ms(lambda: lk.dqn_update_phase(groups, *args, **kw), 20)
    views = [lk.group_views(g, lay) for g in groups]
    plain_ms = _time_ms(lambda: lk.dqn_update_phase_math(*views, *args, **kw),
                        3)
    h0, h1 = hidden
    fwd = 42 * h0 + h0 * h1 + h1 * 5          # MACs per row and pass
    flop = B5_K * 2 * B5_BATCH * (3 * fwd + (5 * h1 + h1 * h0) + fwd)
    listed = " ".join(f"{k} {v:.3g}" for k, v in errs.items())
    print(f"B5: max_abs_err {listed} (rtol {B3_RTOL}, atol {B3_ATOL}); two "
          f"runs bitwise equal (double and max); batch {B5_BATCH} x K "
          f"{B5_K}, hidden (256, 256): kernel {ms:.4f} ms ({flop / ms / 1e9:.4g} TFLOP/s of learner matmul), "
          f"plain {plain_ms:.2f} ms", flush=True)
    nbytes = 2 * _nbytes(*groups) + _nbytes(*batches) + 4 * B5_K
    return dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
                **_bound(flop, nbytes))


def phase_dqn_main_path():
    """`train --agent dqn` at its defaults: every rollout must go through
    B4 and every learning step's update phase through B5."""
    from cartpoleplusplus_tpu_torch import train

    total_env_steps, rollout = 64, 8
    out = io.StringIO()
    _zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train.main(["--agent", "dqn", "--total-env-steps",
                         str(total_env_steps), "--log-interval", "1",
                         "--final-eval", "--eval-steps", "200", "--seed",
                         "0"])
    train_s = time.perf_counter() - t0
    launches = _read_counts()

    assert rc == 0, f"train.main returned {rc}"
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    steps, ev = lines[:-1], lines[-1]
    n_train = total_env_steps // rollout
    assert [m["train_step"] for m in steps] == list(range(1, n_train + 1))
    learned = [m for m in steps if m["env_steps"] >= 16]  # past warmup
    assert _only(launches, B4=n_train, B5=len(learned)) \
        and len(learned) == n_train - 1, \
        f"launches {launches} for {n_train} steps, {len(learned)} learning"
    for m in lines:
        assert all(math.isfinite(v) for v in m.values()), m
    assert all(m["learner_impl"] == 1.0 and m["rollout_impl"] == 1.0
               for m in steps)
    assert all(m["loss"] > 0.0 for m in learned)
    assert 0 < ev["eval_mean_episode_length"] <= 200
    assert ev["eval_episodes"] > 0
    for m in steps:
        print(f"dqn train step {m['train_step']}: loss {m['loss']:.6g} "
              f"epsilon {m['epsilon']:.6g} reward_mean {m['reward_mean']:.6g}"
              f" done_frac {m['done_frac']:.6g} env_steps_per_sec "
              f"{m['env_steps_per_sec']}", flush=True)
    sec_per_step = N_ENVS * rollout / steps[-1]["env_steps_per_sec"]
    print(f"dqn main path: {n_train} train steps ({sec_per_step:.4f} s per "
          f"train step over the run, train.main total {train_s:.2f} s incl. "
          f"init and eval); eval {json.dumps(ev)}; launches {launches}",
          flush=True)
    return launches


def phase_dqn_step_split(dev):
    """Where a DQN train step at the CLI defaults goes, as phase 7: the B5
    phase beside the plain learner's 8 updates."""
    from cartpoleplusplus_tpu_torch import train
    from cartpoleplusplus_tpu_torch.config import RunConfig, from_args
    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk
    from cartpoleplusplus_tpu_torch.ops.q_rollout import q_policy_rollout

    ap = train.build_parser()
    args = ap.parse_args(["--agent", "dqn"])
    _, agent = train.build(from_args(RunConfig, args), args, {"agent"})
    c = agent.cfg
    assert agent.kernel_mode, "the DQN defaults did not resolve to B5"
    st = agent.init(0)
    for _ in range(3):  # 24 env-steps: past the 16-step warmup
        st, _ = agent.train_step(st)
    eps = agent.epsilon(st.env_steps)
    traj = q_policy_rollout(agent.env, st.q, st.env_state, st.obs,
                            st.env_steps, eps, c.rollout_steps)[2]
    batches = agent.replay.presample_columns(
        st.replay, c.batch_size, c.updates_per_step, generator=st.generator)

    def plain_updates():
        s = st
        for k in range(c.updates_per_step):
            s, _ = agent._update_once(s, tuple(x[k] for x in batches))

    def b5_phase():
        lk.dqn_update_phase(st.groups, batches, st.opt.count, c.hidden,
                            lr=c.lr, gamma=c.gamma, tau=c.tau,
                            double_dqn=c.double_dqn)

    parts = {
        "whole train step": (lambda: agent.train_step(st), 5),
        "B4 rollout": (lambda: q_policy_rollout(
            agent.env, st.q, st.env_state, st.obs, st.env_steps, eps,
            c.rollout_steps), 20),
        "replay insert": (lambda: agent.replay.add_trajectory(st.replay,
                                                              *traj), 20),
        "column presample": (lambda: agent.replay.presample_columns(
            st.replay, c.batch_size, c.updates_per_step,
            generator=st.generator), 20),
        f"B5 learner phase (K = {c.updates_per_step})": (b5_phase, 20),
        f"plain learner, {c.updates_per_step} updates (not in the step)": (
            plain_updates, 3),
    }
    _print_split("dqn train-step split", parts, lambda: agent.train_step(st))


def _stage_clock_build(src: str, tag: str):
    """Starts nvcc on one learner source with -DCP_STAGE_CLOCK (the stage
    clock of csrc/learner_stages.cuh) into a library of its own beside the
    main one, compiled beside this checkout's csrc/*.cuh; the wrappers
    never load it. Returns (the process, the library path)."""
    import glob
    import os
    import shutil

    from cartpoleplusplus_tpu_torch.ops import _native

    out = os.path.join(_native.BUILD_DIR, "stage_clock", tag)
    os.makedirs(out, exist_ok=True)
    for h in glob.glob(os.path.join(_native.CSRC, "*.cuh")):
        shutil.copy(h, out)
    dst = os.path.join(out, os.path.basename(src))
    shutil.copy(src, dst)
    lib = os.path.join(out, "libstageclock.so")
    cmd = [_native._nvcc(), *_native.NVCC_FLAGS, "-DCP_STAGE_CLOCK",
           "-shared", "-o", lib, dst]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def _stage_clock_load(proc, path):
    """Waits for _stage_clock_build's nvcc and loads its library with the
    main library's argument types."""
    import ctypes

    from cartpoleplusplus_tpu_torch.ops import _native

    out = proc.communicate(timeout=600)[0]
    assert proc.returncode == 0, f"stage-clock nvcc failed:\n{out}"
    main_lib, lib = _native.load_library(), ctypes.CDLL(path)
    for name in ("cp_ddpg_workspace_floats", "cp_ddpg_update_phase",
                 "cp_dqn_workspace_floats", "cp_dqn_update_phase",
                 "cp_naf_workspace_floats", "cp_naf_update_phase",
                 "cp_lrpg_workspace_floats", "cp_lrpg_update_phase"):
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = getattr(main_lib, name).argtypes
            fn.restype = getattr(main_lib, name).restype
    lib.cp_stage_clock_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.cp_error_string = main_lib.cp_error_string
    return lib


@contextlib.contextmanager
def _use_library(lib):
    """The learner wrappers launch from `lib` (and a workspace cache of
    their own) inside the block."""
    from cartpoleplusplus_tpu_torch.ops import _native
    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk

    saved = _native._lib, lk._workspaces
    _native._lib, lk._workspaces = lib, {}
    try:
        yield
    finally:
        _native._lib, lk._workspaces = saved


def _clock_run(lib, run):
    """One launch of run() through a stage-clock library, after a warm-up
    launch: (its CUDA-event ms, per block the marks' kinds and clocks)."""
    import numpy as np
    import torch

    k_blocks, k_marks = 512, 2048  # cp_clock::kBlocks, kMarks
    with _use_library(lib):
        run()
        torch.cuda.synchronize()
        assert lib.cp_stage_clock_reset() == 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
    counts = np.zeros(k_blocks, np.int32)
    marks = np.zeros(k_blocks * k_marks, np.int64)
    assert lib.cp_stage_clock_read(marks.ctypes.data, counts.ctypes.data) == 0
    blocks = [marks[b * k_marks:b * k_marks + counts[b]]
              for b in range(k_blocks) if counts[b] > 0]
    return start.elapsed_time(end), [(m & 15, m >> 4) for m in blocks]


def _phase_totals(kind, t) -> dict:
    """Clocks from each mark to the next, summed by the later mark's kind
    (the phase it ends) for kinds 3 and up."""
    out = {}
    for kd, dt in zip(kind[1:], t[1:] - t[:-1]):
        if kd >= 3:
            out[int(kd)] = out.get(int(kd), 0) + int(dt)
    return out


def _stage_split(lib, run, k_updates, label, phases=None) -> dict:
    """One launch of run() through a stage-clock library, split by its
    marks: per grid-synced stage of an update, the critical path of its
    work (the slowest block, from the last barrier's release to its own
    arrival at the next) and the barrier itself (the release after the
    last block's arrival: the least wait over the blocks); each the mean
    over the K updates, in us at the clock that the launch's CUDA-event
    time implies (block 0's first to last mark). phases: names of the
    kernel's own phase marks (CP_MARK ids from 3), reported per update on
    the slowest block."""
    ms, blocks = _clock_run(lib, run)
    stages = []  # per block: [(start, arrive, release)]
    for kind, t in blocks:
        assert kind[0] == 0, "the first mark is the kernel's start"
        rows, t0, arrive = [], t[0], None
        for kd, tt in zip(kind[1:], t[1:]):
            if kd == 2:
                arrive = tt
            elif kd == 0:
                rows.append((t0, arrive, tt))
                t0, arrive = tt, None
        stages.append(rows)
    n_stages = len(stages[0])
    assert all(len(r) == n_stages for r in stages), "blocks disagree"
    assert n_stages % k_updates == 0
    per = n_stages // k_updates
    first = stages[0]
    mhz = float(first[-1][2] - first[0][0]) / (ms * 1e3)  # cycles per us
    split = []
    for s in range(per):
        work, barrier = [], []
        for k in range(k_updates):
            i = k * per + s
            work.append(max(r[i][1] - r[i][0] for r in stages) / mhz)
            barrier.append(min(r[i][2] - r[i][1] for r in stages) / mhz)
        split.append((statistics.mean(work), statistics.mean(barrier)))
    total = sum(w + b for w, b in split)
    listed = "; ".join(
        f"stage {i + 1}: work {w:.2f} us, barrier {b:.2f} us"
        for i, (w, b) in enumerate(split))
    own = ""
    if phases:
        tot = [_phase_totals(kind, t) for kind, t in blocks]
        own = "; phases per update on the slowest block: " + ", ".join(
            f"{name} {max(x.get(i + 3, 0) for x in tot) / mhz / k_updates:.2f}"
            f" us" for i, name in enumerate(phases))
    print(f"{label} stage split: {len(stages)} blocks, {per} grid barriers "
          f"per update; per update (mean of K {k_updates}): {listed}; work "
          f"{sum(w for w, _ in split):.2f} us, barriers "
          f"{sum(b for _, b in split):.2f} us, sum {total:.2f} us; the "
          f"launch {ms:.4f} ms = {ms * 1e3 / k_updates:.2f} us per update "
          f"(clock {mhz:.0f} MHz by the marks){own}", flush=True)
    return dict(barriers_per_update=per, split=split, ms=ms)


def _phase_split(lib, run, label, phases, per_block) -> dict:
    """One launch of run() through a stage-clock library, split by the
    kernel's own phase marks (CP_MARK ids from 3, in `phases` order): each
    phase's clocks on the slowest block over its whole launch, in us per
    `per_block` (e.g. tiles a block), at the clock that the launch's
    CUDA-event time implies (the slowest block's first to last mark)."""
    ms, blocks = _clock_run(lib, run)
    span = max(int(t[-1] - t[0]) for _, t in blocks)
    mhz = span / (ms * 1e3)
    tot = [_phase_totals(kind, t) for kind, t in blocks]
    us = {name: max(x.get(i + 3, 0) for x in tot) / mhz / per_block
          for i, name in enumerate(phases)}
    print(f"{label} phase split: {len(blocks)} blocks; per {per_block} "
          f"of a block's work, on the slowest block: " + ", ".join(
              f"{k} {v:.2f} us" for k, v in us.items())
          + f"; the launch {ms:.4f} ms (clock {mhz:.0f} MHz by the marks)",
          flush=True)
    return dict(us=us, ms=ms)


def phase_stage_split(dev):
    """How an update's time splits between its grid barriers and the work
    between them, each learner through a separate build of its source with
    the stage clock: B5 at the DQN defaults (K 8, batch 256, hidden (256,
    256), double DQN; and its row chain's phases), B3 at the DDPG defaults
    (K 16) at "updated" and "pre", B7 at the NAF defaults (K 8, lr
    schedule) with the clip at 10 and off; and B9's tile at the LRPG
    defaults by its phases."""
    import os

    from cartpoleplusplus_tpu_torch.agents.common import lr_schedule
    from cartpoleplusplus_tpu_torch.agents.naf import NAFConfig
    from cartpoleplusplus_tpu_torch.ops import _native
    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk

    src = {"B5": os.path.join(_native.CSRC, "dqn_update.cu"),
           "B3": os.path.join(_native.CSRC, "ddpg_update.cu"),
           "B7": os.path.join(_native.CSRC, "naf_update.cu"),
           "B9": os.path.join(_native.CSRC, "lrpg_update.cu")}
    builds = {k: _stage_clock_build(v, k) for k, v in src.items()}
    libs = {k: _stage_clock_load(*v) for k, v in builds.items()}
    hidden = (256, 256)
    groups, batches = _b5_inputs(dev, hidden, B5_BATCH, B5_K, seed=21)
    out = {"B5": _stage_split(libs["B5"], lambda: lk.dqn_update_phase(
        groups, batches, B3_T0, hidden, lr=5e-5, gamma=0.99, tau=0.01),
        B5_K, "B5", phases=B5_PHASES)}
    groups, batches = _b3_inputs(dev, hidden, B3_BATCH, B3_K, seed=21)
    for agc, tag in (("updated", "B3"), ("pre", "B3 pre")):
        out[tag] = _stage_split(libs["B3"], lambda: lk.ddpg_update_phase(
            groups, batches, B3_T0, hidden, actor_lr=1e-4, critic_lr=1e-3,
            gamma=0.99, tau=0.01, actor_grad_critic=agc), B3_K, tag,
            phases=B3_PHASES)
    cfg = NAFConfig()
    groups, batches = _b7_inputs(dev, hidden, B7_BATCH, B7_K, seed=33)
    for clip, tag in ((cfg.max_grad_norm, "B7"), (0.0, "B7 no clip")):
        out[tag] = _stage_split(libs["B7"], lambda: lk.naf_update_phase(
            groups, batches, B3_T0, hidden, lr=cfg.lr, gamma=cfg.gamma,
            tau=cfg.tau, max_grad_norm=clip, lr_schedule=lr_schedule(cfg)),
            B7_K, tag, phases=B7_PHASES)
    groups, window = _b9_inputs(dev, LRPG_HIDDEN, seed=29)
    _, rpb, _ = lk.pg_plan(42, LRPG_HIDDEN, B9_N)
    out["B9"] = _phase_split(libs["B9"], lambda: lk.lrpg_update_phase(
        groups, window, B3_T0, LRPG_HIDDEN, lr=3e-4, entropy_coef=0.1),
        "B9", B9_PHASES, rpb // lk.pg_tile_rows(42, LRPG_HIDDEN))
    return out


def _random_policy(dev, hidden, seed):
    """LRPG's policy, its LayerNorm parameters and head redrawn, the
    head's scale falling with the width (0.5 at 64) so that the logits'
    spread does not grow with it."""
    from cartpoleplusplus_tpu_torch.models import PolicyMLP

    return _random_qnet(dev, hidden, seed, 0.5 * (64 / hidden[-1]) ** 0.5,
                        net_cls=PolicyMLP)


def _pg_gaps(net, obs, env_seed, t0):
    """The twin's gap between the two largest logits + Gumbel draws per
    step and env: the margin by which each sample was taken."""
    import torch

    from cartpoleplusplus_tpu_torch.ops.pg_rollout import gumbel_scores

    with torch.no_grad():
        top = torch.stack([
            torch.topk(gumbel_scores(net(o), env_seed, t0 + i), 2).values
            for i, o in enumerate(obs)])
    return top[..., 0] - top[..., 1]


def _b8_compare(env, net, label):
    """B8 against its twin over B2_STEPS from a state 6 sampled steps past
    a reset, the first layer centred on its obs: the action streams must
    agree except from a step where the twin's top-2 gap of logits +
    Gumbel draws is below B4_TIE (such envs leave the float comparison,
    counted), floats within tests/test_policy_rollout.py's bars, integer
    state exact. Returns (max abs error, near-tie envs, state, obs)."""
    import torch

    from cartpoleplusplus_tpu_torch.ops.pg_rollout import (
        pg_policy_rollout, reference_pg_rollout)

    state, obs, _ = reference_pg_rollout(env, net, *env.reset(5), 0, 6)
    # The obs of the batch are still alike: centre the first layer on them
    # (as _b4_setup does) so that the logits, and the samples, vary.
    with torch.no_grad():
        net.torso[0].bias.copy_(-(net.torso[0].weight @ obs.mean(0)))
    k = pg_policy_rollout(env, net, state, obs, 40, B2_STEPS)
    r = reference_pg_rollout(env, net, state, obs, 40, B2_STEPS)
    torch.cuda.synchronize()
    assert k[2][1].dtype == torch.int32
    diff = k[2][1] != r[2][1]
    first = diff & (diff.int().cumsum(0) == 1)  # an env's first mismatch
    gaps = _pg_gaps(net, r[2][0], state.env_seed, 40)
    gap = gaps[first]
    assert bool((gap < B4_TIE).all()), \
        f"B8{label}: actions differ at top-2 gaps {gap.tolist()[:8]}"
    keep = ~diff.any(0)
    errs = [_close(f"B8{label} traj {n}", a[:, keep], b[:, keep], 2e-4, 2e-5)
            for n, a, b in (("obs", k[2][0], r[2][0]),
                            ("reward", k[2][2], r[2][2]))]
    assert torch.equal(k[2][3][:, keep], r[2][3][:, keep]), "B8 dones differ"
    errs += [_close(f"B8{label} final {n}", a[keep], b[keep], 2e-4, 2e-5)
             for n, a, b in zip(("pos", "vel", "s", "sd", "obs"),
                                (*k[0].phys, k[1]), (*r[0].phys, r[1]))]
    assert torch.equal(k[0].steps[keep], r[0].steps[keep]), "B8 steps differ"
    assert torch.equal(k[0].episode[keep], r[0].episode[keep]), \
        "B8 episodes differ"
    per_action = torch.bincount(r[2][1].reshape(-1).long(), minlength=5)
    assert bool((per_action > 0).all()), per_action.tolist()
    n_tie = int((~keep).sum())
    print(f"B8{label}: actions exact in {int(keep.sum())} of {N_ENVS} envs x "
          f"{B2_STEPS} steps; near-tie envs {n_tie} (their twin top-2 gaps "
          f"{gap.tolist()[:8]}; smallest gap over all envs and steps "
          f"{float(gaps.min()):.3g}); max_abs_err obs/reward {errs[0]:.3g} "
          f"{errs[1]:.3g}, final state/obs {max(errs[2:]):.3g}; actions per "
          f"index {per_action.tolist()}, dones {int(r[2][3].sum())}",
          flush=True)
    return max(errs), n_tie, state, obs


def phase_b8(dev, floor_us):
    """B8 against its twin (`_b8_compare`) at LRPG's (64, 64) and at
    WIDE_TORSOS's torsos; then B8 and its twin timed at LRPG's rollout length,
    B4 re-timed beside them, both per env-step beside `floor_us`, B1's
    per env-step time in this call."""
    from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams
    from cartpoleplusplus_tpu_torch.ops.pg_rollout import (
        pg_policy_rollout, reference_pg_rollout)
    from cartpoleplusplus_tpu_torch.ops.q_rollout import (pack_qnet,
                                                          q_policy_rollout)

    env = CartPole3D(CartPoleParams(), num_envs=N_ENVS, device=dev)
    errs = [_b8_compare(env, _random_policy(dev, h, seed=17), f" {h}")[0]
            for h in WIDE_TORSOS]
    net = _random_policy(dev, LRPG_HIDDEN, seed=17)
    err, n_tie, state, obs = _b8_compare(env, net, "")
    errs.append(err)

    args = (env, net, state, obs, 40)
    q = _random_qnet(dev, (256, 256), seed=13, head_scale=0.05)
    q_args = (env, q, state, obs, 40, 0.3, B2_TIME_STEPS)
    rounds = {"B8": [], "B4": []}
    for _ in range(2):  # in turns, so that both see the same card state
        rounds["B8"].append(_time_ms(
            lambda: pg_policy_rollout(*args, LRPG_T), 10))
        rounds["B4"].append(_time_ms(lambda: q_policy_rollout(*q_args), 10))
    ms, b4_ms = (statistics.median(rounds[k]) for k in ("B8", "B4"))
    plain_ms = _time_ms(lambda: reference_pg_rollout(*args, LRPG_T), 2)
    # Gumbel-max: 5 draws of 2 logs, a negation and the uniform's scale.
    bound = _rollout_bound(env, state, obs, pack_qnet(net), LRPG_T, 1,
                           5 * 5, _mlp_macs((42,) + LRPG_HIDDEN + (5,)))
    step_us, b4_step_us = ms / LRPG_T * 1e3, b4_ms / B2_TIME_STEPS * 1e3
    print(f"B8: {N_ENVS}x{LRPG_T} hidden {LRPG_HIDDEN}: kernel {ms:.4f} ms "
          f"(rounds {' '.join(f'{x:.4f}' for x in rounds['B8'])}; bound "
          f"{bound['bound_ms']:.4f} ms by {bound['bound_by']}), plain "
          f"{plain_ms:.2f} ms; B4 re-timed in this call: {b4_ms:.4f} ms per "
          f"{N_ENVS}x{B2_TIME_STEPS} at hidden (256, 256) (rounds "
          f"{' '.join(f'{x:.4f}' for x in rounds['B4'])}); per env-step B8 "
          f"{step_us:.2f} us, B4 {b4_step_us:.2f} us, B1 {floor_us:.2f} us "
          f"(above it: B8 {step_us - floor_us:.2f}, B4 "
          f"{b4_step_us - floor_us:.2f})", flush=True)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                near_tie_envs=n_tie, b4_ms=b4_ms, **bound)


def _b9_flop(n, hidden) -> int:
    """Float operations of one LRPG update over n rows: per row the
    forward, the weight gradients and the input gradients below the head
    (all but layer 0's) as 2 per multiply-add, and the LayerNorm, softmax
    and entropy epilogues at ~10 per element; then Adam at ~10 per
    parameter."""
    dims = (42,) + tuple(hidden) + (5,)
    macs = _mlp_macs(dims)
    dx = _mlp_macs(dims[1:])
    p = sum(a * b + b for a, b in zip(dims[:-1], dims[1:])) \
        + 2 * sum(hidden)
    return n * (2 * (2 * macs + dx) + 10 * (sum(hidden) + 5)) + 10 * p


def _b9_inputs(dev, hidden, seed, n=B9_N):
    """B9's 3 group buffers (a policy with redrawn LayerNorm parameters
    and head, warmed Adam moments) and a window of n rows."""
    import torch

    g = torch.Generator().manual_seed(seed)
    net = _random_policy("cpu", hidden, seed=seed)
    flat = torch.cat([p.detach().reshape(-1) for p in net.parameters()])
    groups = [x.to(dev) for x in (
        flat, 1e-2 * torch.randn(flat.shape, generator=g),
        (1e-2 * torch.randn(flat.shape, generator=g)) ** 2 + 1e-5)]
    window = tuple(x.to(dev) for x in (
        0.3 * torch.randn((n, 42), generator=g),
        torch.randint(0, 5, (n,), generator=g, dtype=torch.int32),
        torch.randn((n,), generator=g)))
    return groups, window


def _b9_compare(groups, window, hidden, kw, tag) -> dict:
    """B9 and its twin on the same inputs: max abs error per group and of
    the loss (held to B3_RTOL/B3_ATOL); two runs must give the same
    bits."""
    import torch

    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk

    lay = lk.policy_layout(42, hidden)
    views = [lk.group_views(x, lay) for x in groups]
    want = lk.lrpg_update_phase_math(*views, window, B3_T0, hidden, **kw)
    runs = []
    for _ in range(2):
        got = [x.clone() for x in groups]
        loss = lk.lrpg_update_phase(got, window, B3_T0, hidden, **kw)
        torch.cuda.synchronize()
        runs.append(got + [loss])
    assert all(torch.equal(a, b) for a, b in zip(*runs)), \
        f"B9 {tag}: two runs on the same inputs differ"
    errs = {}
    for name, x, w in zip(("params", "m", "v"), runs[0][:3], want[:3]):
        errs[f"{tag}{name}"] = max(
            _close(f"B9 {tag}{name} {pname}", v, y, B3_RTOL, B3_ATOL)
            for (pname, _), v, y in zip(lay, lk.group_views(x, lay), w))
    errs[f"{tag}loss"] = _close(f"B9 {tag}loss", runs[0][3], want[3],
                                B3_RTOL, B3_ATOL)
    return errs


def phase_b9(dev):
    """B9 against its twin at the LRPG defaults and at WIDE_TORSOS (the
    2048-wide one on the workspace route), from warmed Adam moments: the
    3 groups and the loss within B3's bar, two runs bit for bit; each
    timed."""
    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk

    hidden, kw = LRPG_HIDDEN, dict(lr=3e-4, entropy_coef=0.1)
    d_errs = {}
    for wide in WIDE_TORSOS:
        w_groups, w_window = _b9_inputs(dev, wide, seed=29)
        w_errs = _b9_compare(w_groups, w_window, wide, kw, f"{wide} ")
        d_errs.update(w_errs)
        w_ms = _time_ms(lambda: lk.lrpg_update_phase(
            w_groups, w_window, B3_T0, wide, **kw), 10)
        print(f"B9 {wide}: max_abs_err {max(w_errs.values()):.3g} (rtol "
              f"{B3_RTOL}, atol {B3_ATOL}); two runs bitwise equal; N "
              f"{B9_N}: kernel {w_ms:.4f} ms", flush=True)
        del w_groups, w_window
    groups, window = _b9_inputs(dev, hidden, seed=29)
    errs = _b9_compare(groups, window, hidden, kw, "")
    lay = lk.policy_layout(42, hidden)
    views = [lk.group_views(x, lay) for x in groups]
    ms = _time_ms(lambda: lk.lrpg_update_phase(groups, window, B3_T0, hidden,
                                               **kw), 20)
    plain_ms = _time_ms(lambda: lk.lrpg_update_phase_math(
        *views, window, B3_T0, hidden, **kw), 5)
    bound = _bound(_b9_flop(B9_N, hidden),
                   _nbytes(*window) + 2 * _nbytes(*groups) + 4)
    listed = " ".join(f"{k} {v:.3g}" for k, v in errs.items())
    print(f"B9: max_abs_err {listed} (rtol {B3_RTOL}, atol {B3_ATOL}); two "
          f"runs bitwise equal; N {B9_N}, hidden {hidden}: kernel {ms:.4f} "
          f"ms (bound {bound['bound_ms']:.4f} ms by {bound['bound_by']}), "
          f"plain {plain_ms:.2f} ms", flush=True)
    return dict(max_abs_err=max(list(errs.values()) + list(d_errs.values())),
                ms=ms, plain_ms=plain_ms, **bound)


def phase_lrpg_main_path():
    """`train --agent lrpg` for 8 train steps: every rollout must go
    through B8 and every update through B9; then `train --agent random`,
    which runs no kernel."""
    from cartpoleplusplus_tpu_torch import train

    total_env_steps = 8 * LRPG_T
    out = io.StringIO()
    _zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train.main(["--agent", "lrpg", "--total-env-steps",
                         str(total_env_steps), "--log-interval", "1",
                         "--final-eval", "--eval-steps", "200", "--seed",
                         "0"])
    train_s = time.perf_counter() - t0
    launches = _read_counts()
    assert rc == 0, f"train.main returned {rc}"
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    steps, ev = lines[:-1], lines[-1]
    n_train = total_env_steps // LRPG_T
    assert [m["train_step"] for m in steps] == list(range(1, n_train + 1))
    assert _only(launches, B8=n_train, B9=n_train), launches
    for m in lines:
        assert all(math.isfinite(v) for v in m.values()), m
    assert all(m["learner_impl"] == 1.0 and m["rollout_impl"] == 1.0
               for m in steps)
    assert 0 < ev["eval_mean_episode_length"] <= 200
    assert ev["eval_episodes"] > 0
    for m in steps:
        print(f"lrpg train step {m['train_step']}: loss {m['loss']:.6g} "
              f"return_mean {m['return_mean']:.6g} reward_mean "
              f"{m['reward_mean']:.6g} done_frac {m['done_frac']:.6g} "
              f"env_steps_per_sec {m['env_steps_per_sec']}", flush=True)
    sec_per_step = N_ENVS * LRPG_T / steps[-1]["env_steps_per_sec"]
    print(f"lrpg main path: {n_train} train steps ({sec_per_step:.4f} s per "
          f"train step over the run, train.main total {train_s:.2f} s incl. "
          f"init and eval); eval {json.dumps(ev)}; launches {launches}",
          flush=True)

    out = io.StringIO()
    _zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train.main(["--agent", "random", "--total-env-steps", "200",
                         "--seed", "0"])
    random_s = time.perf_counter() - t0
    random_launches = _read_counts()
    assert rc == 0, f"train.main --agent random returned {rc}"
    assert not any(random_launches.values()), random_launches
    stats = json.loads(out.getvalue().splitlines()[-1])
    assert all(math.isfinite(v) for v in stats.values()), stats
    assert stats["episodes"] > 0 and stats["steps_per_episode"] > 0
    print(f"random agent on the card: 200 steps x {N_ENVS} envs in "
          f"{random_s:.2f} s (host clock); {json.dumps(stats)}; launches "
          f"{random_launches}", flush=True)
    return launches


def phase_lrpg_step_split(dev):
    """Where an LRPG train step at the CLI defaults goes, as phase 7: the
    B8 rollout, the returns and advantages (plain torch), the B9 update,
    and the plain learner's update beside it."""
    import torch

    from cartpoleplusplus_tpu_torch import train
    from cartpoleplusplus_tpu_torch.agents.common import adam_update
    from cartpoleplusplus_tpu_torch.agents.lrpg import returns_to_go
    from cartpoleplusplus_tpu_torch.config import RunConfig, from_args
    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk
    from cartpoleplusplus_tpu_torch.ops.pg_rollout import pg_policy_rollout

    ap = train.build_parser()
    args = ap.parse_args(["--agent", "lrpg"])
    _, agent = train.build(from_args(RunConfig, args), args, {"agent"})
    c, b = agent.cfg, agent.env.num_envs
    assert agent.kernel_mode, "the LRPG defaults did not resolve to B9"
    st = agent.init(0)
    for _ in range(2):
        st, _ = agent.train_step(st)
    obs_t, act_t, rew_t, done_t = pg_policy_rollout(
        agent.env, st.policy, st.env_state, st.obs, st.env_steps,
        c.rollout_steps)[2]

    def advantages():
        g = returns_to_go(rew_t, done_t, c.gamma, st.baseline.expand(b))
        adv = g - g.mean()
        return adv / (torch.sqrt(torch.mean(adv * adv)) + 1e-6)

    n = b * c.rollout_steps
    window = (obs_t.reshape(n, -1), act_t.reshape(n),
              advantages().reshape(n))

    def plain_update():
        loss = agent._loss(st.policy, obs_t, act_t, window[2].reshape(
            rew_t.shape))
        grads = torch.autograd.grad(loss, list(st.policy.parameters()))
        adam_update(st.policy, grads, st.opt, c.lr)

    parts = {
        "whole train step": (lambda: agent.train_step(st), 5),
        "B8 rollout": (lambda: pg_policy_rollout(
            agent.env, st.policy, st.env_state, st.obs, st.env_steps,
            c.rollout_steps), 20),
        "returns and advantages": (advantages, 20),
        "B9 update": (lambda: lk.lrpg_update_phase(
            st.groups, window, st.opt.count, c.hidden, lr=c.lr,
            entropy_coef=c.entropy_coef), 20),
        "plain learner update (not in the step)": (plain_update, 5),
    }
    _print_split("lrpg train-step split", parts, lambda: agent.train_step(st))


def _random_naf(dev, hidden, seed, mu_scale=None):
    """NAF's net at its init, with the LayerNorm parameters and the head
    redrawn from the generator so that mu, V and L move with every stage;
    the head's scale 0.5 / sqrt(H) keeps its rows near unit size (mu
    inside the tanh's range, a loss of order 1). A `mu_scale` redraws the
    mu rows at that scale (0.5, as B2's actor head here, saturates the
    actions: resets and the clip then occur within a few steps)."""
    import torch

    from cartpoleplusplus_tpu_torch.models import NafNet

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


def phase_b6(dev, floor_us):
    """B6 against its twin at sigma 0.2 and 0 over B2_STEPS (the
    trajectory, final state and obs within tests/test_policy_rollout.py's
    bars, dones, steps and episodes exact), at (256, 256) and, at sigma
    0.2, at WIDE_TORSOS; then B6 and its twin timed at NAF's rollout length,
    B2 re-timed in turns with B6, each per env-step beside `floor_us`."""
    import torch

    from cartpoleplusplus_tpu_torch import CartPole3D, continuous_params
    from cartpoleplusplus_tpu_torch.ops.naf_rollout import (
        naf_policy_rollout, pack_naf_mu, reference_naf_rollout)
    from cartpoleplusplus_tpu_torch.ops.policy_rollout import policy_rollout

    env = CartPole3D(continuous_params(), num_envs=N_ENVS, device=dev)
    state, obs = env.reset(3)
    net = _random_naf(dev, (256, 256), seed=31, mu_scale=0.5)
    cases = [((256, 256), sigma, net) for sigma in NAF_SIGMAS]
    cases += [(hidden, NAF_SIGMAS[0], None) for hidden in WIDE_TORSOS]
    errs, wide_ms = [], {}
    for hidden, sigma, case_net in cases:
        if case_net is None:
            case_net = _random_naf(dev, hidden, seed=31, mu_scale=0.5)
            wide_ms[hidden] = _time_ms(lambda: naf_policy_rollout(
                env, case_net, state, obs, 40, sigma, B2_TIME_STEPS), 10)
        label = f"B6 {hidden} sigma {sigma}"
        k = naf_policy_rollout(env, case_net, state, obs, 40, sigma,
                               B2_STEPS)
        r = reference_naf_rollout(env, case_net, state, obs, 40, sigma,
                                  B2_STEPS)
        torch.cuda.synchronize()
        e = [_close(f"{label} traj {n}", a, b, 2e-4, 2e-5)
             for n, a, b in zip(("obs", "action", "reward"), k[2], r[2])]
        assert torch.equal(k[2][3], r[2][3]), f"{label}: dones"
        e += [_close(f"{label} final {n}", a, b, 2e-4, 2e-5)
              for n, a, b in zip(("pos", "vel", "s", "sd", "obs"),
                                 (*k[0].phys, k[1]), (*r[0].phys, r[1]))]
        assert torch.equal(k[0].steps, r[0].steps), f"{label}: steps differ"
        assert torch.equal(k[0].episode, r[0].episode), \
            f"{label}: episodes differ"
        clipped = float((r[2][1].abs() == 1.0).float().mean())
        print(f"{label}: max_abs_err obs/action/reward {e[0]:.3g} "
              f"{e[1]:.3g} {e[2]:.3g}, final state/obs {max(e[3:]):.3g}; "
              f"dones {int(r[2][3].sum())}, action share at the clip "
              f"{clipped:.4f}", flush=True)
        errs += e
        del case_net
    args = (env, net, state, obs, 40, NAF_SIGMAS[0])
    actor = _random_actor(dev, (256, 256), seed=11)
    b2_args = (env, actor, 0.15, state, obs,
               torch.zeros((N_ENVS, 2), device=dev), 40, 0.2, B2_TIME_STEPS)
    rounds = {"B6": [], "B2": []}
    for _ in range(2):  # in turns, so that both see the same card state
        rounds["B6"].append(_time_ms(
            lambda: naf_policy_rollout(*args, B2_TIME_STEPS), 10))
        rounds["B2"].append(_time_ms(lambda: policy_rollout(*b2_args), 10))
    ms, b2_ms = (statistics.median(rounds[k]) for k in ("B6", "B2"))
    plain_ms = _time_ms(lambda: reference_naf_rollout(*args, B2_TIME_STEPS),
                        2)
    # Two counter normals (7 float ops each), the scale and the add per
    # component; the clip is a min and a max.
    bound = _rollout_bound(env, state, obs, pack_naf_mu(net), B2_TIME_STEPS,
                           2, 2 * 7 + 2 * 2, _mlp_macs((42, 256, 256, 2)))
    us = {k: v / B2_TIME_STEPS * 1e3 for k, v in (("B6", ms), ("B2", b2_ms))}
    print(f"B6: {N_ENVS}x{B2_TIME_STEPS} hidden (256, 256): kernel {ms:.4f} "
          f"ms (rounds {' '.join(f'{x:.4f}' for x in rounds['B6'])}; bound "
          f"{bound['bound_ms']:.4f} ms by {bound['bound_by']}), plain "
          f"{plain_ms:.2f} ms; B2 re-timed in this call: {b2_ms:.4f} ms "
          f"(rounds {' '.join(f'{x:.4f}' for x in rounds['B2'])}); per "
          f"env-step B6 {us['B6']:.2f} us, B2 {us['B2']:.2f} us, B1's "
          f"{floor_us:.2f} us in this call; B6 {_listed_ms(wide_ms)}",
          flush=True)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, b2_ms=b2_ms,
                **bound)


def _b7_inputs(dev, hidden, batch, k, seed):
    """The 4 NAF learner group buffers and K minibatches, from a seed: a
    NafNet with the LayerNorm parameters and head redrawn, a target near
    it, warmed Adam moments (m ~ 1e-2, v ~ 1e-4), actions in [-1, 1]."""
    import torch

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
    return ([x.to(dev) for x in groups], tuple(x.to(dev) for x in batches))


def _b7_update_flop(hidden, batch) -> int:
    """Matrix-product FLOPs of one NAF update at two hidden layers (~97
    MFLOP at the defaults): the target's torso and V row on s', the online
    torso and 6-row head on s, the head's and layer 1's input gradients,
    and every weight gradient."""
    h0, h1 = hidden
    torso = 42 * h0 + h0 * h1
    macs = ((torso + h1) + (torso + 6 * h1) + (6 * h1 + h1 * h0)
            + (torso + 6 * h1))
    return 2 * batch * macs


def _b7_compare(groups, batches, hidden, kw, tag) -> dict:
    """B7 and its twin on the same inputs at the settings kw: max abs
    error per group and of the loss (held to B3_RTOL/B3_ATOL); two runs
    must give the same bits; a clip below 1 must fire at every update.
    Prints the twin's pre-clip global norms and losses."""
    import torch

    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk

    lay = lk.naf_layout(42, hidden)
    clip = kw["max_grad_norm"]
    want = lk.naf_update_phase_math(
        *[lk.group_views(g, lay) for g in groups], batches, B3_T0, hidden,
        **kw)
    if 0.0 < clip < 1.0:
        assert bool((want[5] > clip).all()), \
            f"B7 {tag} does not fire: norms {want[5].tolist()}"
    runs = []
    for _ in range(2):
        got = [g.clone() for g in groups]
        loss = lk.naf_update_phase(got, batches, B3_T0, hidden, **kw)
        torch.cuda.synchronize()
        runs.append(got + [loss])
    assert all(torch.equal(a, b) for a, b in zip(*runs)), \
        f"B7 {tag}: two runs on the same inputs differ"
    errs = {}
    for name, g, w in zip(("params", "target", "m", "v"), runs[0][:4],
                          want[:4]):
        errs[f"{tag} {name}"] = max(
            _close(f"B7 {tag} {name} {pname}", v, x, B3_RTOL, B3_ATOL)
            for (pname, _), v, x in zip(lay, lk.group_views(g, lay), w))
    errs[f"{tag} loss"] = _close(f"B7 {tag} loss", runs[0][4], want[4],
                                 B3_RTOL, B3_ATOL)
    print(f"B7 {tag}: max_abs_err {max(errs.values()):.3g}, bitwise "
          f"repeatable; pre-clip global norms per update "
          f"{' '.join(f'{x:.4g}' for x in want[5].tolist())}; losses "
          f"{' '.join(f'{x:.4g}' for x in want[4].tolist())}", flush=True)
    return errs


def phase_b7(dev):
    """B7 against its twin at the NAF defaults from warmed Adam moments,
    at each of B7_CLIPS: the 4 groups and the loss within B3's bar, two
    runs bit for bit; the twin's pre-clip global norm of every update;
    then at WIDE_TORSOS at the default clip."""
    from cartpoleplusplus_tpu_torch.agents.common import lr_schedule
    from cartpoleplusplus_tpu_torch.agents.naf import NAFConfig
    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk

    cfg = NAFConfig()
    hidden = tuple(cfg.hidden)
    lay = lk.naf_layout(42, hidden)
    groups, batches = _b7_inputs(dev, hidden, B7_BATCH, B7_K, seed=33)
    base = dict(lr=cfg.lr, gamma=cfg.gamma, tau=cfg.tau,
                lr_schedule=lr_schedule(cfg))
    errs = {}
    for clip in B7_CLIPS:
        errs.update(_b7_compare(groups, batches, hidden,
                                dict(base, max_grad_norm=clip),
                                f"clip {clip}"))
    for wide in WIDE_TORSOS:
        w_groups, w_batches = _b7_inputs(dev, wide, B7_BATCH, B7_K, seed=33)
        w_kw = dict(base, max_grad_norm=cfg.max_grad_norm)
        errs.update(_b7_compare(w_groups, w_batches, wide, w_kw,
                                f"{wide} clip {cfg.max_grad_norm}"))
        w_ms = _time_ms(lambda: lk.naf_update_phase(
            w_groups, w_batches, B3_T0, wide, **w_kw), 10)
        print(f"B7 {wide}: kernel {w_ms:.4f} ms per K {B7_K} phase at clip "
              f"{cfg.max_grad_norm}", flush=True)
        del w_groups, w_batches
    kw = dict(base, max_grad_norm=cfg.max_grad_norm)
    args = (batches, B3_T0, hidden)
    ms = _time_ms(lambda: lk.naf_update_phase(groups, *args, **kw), 20)
    ms_noclip = _time_ms(lambda: lk.naf_update_phase(
        groups, *args, **dict(kw, max_grad_norm=0.0)), 20)
    views = [lk.group_views(g, lay) for g in groups]
    plain_ms = _time_ms(lambda: lk.naf_update_phase_math(*views, *args, **kw),
                        3)
    flop = B7_K * _b7_update_flop(hidden, B7_BATCH)
    bound = _bound(flop, 2 * _nbytes(*groups) + _nbytes(*batches) + 4 * B7_K)
    listed = " ".join(f"{k} {v:.3g}" for k, v in errs.items())
    print(f"B7: max_abs_err {listed} (rtol {B3_RTOL}, atol {B3_ATOL}); two "
          f"runs bitwise equal at each clip; batch {B7_BATCH} x K {B7_K}, "
          f"hidden {hidden}: kernel {ms:.4f} ms at clip "
          f"{cfg.max_grad_norm} ({flop / ms / 1e9:.4g} TFLOP/s of learner "
          f"matmul; bound {bound['bound_ms']:.4f} ms by "
          f"{bound['bound_by']}), {ms_noclip:.4f} ms without the clip "
          f"(1 grid barrier fewer per update), plain {plain_ms:.2f} ms",
          flush=True)
    return dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
                ms_noclip=ms_noclip, **bound)


def phase_naf_main_path():
    """`train --agent naf --naf.learner kernel` at the other defaults:
    every rollout must go through B6 and every learning step's update
    phase through B7; then `--agent naf` at its default learner, whose
    rollouts still go through B6 while the plain learner updates."""
    from cartpoleplusplus_tpu_torch import train

    total_env_steps, rollout = 64, 8
    out = io.StringIO()
    _zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train.main(["--agent", "naf", "--naf.learner", "kernel",
                         "--total-env-steps", str(total_env_steps),
                         "--log-interval", "1", "--final-eval",
                         "--eval-steps", "200", "--seed", "0"])
    train_s = time.perf_counter() - t0
    launches = _read_counts()
    assert rc == 0, f"train.main returned {rc}"
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    steps, ev = lines[:-1], lines[-1]
    n_train = total_env_steps // rollout
    assert [m["train_step"] for m in steps] == list(range(1, n_train + 1))
    learned = [m for m in steps if m["env_steps"] >= 16]  # past warmup
    assert _only(launches, B6=n_train, B7=len(learned)) \
        and len(learned) == n_train - 1, \
        f"launches {launches} for {n_train} steps, {len(learned)} learning"
    for m in lines:
        assert all(math.isfinite(v) for v in m.values()), m
    assert all(m["learner_impl"] == 1.0 and m["rollout_impl"] == 1.0
               for m in steps)
    assert all(m["loss"] > 0.0 for m in learned)
    assert 0 < ev["eval_mean_episode_length"] <= 200
    assert ev["eval_episodes"] > 0
    for m in steps:
        print(f"naf train step {m['train_step']}: loss {m['loss']:.6g} "
              f"reward_mean {m['reward_mean']:.6g} done_frac "
              f"{m['done_frac']:.6g} env_steps_per_sec "
              f"{m['env_steps_per_sec']}", flush=True)
    sec_per_step = N_ENVS * rollout / steps[-1]["env_steps_per_sec"]
    print(f"naf main path: {n_train} train steps ({sec_per_step:.4f} s per "
          f"train step over the run, train.main total {train_s:.2f} s incl. "
          f"init and eval); eval {json.dumps(ev)}; launches {launches}",
          flush=True)

    out = io.StringIO()
    _zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train.main(["--agent", "naf", "--total-env-steps", "16",
                         "--log-interval", "1", "--seed", "0"])
    default_s = time.perf_counter() - t0
    default_launches = _read_counts()
    assert rc == 0, f"train.main --agent naf returned {rc}"
    steps = [json.loads(x) for x in out.getvalue().splitlines()]
    assert [m["train_step"] for m in steps] == [1, 2]
    assert _only(default_launches, B6=2), default_launches
    assert all(m["learner_impl"] == 0.0 and m["rollout_impl"] == 1.0
               and all(math.isfinite(v) for v in m.values()) for m in steps)
    assert steps[1]["loss"] > 0.0  # 16 env-steps: the plain learner ran
    print(f"naf at its default learner: 2 train steps in {default_s:.2f} s "
          f"(host clock, incl. init); last step loss {steps[1]['loss']:.6g}, "
          f"env_steps_per_sec {steps[1]['env_steps_per_sec']}; launches "
          f"{default_launches}", flush=True)
    return launches


def phase_naf_step_split(dev):
    """Where a NAF kernel-learner train step goes, as phase 7: the B7
    phase beside the plain learner's 8 updates, and a whole train step at
    NAF's default (plain) learner."""
    from cartpoleplusplus_tpu_torch import train
    from cartpoleplusplus_tpu_torch.agents.common import lr_schedule
    from cartpoleplusplus_tpu_torch.config import RunConfig, from_args
    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk
    from cartpoleplusplus_tpu_torch.ops.naf_rollout import naf_policy_rollout

    ap = train.build_parser()
    args = ap.parse_args(["--agent", "naf", "--naf.learner", "kernel"])
    _, agent = train.build(from_args(RunConfig, args), args,
                           {"agent", "naf.learner"})
    c = agent.cfg
    assert agent.kernel_mode, "--naf.learner kernel did not resolve to B7"
    st = agent.init(0)
    for _ in range(3):  # 24 env-steps: past the 16-step warmup
        st, _ = agent.train_step(st)
    sigma = agent._sigma(st.env_steps)
    traj = naf_policy_rollout(agent.env, st.net, st.env_state, st.obs,
                              st.env_steps, sigma, c.rollout_steps)[2]
    batches = tuple(x.contiguous() for x in agent.replay.presample_columns(
        st.replay, c.batch_size, c.updates_per_step, generator=st.generator))

    def plain_updates():
        s = st
        for k in range(c.updates_per_step):
            s, _ = agent._update_once(s, tuple(x[k] for x in batches))

    def b7_phase():
        lk.naf_update_phase(st.groups, batches, st.opt.count, c.hidden,
                            lr=c.lr, gamma=c.gamma, tau=c.tau,
                            max_grad_norm=c.max_grad_norm,
                            lr_schedule=lr_schedule(c))

    args = ap.parse_args(["--agent", "naf"])
    _, plain = train.build(from_args(RunConfig, args), args, {"agent"})
    assert not plain.kernel_mode, "the NAF default learner is not plain"
    st_plain = plain.init(0)
    for _ in range(3):
        st_plain, _ = plain.train_step(st_plain)

    parts = {
        "whole train step": (lambda: agent.train_step(st), 5),
        "B6 rollout": (lambda: naf_policy_rollout(
            agent.env, st.net, st.env_state, st.obs, st.env_steps, sigma,
            c.rollout_steps), 20),
        "replay insert": (lambda: agent.replay.add_trajectory(st.replay,
                                                              *traj), 20),
        "column presample": (lambda: agent.replay.presample_columns(
            st.replay, c.batch_size, c.updates_per_step,
            generator=st.generator), 20),
        f"B7 learner phase (K = {c.updates_per_step})": (b7_phase, 20),
        f"plain learner, {c.updates_per_step} updates (not in the step)": (
            plain_updates, 3),
        "whole train step at the default plain learner (not in the step)": (
            lambda: plain.train_step(st_plain), 3),
    }
    _print_split("naf train-step split", parts, lambda: agent.train_step(st))


# --- the pixel DDPG slice: B10, B11 and the pixel main path -----------------

PIX_ENVS, PIX_SIZE = 2048, 48   # the pixels preset's envs and frame edge
B10_ATOL = 1e-5   # tests/test_pixels.py's kernel-vs-XLA bar
B11_ATOL = 1e-6   # tests/test_pixels.py's culled-vs-full bar
# Float operations of csrc/render.cu, counted as _env_step_flop counts the
# env math: `shade` per pixel and camera (127, plus 2 per channel), and
# B11's `row_band` per env and camera (89, once per block).
RENDER_FLOP, RENDER_CH_FLOP, BAND_FLOP = 127, 2, 89
# The pixels preset's env and agent fields (the reference's `--preset
# pixels` for DDPG, whose other fields are the DDPG defaults).
PIXEL_ARGV = ["--obs-mode", "pixels", "--num-envs", str(PIX_ENVS),
              "--render-size", str(PIX_SIZE), "--render-grayscale",
              "--render-obs-uint8", "--render-frame-diff",
              "--render-frame-diff-gain", "4", "--ddpg.sample", "block",
              "--ddpg.replay-capacity-per-env", "64",
              "--ddpg.actor-lr", "3e-4", "--ddpg.critic-lr", "3e-4",
              "--ddpg.ou-sigma-decay-env-steps", "20000",
              "--ddpg.lr-decay-env-steps", "100000"]


def _pixel_poses(dev):
    """Two pose sets of PIX_ENVS x 3 virtual envs (the 3 repeat snapshots
    of an env-step): adversarial poses (positions uniform in +-2.2, tilts up
    to |s| = 0.995, tests/test_pixels.py's), and the states of 3
    consecutive env-steps of a short plain rollout under random actions."""
    import torch

    from cartpoleplusplus_tpu_torch import CartPole3D, continuous_params
    from cartpoleplusplus_tpu_torch.physics import rest_state

    p = continuous_params()
    n = PIX_ENVS * p.action_repeats
    g = torch.Generator().manual_seed(31)
    pos = torch.stack([torch.rand(n, generator=g) * 4.4 - 2.2,
                       torch.rand(n, generator=g) * 4.4 - 2.2,
                       torch.full((n,), 0.0978)], -1)
    s = torch.rand((n, 2), generator=g) * 1.98 - 0.99
    nrm = s.norm(dim=-1, keepdim=True)
    s = torch.where(nrm > 0.995, s * 0.995 / nrm, s)
    adv = rest_state(p, (n,), device=dev)._replace(pos=pos.to(dev),
                                                   s=s.to(dev))
    env = CartPole3D(p, num_envs=PIX_ENVS, device=dev)
    state, _ = env.reset(5)
    snaps = []
    for t in range(6):
        a = (torch.rand((PIX_ENVS, 2), generator=g) * 2 - 1).to(dev)
        state, *_ = env.step(state, a)
        if t >= 3:
            snaps.append(state.phys)
    rollout = type(adv)(*(torch.cat(xs) for xs in zip(*snaps)))
    return p, {"adversarial": adv, "rollout": rollout}


def _render_bound(cfg, n, shaded=1.0):
    """Bound of one render of n virtual envs: the shade of a `shaded` share
    of the pixels (B11 adds its bands), the env columns, camera rows and
    tables read once, the frames written once."""
    npx, ncam = cfg.width * cfg.height, len(cfg.cameras)
    nch = cfg.channels_per_camera
    flop = (RENDER_FLOP + RENDER_CH_FLOP * nch) * n * npx * ncam * shaded
    if shaded < 1.0:
        flop += BAND_FLOP * n * ncam
    nrows = 6 + 1 + nch + 6
    nbytes = 4 * (6 * n + ncam * nrows * npx + 10 * ncam
                  + n * npx * ncam * nch)
    return _bound(flop, nbytes)


def _b10_compare(p, cfg, phys):
    """B10 against its twin on `phys`: the max abs error, and the count of
    pixels beyond B10_ATOL, which must be none."""
    import torch

    from cartpoleplusplus_tpu_torch.env import pixels as px
    from cartpoleplusplus_tpu_torch.ops import render_kernel as rk

    got = rk.render_frames(p, cfg, phys)
    want = px.render_all_cameras(p, phys, cfg)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = (got - want).abs()
    n_bad = int((err > B10_ATOL).sum())
    assert n_bad == 0, \
        f"B10: {n_bad} pixels beyond {B10_ATOL}, max {float(err.max()):.3g}"
    return float(err.max()), n_bad


def phase_b10(dev):
    """B10 against its twin at the pixels preset's shape (2048 envs x 3
    snapshots, 48 x 48, 2 cameras), grayscale and RGB, on adversarial and
    rollout poses; its ms per env-step beside the twin's and its bound."""
    from cartpoleplusplus_tpu_torch.env import pixels as px
    from cartpoleplusplus_tpu_torch.ops import render_kernel as rk

    p, poses = _pixel_poses(dev)
    out = {}
    for gray in (True, False):
        cfg = px.RenderConfig(width=PIX_SIZE, height=PIX_SIZE,
                              grayscale=gray)
        errs = {}
        for name, phys in poses.items():
            errs[name] = _b10_compare(p, cfg, phys)
        phys = poses["rollout"]
        n = phys.pos.shape[0]
        ms = _time_ms(lambda: rk.render_frames(p, cfg, phys), 20)
        plain_ms = _time_ms(lambda: px.render_all_cameras(p, phys, cfg), 3)
        bound = _render_bound(cfg, n)
        tag = "gray" if gray else "rgb"
        print(f"B10 {tag}: " + "; ".join(
            f"{k} poses max_abs_err {e[0]:.3g}, {e[1]} pixels beyond "
            f"{B10_ATOL}"
            for k, e in errs.items())
            + f"; {n} virtual envs x {PIX_SIZE}x{PIX_SIZE} x 2 cameras per "
            f"env-step: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), kernel at "
            f"{bound['bound_ms'] / ms:.3f} of its bound", flush=True)
        out[tag] = dict(max_abs_err=max(e[0] for e in errs.values()),
                        beyond=sum(e[1] for e in errs.values()), ms=ms,
                        plain_ms=plain_ms, **bound)
    return p, poses, out


def phase_b11(dev, p, poses):
    """B11 against B10 on phase 20's poses (atol 1e-6), both timed in
    turns, and the share of pixels the bands cull."""
    import torch

    from cartpoleplusplus_tpu_torch.env import pixels as px
    from cartpoleplusplus_tpu_torch.ops import render_kernel as rk

    out = {}
    for gray in (True, False):
        cfg = px.RenderConfig(width=PIX_SIZE, height=PIX_SIZE,
                              grayscale=gray)
        errs, culled = {}, {}
        for name, phys in poses.items():
            full = rk.render_frames(p, cfg, phys)
            cut = rk.render_culled(p, cfg, phys)
            errs[name] = _close(f"B11 {name}", cut, full, 0.0, B11_ATOL)
            cols = px.env_columns(p, phys)
            rows = (torch.arange(cfg.width * cfg.height, device=dev)
                    // cfg.width).to(torch.float32)[None, :]
            shares = []
            for cam in cfg.cameras:
                lo, hi = px.row_band(p, cfg, px.camera_basis_np(
                    cam, cfg.width, cfg.height), *cols)
                shares.append(float(((rows < lo) | (rows > hi)).float()
                                    .mean()))
            culled[name] = sum(shares) / len(shares)
        phys = poses["rollout"]
        n = phys.pos.shape[0]
        t10, t11 = [], []
        for _ in range(3):
            t10.append(_time_ms(lambda: rk.render_frames(p, cfg, phys), 20))
            t11.append(_time_ms(lambda: rk.render_culled(p, cfg, phys), 20))
        ms10, ms11 = statistics.median(t10), statistics.median(t11)
        plain_ms = _time_ms(lambda: px.render_all_cameras(p, phys, cfg,
                                                          cull=True), 3)
        bound = _render_bound(cfg, n, shaded=1.0 - culled["rollout"])
        tag = "gray" if gray else "rgb"
        print(f"B11 {tag}: max_abs_err against B10 " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items()) + f" (atol {B11_ATOL}); "
            f"pixels culled " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in culled.items())
            + f"; in turns per env-step: B10 {ms10:.4f} ms "
            f"({' '.join(f'{x:.4f}' for x in t10)}), B11 {ms11:.4f} ms "
            f"({' '.join(f'{x:.4f}' for x in t11)}); culled twin "
            f"{plain_ms:.3f} ms; B11 bound {bound['bound_ms']:.4f} ms",
            flush=True)
        out[tag] = dict(max_abs_err=max(errs.values()), ms=ms11,
                        plain_ms=plain_ms, b10_ms=ms10,
                        culled=culled["rollout"], **bound)
    return out


def _train_lines(argv, env=None):
    """train.main(argv) with its stdout and stderr captured, under the
    extra environment variables `env`: (rc, JSON lines, stderr, seconds)."""
    import os

    from cartpoleplusplus_tpu_torch import train

    out, err = io.StringIO(), io.StringIO()
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = train.main(argv)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    secs = time.perf_counter() - t0
    sys.stderr.write(err.getvalue())
    return rc, [json.loads(x) for x in out.getvalue().splitlines()], \
        err.getvalue(), secs


def phase_pixel_main_path():
    """The pixel DDPG slice through train.main at the pixels preset's env
    and agent fields: every env-step's frames through B10, the plain
    rollout and the plain learner, nothing else; then 2 train steps under
    CARTPOLE_RENDER_CULL=1 (B11 in B10's place); then `--obs-mode state`
    at the DDPG defaults, which B2 does not cover: the plain rollout on the
    card with one stderr line, B3 for the update."""
    total_env_steps, rollout, eval_steps = 64, 8, 200
    n_train = total_env_steps // rollout
    # One B10 launch per env.step (all 3 repeat snapshots x 2 cameras), one
    # per env.reset (the initial frames) and one for the reset frame that
    # the env renders once and caches: init, training, eval.
    b10_want = 1 + total_env_steps + 1 + 1 + eval_steps
    _zero_counts()
    rc, lines, _, secs = _train_lines(
        PIXEL_ARGV + ["--total-env-steps", str(total_env_steps),
                      "--log-interval", "1", "--final-eval", "--eval-steps",
                      str(eval_steps), "--seed", "0"])
    launches = _read_counts()
    assert rc == 0, f"pixel train.main returned {rc}"
    steps, ev = lines[:-1], lines[-1]
    assert [m["train_step"] for m in steps] == list(range(1, n_train + 1))
    assert _only(launches, B10=b10_want), \
        f"launches {launches}, want B10 {b10_want} and nothing else"
    for m in lines:
        assert all(math.isfinite(v) for v in m.values()), m
    assert all(m["rollout_impl"] == 0.0 and m["learner_impl"] == 0.0
               for m in steps)
    learned = [m for m in steps if m["env_steps"] >= 16]
    assert len(learned) == n_train - 1 and all(
        m["critic_loss"] > 0.0 for m in learned)
    assert 0 < ev["eval_mean_episode_length"] <= eval_steps
    for m in steps:
        print(f"pixel train step {m['train_step']}: critic_loss "
              f"{m['critic_loss']:.6g} actor_loss {m['actor_loss']:.6g} "
              f"reward_mean {m['reward_mean']:.6g} done_frac "
              f"{m['done_frac']:.6g} env_steps_per_sec "
              f"{m['env_steps_per_sec']}", flush=True)
    sec_per_step = PIX_ENVS * rollout / steps[-1]["env_steps_per_sec"]
    print(f"pixel main path: {n_train} train steps ({sec_per_step:.4f} s per "
          f"train step over the run, train.main total {secs:.2f} s incl. "
          f"init and eval); eval {json.dumps(ev)}; launches {launches}",
          flush=True)

    _zero_counts()
    rc, lines, _, secs = _train_lines(
        PIXEL_ARGV + ["--total-env-steps", "16", "--log-interval", "1",
                      "--seed", "0"], env={"CARTPOLE_RENDER_CULL": "1"})
    cull_launches = _read_counts()
    assert rc == 0, f"culled pixel train.main returned {rc}"
    assert _only(cull_launches, B11=1 + 1 + 16), cull_launches
    assert all(math.isfinite(v) for m in lines for v in m.values())
    print(f"pixel path under CARTPOLE_RENDER_CULL=1: 2 train steps in "
          f"{secs:.2f} s (host clock, incl. init); launches {cull_launches}",
          flush=True)

    _zero_counts()
    rc, lines, err, secs = _train_lines(
        ["--obs-mode", "state", "--total-env-steps", "16",
         "--log-interval", "1", "--seed", "0"])
    state_launches = _read_counts()
    assert rc == 0, f"train.main --obs-mode state returned {rc}"
    told = [ln for ln in err.splitlines() if "kernel B2 does not cover" in ln]
    assert len(told) == 1, err
    assert _only(state_launches, B3=1), state_launches
    assert all(m["rollout_impl"] == 0.0 and m["learner_impl"] == 1.0
               and all(math.isfinite(v) for v in m.values()) for m in lines)
    print(f"--obs-mode state (B2 does not cover it): 2 train steps in "
          f"{secs:.2f} s (host clock, incl. init), stderr {told[0]!r}; "
          f"launches {state_launches}", flush=True)
    return launches, cull_launches


def phase_pixel_step_split(dev):
    """Where a pixel train step's time goes, as phase 7: the plain rollout
    (and within it B10, the actor and the uint8 frame-diff epilogue, 8
    env-steps' worth each), the late insert, the block presample and the
    plain learner's 16 conv updates."""
    import argparse

    import torch

    from cartpoleplusplus_tpu_torch import train
    from cartpoleplusplus_tpu_torch.config import RunConfig, from_args
    from cartpoleplusplus_tpu_torch.ops import render_kernel as rk
    from cartpoleplusplus_tpu_torch.ops.policy_rollout import (
        reference_policy_rollout)

    ap = train.build_parser()
    args: argparse.Namespace = ap.parse_args(PIXEL_ARGV)
    _, agent = train.build(from_args(RunConfig, args), args, set())
    c, env = agent.cfg, agent.env
    st = agent.init(0)
    for _ in range(3):  # 24 env-steps: past the 16-step warmup
        st, _ = agent.train_step(st)
    sigma = agent._sigma(st.env_steps)

    def rollout():
        return reference_policy_rollout(env, st.actor, c.ou_theta,
                                        st.env_state, st.obs, st.noise,
                                        st.env_steps, sigma, c.rollout_steps)

    traj = rollout()[3]
    phys = st.env_state.phys
    snaps = type(phys)(*(torch.cat([x] * env.params.action_repeats)
                         for x in phys))
    frames = list(rk.render_frames(env.params, env.render_config, snaps)
                  .split(env.num_envs))
    done = torch.zeros(env.num_envs, dtype=torch.bool, device=dev)

    def epilogue():
        obs = env._pixel_obs(frames)
        reset = env._reset_obs_pixels()
        return torch.where(done[:, None, None, None], reset, obs)

    def presample():
        return agent.replay.presample_block(
            st.replay, c.batch_size, c.updates_per_step,
            generator=st.generator)

    def plain_learner():
        batches = presample()
        s = st
        for k in range(c.updates_per_step):
            s, _ = agent._update_once(s, tuple(x[k] for x in batches))

    t = c.rollout_steps

    @torch.no_grad()
    def actor():
        return [st.actor(st.obs) for _ in range(t)]

    parts = {
        "whole train step": (lambda: agent.train_step(st), 3),
        f"plain rollout ({t} env-steps)": (rollout, 3),
        f"of which B10 render ({t} env-steps)": (
            lambda: [rk.render_frames(env.params, env.render_config, snaps)
                     for _ in range(t)], 5),
        f"of which actor forward ({t} env-steps)": (actor, 5),
        f"of which uint8 frame-diff epilogue ({t} env-steps)": (
            lambda: [epilogue() for _ in range(t)], 5),
        "late replay insert": (lambda: agent.replay.add_trajectory(
            st.replay, *traj), 10),
        "block presample": (presample, 10),
        f"plain learner, {c.updates_per_step} conv updates": (
            plain_learner, 3),
    }
    _print_split("pixel train-step split", parts, lambda: agent.train_step(st))


# The presets' run: each preset through train.main with its run flags
# (phase 24). `--total-env-steps` is cut to a few dispatch windows; the
# preset's end-of-budget canary is disarmed (`--canary-env-steps 0`) in
# the runs whose checks count train steps, launches and saves, since an
# untrained policy fails it, and is forced in the LRPG run instead.
FAST_WINDOWS = 2                 # dispatch windows of a preset run
# Each preset's rollout length t and dispatch window spd (train.py's
# _PRESETS and the agents' defaults), and what phase 24 sets beside them.
FAST_DDPG = dict(t=64, k=8, batch=8192, spd=32, interval=16, log_envs=64)
FAST_LRPG = dict(envs=2048, t=32, spd=16)
FAST_NAF = dict(t=8, spd=16)
PIXELS = dict(t=8, spd=16)
EVAL_ENVS = 256                  # --eval-only's env count
CANARY_RESTARTS = 2
CANARY_MEM_BAR = 1.05            # canary attempts' memory, last / first
B9_FAST_N = FAST_LRPG["envs"] * FAST_LRPG["t"]   # 65,536 window rows


def _expected_saves(runs, interval, keep=3):
    """The steps on disk after train.py's windowed save cadence over
    `runs` ([(n_calls, steps_per_dispatch)], each resuming at the latest
    step + 1), under the reference's save policy (a save when past the
    latest step and a multiple of the interval or the directory's first;
    a forced save at each such window's end and at the final call; the
    last `keep` saves kept), written out here apart from
    ckpt/checkpoint.py."""
    saved, start = [], 0
    for n_calls, spd in runs:
        i = start
        while i < n_calls:
            k = min(spd, n_calls - i)
            i += k
            if any((not saved or j > saved[-1])
                   and (j % interval == 0 or not saved)
                   for j in range(i - k, i)):
                saved.append(i - 1)
        if not saved or saved[-1] != n_calls - 1:
            saved.append(n_calls - 1)
        saved = saved[-keep:]
        start = saved[-1] + 1
    return sorted(saved)


@functools.lru_cache(maxsize=1)
def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _dir_bytes(path) -> int:
    import os

    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def _preset_run(argv, tag, want=None):
    """train.main(argv) with the counters zeroed: (JSON lines, stderr,
    launches, seconds). `want` are the launches that must be counted
    (every other kernel never)."""
    _zero_counts()
    rc, lines, err, secs = _train_lines(argv)
    launches = _read_counts()
    assert rc == 0, f"{tag}: train.main returned {rc}:\n{err}"
    for m in lines:
        assert all(math.isfinite(v) for v in m.values()
                   if not isinstance(v, bool)), (tag, m)
    if want is not None:
        assert _only(launches, **want), f"{tag}: launches {launches}, " \
                                        f"want {want}"
    return lines, err, launches, secs


def phase_fast_ddpg(tmp):
    """`--preset fast --agent ddpg` (4096 envs, rollout 64, K 8, batch
    8192, dispatch 32) with checkpoints every 16 train steps, the event
    log of 64 envs, the final eval and the profiler: B2 and B3 on every
    train step, the reference policy's saved steps, a valid log of
    exactly 64 env ids, a trace; then a resume with a larger budget, and
    `--eval-only` at 256 envs on both learner layouts, equal."""
    import os

    from cartpoleplusplus_tpu_torch.eventlog import (EventLogWriter,
                                                     read_records, validate)

    c = FAST_DDPG
    ck, log, prof = (os.path.join(tmp, n) for n in ("ddpg_ck", "ddpg.cpe",
                                                   "ddpg_prof"))
    n_calls = FAST_WINDOWS * c["spd"]
    base = ["--preset", "fast", "--agent", "ddpg", "--seed", "0",
            "--canary-env-steps", "0", "--ckpt-dir", ck,
            "--ckpt-interval", str(c["interval"]), "--event-log", log,
            "--event-log-envs", str(c["log_envs"])]
    lines, _, launches, secs = _preset_run(
        base + ["--total-env-steps", str(n_calls * c["t"]), "--final-eval",
                "--profile-dir", prof], "fast ddpg",
        dict(B2=n_calls, B3=n_calls))
    steps, ev = lines[:-1], lines[-1]
    assert [m["train_step"] for m in steps] == [
        c["spd"] * (w + 1) for w in range(FAST_WINDOWS)]
    assert all(m["rollout_impl"] == 1.0 and m["learner_impl"] == 1.0
               for m in steps)
    assert ev["eval_episodes"] > 0
    on_disk = sorted(int(n) for n in os.listdir(ck) if n.isdigit())
    want = _expected_saves([(n_calls, c["spd"])], c["interval"])
    assert on_disk == want, (on_disk, want)
    n_records = validate(log)
    envs = {r["env_id"] for k, r in read_records(log) if k == "chunk"}
    assert envs == set(range(c["log_envs"])), sorted(envs)
    with EventLogWriter(os.path.join(tmp, "probe.cpe")) as w:
        backend = w.backend
    trace = os.path.join(prof, "trace.json")
    assert os.path.getsize(trace) > 0
    rate = steps[-1]["env_steps_per_sec"]
    print(f"fast ddpg: {n_calls} train steps ({FAST_WINDOWS} windows of "
          f"{c['spd']}) in {secs:.2f} s incl. init, saves and eval, "
          f"{rate} env-steps/s over the run; launches {launches}; saved "
          f"steps {on_disk} (the policy's {want}); event log {n_records} "
          f"records, env ids 0-{c['log_envs'] - 1}, backend {backend}, "
          f"{os.path.getsize(log)} bytes; trace {os.path.getsize(trace)} "
          f"bytes; eval {json.dumps(ev)} [{_card()}]", flush=True)

    more = n_calls + c["spd"]
    lines, err, launches, secs = _preset_run(
        base + ["--total-env-steps", str(more * c["t"])], "fast ddpg resume",
        dict(B2=c["spd"], B3=c["spd"]))
    assert f"resumed from step {n_calls - 1}" in err, err
    assert lines[-1]["train_step"] == more
    on_disk = sorted(int(n) for n in os.listdir(ck) if n.isdigit())
    want = _expected_saves([(n_calls, c["spd"]), (more, c["spd"])],
                           c["interval"])
    assert on_disk == want and on_disk[-1] == more - 1, (on_disk, want)
    assert validate(log) > n_records
    assert {r["env_id"] for k, r in read_records(log)
            if k == "chunk"} == set(range(c["log_envs"]))
    print(f"fast ddpg resume: 'resumed from step {n_calls - 1}', ended at "
          f"train step {more}; saved steps {on_disk}; the log appended "
          f"({validate(log)} records) [{_card()}]", flush=True)

    evals = []
    for learner in ("kernel", "xla"):
        lines, _, _, _ = _preset_run(
            ["--preset", "fast", "--agent", "ddpg", "--ckpt-dir", ck,
             "--eval-only", "--num-envs", str(EVAL_ENVS), "--ddpg.learner",
             learner], f"eval-only {learner}")
        assert len(lines) == 1
        evals.append(lines[0])
    assert evals[0] == evals[1], evals
    print(f"fast ddpg --eval-only at {EVAL_ENVS} envs, kernel and xla "
          f"learner layouts: equal lines {json.dumps(evals[0])} "
          f"[{_card()}]", flush=True)


def phase_canary(tmp):
    """`--preset fast --agent lrpg` (2048 envs, B8 + B9, dispatch 16) with
    the canary forced to fail at the end of the budget: three attempts,
    each `healthy: false`, then a finished run; the card memory the run
    holds at the last attempt's canary eval within CANARY_MEM_BAR of the
    first's (the collapsed state is freed before the fresh one)."""
    import torch

    from cartpoleplusplus_tpu_torch import train

    c = FAST_LRPG
    n_calls = FAST_WINDOWS * c["spd"]
    budget = n_calls * c["t"]
    mem = []
    orig_build = train.build
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()   # what the run did not allocate

    def build(*a, **k):
        env, agent = orig_build(*a, **k)
        evaluate = agent.evaluate

        def recorded(*x, **y):
            torch.cuda.synchronize()
            mem.append(torch.cuda.memory_allocated() - base)
            return evaluate(*x, **y)

        agent.evaluate = recorded
        return env, agent

    train.build = build
    try:
        lines, _, launches, secs = _preset_run(
            ["--preset", "fast", "--agent", "lrpg", "--seed", "0",
             "--total-env-steps", str(budget), "--canary-env-steps",
             str(budget), "--canary-min-eval", "1e9",
             "--canary-max-restarts", str(CANARY_RESTARTS)], "canary",
            dict(B8=(CANARY_RESTARTS + 1) * n_calls,
                 B9=(CANARY_RESTARTS + 1) * n_calls))
    finally:
        train.build = orig_build
    canary = [m for m in lines if "canary_eval_mean" in m]
    assert [m["attempt"] for m in canary] == list(range(CANARY_RESTARTS + 1))
    assert not any(m["healthy"] for m in canary)
    assert all(m["canary_at_step"] == n_calls for m in canary)
    assert lines[-1]["train_step"] == n_calls
    assert all(m["learner_impl"] == 1.0 and m["rollout_impl"] == 1.0
               for m in lines if "train_step" in m)
    assert len(mem) == CANARY_RESTARTS + 1
    assert mem[-1] <= CANARY_MEM_BAR * mem[0], mem
    print(f"fast lrpg, canary forced: {len(canary)} attempts "
          f"{[m['canary_eval_mean'] for m in canary]}, healthy none, then "
          f"train step {lines[-1]['train_step']}, {secs:.2f} s; memory "
          f"allocated by the run at each canary eval {mem} bytes (over "
          f"{base} allocated before it; last/first "
          f"{mem[-1] / max(mem[0], 1):.4f}, bar {CANARY_MEM_BAR}); launches "
          f"{launches} [{_card()}]", flush=True)


def phase_fast_naf():
    """`--preset fast --agent naf` (1024 envs, B6 + B7, dispatch 16) for a
    few windows: B6 every train step, B7 every learning one."""
    c = FAST_NAF
    n_calls = FAST_WINDOWS * c["spd"]
    lines, _, launches, secs = _preset_run(
        ["--preset", "fast", "--agent", "naf", "--seed", "0",
         "--canary-env-steps", "0", "--total-env-steps",
         str(n_calls * c["t"])], "fast naf",
        dict(B6=n_calls, B7=n_calls - 1))   # the 16-step warmup: 1 call
    assert [m["train_step"] for m in lines] == [
        c["spd"] * (w + 1) for w in range(FAST_WINDOWS)]
    assert all(m["rollout_impl"] == 1.0 and m["learner_impl"] == 1.0
               for m in lines)
    print(f"fast naf: {n_calls} train steps in {secs:.2f} s incl. init, "
          f"{lines[-1]['env_steps_per_sec']} env-steps/s over the run; "
          f"launches {launches} [{_card()}]", flush=True)


def phase_pixels_preset(tmp):
    """`--preset pixels --agent ddpg` for a few windows with its
    weights-only saves: B10 every env-step, the checkpoints without any
    replay or env field."""
    import os

    from cartpoleplusplus_tpu_torch.ckpt import CheckpointManager

    c = PIXELS
    ck = os.path.join(tmp, "pixels_ck")
    n_calls = FAST_WINDOWS * c["spd"]
    lines, _, launches, secs = _preset_run(
        ["--preset", "pixels", "--agent", "ddpg", "--seed", "0",
         "--canary-env-steps", "0", "--total-env-steps",
         str(n_calls * c["t"]), "--ckpt-dir", ck], "pixels preset",
        dict(B10=1 + 1 + n_calls * c["t"]))  # reset, cached frame, steps
    assert lines[-1]["train_step"] == n_calls
    keys = CheckpointManager(ck).saved_keys()
    assert not {"replay", "env_state", "obs", "noise"} & set(keys), keys
    assert {"actor", "critic", "actor_opt", "rng", "env_steps"} <= set(keys)
    on_disk = sorted(int(n) for n in os.listdir(ck) if n.isdigit())
    print(f"pixels preset: {n_calls} train steps in {secs:.2f} s incl. "
          f"init, {lines[-1]['env_steps_per_sec']} env-steps/s; saved steps "
          f"{on_disk}, checkpoint directory {_dir_bytes(ck)} bytes, keys "
          f"{keys}; launches {launches} [{_card()}]", flush=True)


def phase_preset_costs(tmp):
    """The costs beside the train step at each preset: the `fast` ddpg
    train step (CUDA events) and its env-steps/s, the checkpoint save
    (host clock: the copy to the host and the write) at each preset, and
    the event-log sink's ms per `fast` ddpg train step (the 64 logged
    envs sliced on the card, copied and written)."""
    import argparse
    import dataclasses
    import os
    import shutil

    import torch

    from cartpoleplusplus_tpu_torch import train
    from cartpoleplusplus_tpu_torch.ckpt import save_checkpoint
    from cartpoleplusplus_tpu_torch.config import (RunConfig, explicit_dests,
                                                   from_args)
    from cartpoleplusplus_tpu_torch.eventlog import (EpisodeSink,
                                                     EventLogWriter)

    out = {}
    for preset, agent in (("fast", "ddpg"), ("fast", "lrpg"),
                          ("fast", "naf"), ("pixels", "ddpg")):
        argv = ["--preset", preset, "--agent", agent]
        ap = train.build_parser()
        args: argparse.Namespace = ap.parse_args(argv)
        provided = explicit_dests(train.build_parser(), argv)
        run = from_args(RunConfig, args)
        run = dataclasses.replace(run, **{
            k: v for k, v in train._PRESETS[preset][agent]["run"].items()
            if k not in provided})
        _, ag = train.build(run, args, provided)
        st = ag.init(0)
        st, _ = ag.train_step(st)
        tag = f"{preset} {agent}"
        line = [tag]
        if (preset, agent) == ("fast", "ddpg"):
            def step():
                nonlocal st
                st, _ = ag.train_step(st)
            ms = _time_ms(step, 5)
            rate = run.num_envs * ag.cfg.rollout_steps / ms * 1e3
            out["fast_ddpg_step_ms"] = ms
            line.append(f"train step {ms:.4f} ms ({rate:.4g} env-steps/s, "
                        f"CUDA events, 5 steps)")
            n = FAST_DDPG["log_envs"]
            with EventLogWriter(os.path.join(tmp, "cost.cpe")) as w:
                sink = EpisodeSink(w, n)
                sink_ms = []
                for _ in range(3):
                    st, m = ag.train_step(st, capture=True)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    sink.add_rollout(*(x[:, :n].contiguous().cpu().numpy()
                                       for x in m["traj"]))
                    sink_ms.append((time.perf_counter() - t0) * 1e3)
                backend = w.backend
            out["sink_ms"] = statistics.median(sink_ms)
            line.append(f"event-log sink {out['sink_ms']:.4f} ms per train "
                        f"step ({n} envs x {ag.cfg.rollout_steps} steps, "
                        f"backend {backend}, median of "
                        f"{' '.join(f'{x:.4f}' for x in sink_ms)})")
        exclude = train.ckpt_exclude(st, run)
        path = os.path.join(tmp, f"cost_{preset}_{agent}")
        save_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_checkpoint(path, st, exclude)
            save_ms.append((time.perf_counter() - t0) * 1e3)
            size = _dir_bytes(path)
            shutil.rmtree(path)
        out[f"save_ms {tag}"] = statistics.median(save_ms)
        line.append(f"checkpoint save {statistics.median(save_ms):.2f} ms "
                    f"({'full' if run.ckpt_full else 'weights-only'}, "
                    f"{size} bytes; host clock, median of "
                    f"{' '.join(f'{x:.2f}' for x in save_ms)})")
        print("preset costs, " + "; ".join(line) + f" [{_card()}]", flush=True)
        del st, ag
        torch.cuda.empty_cache()
    return out


def phase_preset_kernels(dev):
    """The presets' new kernel shapes, each held against its twin: B3 at
    batch 8192, K 8 (the `fast` ddpg learner phase) from warmed moments,
    and B9 over a 65,536-row window (the `fast` lrpg update)."""
    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk

    hidden = (256, 256)
    b, k = FAST_DDPG["batch"], FAST_DDPG["k"]
    kw = dict(actor_lr=1e-4, critic_lr=1e-3, gamma=0.99, tau=0.01)
    errs, bitwise, groups, batches = _b3_compare(dev, hidden, k, batch=b,
                                                 **kw)
    assert bitwise, "B3 at batch 8192: two runs differ"
    ms = _time_ms(lambda: lk.ddpg_update_phase(groups, batches, B3_T0,
                                               hidden, **kw), 10)
    lay_a, lay_c = lk.actor_layout(42, hidden), lk.critic_layout(42, hidden)
    views = [lk.group_views(g, lay) for g, lay in zip(
        groups, (lay_a, lay_c, lay_a, lay_c, lay_a, lay_a, lay_c, lay_c))]
    plain_ms = _time_ms(lambda: lk.update_phase_math(
        *views, batches, B3_T0, hidden, **kw), 3)
    b3 = dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
              **_bound(k * _b3_update_flop(hidden, b),
                       2 * _nbytes(*groups) + _nbytes(*batches) + 8 * k))
    print(f"B3 at batch {b} x K {k}, hidden {hidden}: max_abs_err "
          f"{b3['max_abs_err']:.3g} over K {k} (rtol {B3_RTOL}, "
          f"atol {B3_ATOL}); two runs bitwise equal; kernel {ms:.4f} ms "
          f"per phase, plain {plain_ms:.2f} ms, bound "
          f"{b3['bound_ms']:.4f} ms by {b3['bound_by']} [{_card()}]",
          flush=True)
    del groups, batches, views

    hidden, kw = LRPG_HIDDEN, dict(lr=3e-4, entropy_coef=0.1)
    groups, window = _b9_inputs(dev, hidden, seed=29, n=B9_FAST_N)
    errs = _b9_compare(groups, window, hidden, kw, "")
    ms = _time_ms(lambda: lk.lrpg_update_phase(groups, window, B3_T0, hidden,
                                               **kw), 20)
    lay = lk.policy_layout(42, hidden)
    views = [lk.group_views(x, lay) for x in groups]
    plain_ms = _time_ms(lambda: lk.lrpg_update_phase_math(
        *views, window, B3_T0, hidden, **kw), 5)
    b9 = dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
              **_bound(_b9_flop(B9_FAST_N, hidden),
                       _nbytes(*window) + 2 * _nbytes(*groups) + 4))
    print(f"B9 over {B9_FAST_N} rows, hidden {hidden}: max_abs_err "
          f"{b9['max_abs_err']:.3g} (rtol {B3_RTOL}, atol {B3_ATOL}); two "
          f"runs bitwise equal; kernel {ms:.4f} ms, plain {plain_ms:.2f} "
          f"ms, bound {b9['bound_ms']:.4f} ms by {b9['bound_by']} [{_card()}]",
          flush=True)
    return b3, b9


def phase_presets(dev):
    """Phase 24: the presets' runs and costs, in a temporary directory
    (TMPDIR) removed afterwards."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="cartpole_presets_")
    try:
        phase_fast_ddpg(tmp)
        phase_canary(tmp)
        phase_fast_naf()
        phase_pixels_preset(tmp)
        phase_preset_costs(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return phase_preset_kernels(dev)


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
    smi = _card()
    print(f"device: {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    print(smi, flush=True)

    # The wrappers' own first-use path: nvcc runs when the library is
    # missing or older than csrc/ (always in a fresh checkout).
    stale = _native._stale()
    t0 = time.perf_counter()
    _native.load_library()
    build_s = time.perf_counter() - t0 if stale else 0.0
    print(f"build: {build_s:.2f} s (nvcc, sm_90a"
          f"{'' if stale else '; library current, not rebuilt'}); "
          f"ptxas: {_ptxas_report(_native.BUILD_LOG)}", flush=True)

    # A few seconds of matrix products first: timed from a cold card, B4
    # read 0.52 ms against 0.34-0.41 warm (PERF.md).
    warm = torch.randn((8192, 8192), device=dev)
    t_warm = time.perf_counter()
    while time.perf_counter() - t_warm < 5.0:
        warm @ warm
    torch.cuda.synchronize()
    del warm
    b1 = phase_b1(dev)
    floor_us = b1["discrete"]["ms"] / B1_STEPS * 1e3  # B1 per env-step
    b2 = phase_b2(dev, floor_us)
    b3 = phase_b3(dev)
    main_launches = phase_main_path()
    b1_launches = phase_physics_rollout(dev)
    phase_step_split(dev)
    b4 = phase_b4(dev, floor_us)
    b5 = phase_b5(dev)
    dqn_launches = phase_dqn_main_path()
    phase_dqn_step_split(dev)
    split = phase_stage_split(dev)
    for label, most in SPLIT_BARRIERS.items():
        assert split[label]["barriers_per_update"] <= most, (label,
                                                             split[label])
    b8 = phase_b8(dev, floor_us)
    b9 = phase_b9(dev)
    lrpg_launches = phase_lrpg_main_path()
    phase_lrpg_step_split(dev)
    b6 = phase_b6(dev, floor_us)
    b7 = phase_b7(dev)
    naf_launches = phase_naf_main_path()
    phase_naf_step_split(dev)
    p_pix, poses, b10 = phase_b10(dev)
    b11 = phase_b11(dev, p_pix, poses)
    del poses
    pixel_launches, cull_launches = phase_pixel_main_path()
    phase_pixel_step_split(dev)
    phase_presets(dev)

    b1_main = b1["discrete"]  # the benchmark's default params
    kernels = [
        dict(name="B1 fused_rollout", route="cuda", design="env-per-thread",
             source="cartpoleplusplus_tpu_torch/csrc/fused_rollout.cu",
             replaces="cartpoleplusplus_tpu/ops/fused_rollout.py:104",
             launches=b1_launches,
             launched_by="physics-only rollout (bench.py's path)",
             max_abs_err=max(v["max_abs_err"] for v in b1.values()),
             ms=b1_main["ms"], plain_ms=b1_main["plain_ms"],
             **_bound_keys(b1_main)),
        dict(name="B2 policy_rollout", route="cuda", design="q-tile",
             source="cartpoleplusplus_tpu_torch/csrc/policy_rollout.cu",
             replaces="cartpoleplusplus_tpu/ops/policy_rollout.py:114",
             launches=main_launches["B2"],
             launched_by="train.main (DDPG defaults)",
             max_abs_err=b2["max_abs_err"],
             ms=b2["ms"], plain_ms=b2["plain_ms"], **_bound_keys(b2)),
        dict(name="B3 ddpg_update_phase", route="cuda", design="row-chain",
             source="cartpoleplusplus_tpu_torch/csrc/ddpg_update.cu",
             replaces="cartpoleplusplus_tpu/ops/learner_kernel.py:564",
             launches=main_launches["B3"],
             launched_by="train.main (DDPG defaults)",
             max_abs_err=b3["max_abs_err"],
             ms=b3["ms"], plain_ms=b3["plain_ms"], **_bound_keys(b3)),
        dict(name="B4 q_policy_rollout", route="cuda", design="q-tile",
             source="cartpoleplusplus_tpu_torch/csrc/q_rollout.cu",
             replaces="cartpoleplusplus_tpu/ops/policy_rollout.py:486",
             launches=dqn_launches["B4"],
             launched_by="train.main --agent dqn (DQN defaults)",
             max_abs_err=b4["max_abs_err"],
             ms=b4["ms"], plain_ms=b4["plain_ms"], **_bound_keys(b4)),
        dict(name="B5 dqn_update_phase", route="cuda", design="row-chain",
             source="cartpoleplusplus_tpu_torch/csrc/dqn_update.cu",
             replaces="cartpoleplusplus_tpu/ops/learner_kernel.py:862",
             launches=dqn_launches["B5"],
             launched_by="train.main --agent dqn (DQN defaults)",
             max_abs_err=b5["max_abs_err"],
             ms=b5["ms"], plain_ms=b5["plain_ms"], **_bound_keys(b5)),
        dict(name="B6 naf_policy_rollout", route="cuda", design="q-tile",
             source="cartpoleplusplus_tpu_torch/csrc/policy_rollout.cu",
             replaces="cartpoleplusplus_tpu/ops/policy_rollout.py:486",
             launches=naf_launches["B6"],
             launched_by="train.main --agent naf --naf.learner kernel",
             max_abs_err=b6["max_abs_err"],
             ms=b6["ms"], plain_ms=b6["plain_ms"], **_bound_keys(b6)),
        dict(name="B7 naf_update_phase", route="cuda", design="row-chain",
             source="cartpoleplusplus_tpu_torch/csrc/naf_update.cu",
             replaces="cartpoleplusplus_tpu/ops/learner_kernel.py:1144",
             launches=naf_launches["B7"],
             launched_by="train.main --agent naf --naf.learner kernel",
             max_abs_err=b7["max_abs_err"],
             ms=b7["ms"], plain_ms=b7["plain_ms"], **_bound_keys(b7)),
        dict(name="B8 pg_policy_rollout", route="cuda", design="q-tile",
             source="cartpoleplusplus_tpu_torch/csrc/q_rollout.cu",
             replaces="cartpoleplusplus_tpu/ops/policy_rollout.py:486",
             launches=lrpg_launches["B8"],
             launched_by="train.main --agent lrpg",
             max_abs_err=b8["max_abs_err"],
             ms=b8["ms"], plain_ms=b8["plain_ms"], **_bound_keys(b8)),
        dict(name="B9 lrpg_update_phase", route="cuda", design="tiled",
             source="cartpoleplusplus_tpu_torch/csrc/lrpg_update.cu",
             replaces="cartpoleplusplus_tpu/ops/learner_kernel.py:1399",
             launches=lrpg_launches["B9"],
             launched_by="train.main --agent lrpg",
             max_abs_err=b9["max_abs_err"],
             ms=b9["ms"], plain_ms=b9["plain_ms"], **_bound_keys(b9)),
        dict(name="B10 render_frames", route="cuda", design="env-looped",
             source="cartpoleplusplus_tpu_torch/csrc/render.cu",
             replaces="cartpoleplusplus_tpu/ops/render_kernel.py:107",
             launches=pixel_launches["B10"],
             launched_by="train.main --obs-mode pixels (pixels preset "
                         "env and agent fields)",
             max_abs_err=max(v["max_abs_err"] for v in b10.values()),
             ms=b10["gray"]["ms"], plain_ms=b10["gray"]["plain_ms"],
             **_bound_keys(b10["gray"])),
        dict(name="B11 render_culled", route="cuda", design="env-looped",
             source="cartpoleplusplus_tpu_torch/csrc/render.cu",
             replaces="cartpoleplusplus_tpu/ops/render_kernel.py:125",
             launches=cull_launches["B11"],
             launched_by="train.main --obs-mode pixels under "
                         "CARTPOLE_RENDER_CULL=1",
             max_abs_err=max(v["max_abs_err"] for v in b11.values()),
             ms=b11["gray"]["ms"], plain_ms=b11["gray"]["plain_ms"],
             **_bound_keys(b11["gray"])),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
