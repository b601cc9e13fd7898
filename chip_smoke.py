#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (cartpoleplusplus_tpu_torch).

    python3 chip_smoke.py        # from the repository root, one CUDA GPU

Phases, one line of numbers each; any failure raises and exits non-zero:
  1. device: the card's name and `nvidia-smi` name and power limit;
  2. build: nvcc builds csrc/*.cu from the checkout on first use;
  3. B1 (physics-only rollout kernel) against its plain torch twin on the
     card, 4096 envs x 25 steps, discrete and continuous params; at the
     benchmark's 4096 x 4096, two launches bit for bit and its time (CUDA
     events); the B1 probe: the env math's exact fast forms against the
     IEEE forms over every float of their ranges, the dependent latency
     of each instruction kind on the substep's chains, and from them B1's
     latency floor (`python3 chip_smoke.py --b1-probe` runs it alone);
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
     benchmark times (4096 envs x 4096 steps), which must launch B1, its
     rate by the host clock (first call) and by CUDA events;
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
     their twins: B3 at batch 8192, K 8 from warmed moments (each launch
     in the wide row items, counted in `wide_launches`) and B9 over a
     65,536-row window. The canary is disarmed (`--canary-env-steps 0`)
     in the runs that count launches and saves: an untrained policy fails
     it;
  24b. the suite cells' other learners at their shape (`python3
     chip_smoke.py --suite-learners` runs it alone): B5 with double DQN on
     and off and B7 with its clip at 10, batch 8192 x K 8 on (256, 256)
     from warmed moments, against their twins at B3's bar, two runs bit
     for bit, every launch in the wide row items (`wide_launches`), and
     each timed;
  25. pixel DQN, NAF and LRPG main paths with the counters zeroed:
     `train.main --obs-mode pixels --agent dqn|naf|lrpg` at the pixels
     preset's env fields (2048 envs, 48 x 48 gray uint8 frame-diff, 2
     cameras) and each agent's default widths, DQN and NAF with block
     sampling and 64 replay slots per env, for 64 env-steps (LRPG 256)
     plus a 200-step greedy eval: B10 once per env.step and env.reset and
     once for the cached reset frame (267, LRPG 459), every other kernel
     never, one stderr line naming the rollout kernel pixels leave out,
     the plain learner; LRPG's peak card memory; then 2 train steps of
     pixel DQN under CARTPOLE_RENDER_CULL=1 (B11 18 times, B10 never);
  26. where a pixel DQN, NAF and LRPG train step's time goes, as phase 23
     (LRPG: the window's returns and the plain update's gradient; 2
     rounds), with env-steps/s and LRPG's peak card memory over one train
     step;
  27. block sampling on state obs at the CLI defaults, `--agent dqn
     --dqn.sample block` (B4 8, B5 7) and `--agent naf --naf.learner
     kernel --naf.sample block` (B6 8, B7 7), and `--ddpg.sample uniform`
     (B2 8, B3 7), nothing else; then B5 and B7 on a block presample and
     B3 on a uniform one, each drawn from a filled ring, from warmed
     moments, against their twins at phases 9, 17 and 4b's bars;
  28. `--render-dtype bfloat16` on the card: 2 pixel DDPG train steps
     launch B10 as often as at float32 (18), and their frames (the current
     ones and the ring after the late insert) equal float32's bit for bit:
     B10 renders in float32 whatever the dtype, as the reference's kernel
     does;
  29. distribution (cartpoleplusplus_tpu_torch/dist): two ranks spawned by
     the script share cuda:0 over gloo (first a probe that gloo takes
     all-reduce, of float32 and of uint8, and all-gather of CUDA tensors,
     and that `gather_to_root` brings both ranks' rows to rank 0 alone).
     The presample's time at the DDPG defaults (column, block and
     uniform: `python3 chip_smoke.py --presample-times` runs it alone,
     over whichever package the script's directory holds). DDPG at its defaults at 8192 global envs (4096 per
     rank, replay 1024 per env): the SPMD learner (B2 per rank, B3 on the
     assembled global batch) for 4 train steps bit-equal to one process at
     8192 envs on the same card (parameters, targets, Adam moments, env
     state, obs, noise and a per-env digest of the ring); the shardmap
     learner (B3 on the all-gathered union batch) with both ranks'
     parameters bit-identical and B2 / B3 counted per rank; DQN, NAF
     (kernel learner) and LRPG shardmap steps at 4096 global envs, ranks
     bit-identical, B4-B9 counted per rank; the per-rank step time, the
     collectives' ms per step and the 1-process step time at 8192 envs;
     then one rank over NCCL (all-reduce of float32 and uint8, all-gather
     and `gather_to_root` of CUDA tensors).
     Two ranks on one card measure correctness and the collectives' cost,
     not scaling. Then pixel DDPG under shardmap on the same 2 ranks (the
     pixels preset's agent fields and frames at 16 x 16, 2048 global envs,
     2 train steps): ranks bit-identical, B10 once per env.step and once
     for the cached reset frame on each rank, nothing else;
  30. bfloat16 (`python3 chip_smoke.py --bf16-only` runs it alone): DDPG,
     DQN, NAF and LRPG at their CLI defaults with `--<agent>.dtype
     bfloat16`, 3 train steps each with the counters zeroed: the rollout
     kernel (B2, B4, B6, B8) launches from the float32 weights every step
     and no learner kernel launches (the plain learner, as the reference's
     kernel_learner_ok refuses bfloat16), parameters and Adam moments
     float32, metrics finite; pixel DDPG at the pixels preset's fields for
     2 train steps (B10 only); each one's train step ms in turns beside
     float32's on the plain and the kernel learner; then each of the ten
     bfloat16 nets at (256, 256) (the pixel nets on the conv encoder over
     B10's 48 x 48 frames), weights perturbed off their init (biases and
     LayerNorm scales nonzero), on the card against the same net on the
     CPU at 4096 rows, end to end: the max error in bfloat16 ulps of the
     output's magnitude and the share of elements off the float32 bar,
     the state nets inside one ulp and 0.5 % (bf16_parity.TIGHT), the
     pixel nets inside 4 ulps and 40 % (bf16_parity.PIXEL_CARD: through the
     convolutions a product's rounding flips compound); and each net with
     the rounding-order fault planted on the card (bf16_parity.fused_bias)
     outside its bar;
  31. the tools: the gym adapter's episode on the card to termination and
     one render() through B10; params_from_urdf from a copy of the bodies
     with the pole 1.5 long through B1 at 4096 x 25 against its twin, its
     states apart from the defaults' run; checked_step clean over 8 steps
     at 4096 envs, then raising "non-finite pos in EnvState" on a
     NaN-corrupted state; measure_env_steps_per_sec at 4096 envs x 128
     steps of the plain env.step (no kernel); a 2-point sweep of a tiny
     DQN run (B4, B5) and the plot of its results (where matplotlib is
     installed; the card's machine has none, and the phase says so);
  32. learner_precision (`python3 chip_smoke.py --precision-only` runs it
     alone): first the product probe (csrc/mm_probe.cu: the learners'
     product helpers alone, 64 x 384 @ 384 x 64 on operands whose sums
     cancel) at every mode equal bit for bit to its own mode's exact chain
     and apart from every other mode's in more than a tenth of the
     elements, and the operands' split on the card equal to the CPU's;
     the tensor-core probe (B3's and B9's mma fragment helpers alone) at
     bfloat16, TF32, X3, X6 and F16 equal bit for bit to its plain version
     (lk.mma_chain) on operands whose block sums are exact, and within
     1e-5 of the terms' magnitudes of the twin's product on cancelling
     ones; then B3, B5, B7 and B9 at each
     product mode against their twins at the same mode, at the defaults
     (B3 batch 256 at "updated" and "pre", B5, B7 with the clip at 10 and
     off, B9 at 131,072 rows and at 1,000): the float32 spellings give the
     default's bits and BF16_BF16_F32 bfloat16's; at every other mode two
     runs give the same bits, and at most a set share of the elements lies
     past the learners' elementwise bar (rtol 2e-4, atol 1e-5), where the
     float32 kernel against the same twin has more past it (at X3, X6 and
     F64, within that bar of float32, the bits differ from float32's
     instead): shares per mode and case in ONE_UPDATE_SHARE, B3_K_SHARE,
     B3_FAST_SHARE and ROW_CHAIN_K_SHARE; besides, after one update each
     tensor normwise within that bar (max error <= 1e-5 + 2e-4 x its
     largest magnitude), after K the networks, targets and losses within
     the reference's bfloat16 bar (rtol 2e-2, atol 2e-3); after one update
     the kernel at float32, X3, X6 and F64 against the twins of all four
     (_mode_identity: X3's kernel nearest its own twin; against the nearer
     of the float32 and F64 twins, F64's kernel nearer than float32's and
     float32's than X6's); after one update B3's and B9's id from inside
     the kernel at each mode (the tensor cores' instance at bfloat16,
     TF32, X3, X6 and F16); each kernel timed at every mode in turns with
     float32, each mode beside its bound at the card's peak for its
     operand type, and B3 and B9 at each tensor-core mode in turns with
     the same sources built with CP_MM_FFMA (every mode on the fmaf
     chains: the instances before the tensor cores; built while phases
     3-31 run); then each agent's CLI defaults at
     `--<agent>.learner-precision bfloat16` with the counters zeroed (the
     learner kernel 7 times, 8 for LRPG, the rollout kernel 8, nothing
     else), and each agent at the other values (the legacy ones and the
     four presets' modes) for 3 train steps at 1000 envs. (`--learner-bits
     PATH` saves, or compares with PATH, the outputs of B5 and B7 at
     every mode and of B3 and B9 at float32 and F64, and their times, for
     an A/B against an unpacked parent; `--learner-times` times B3, B9
     at every mode and B5, B7 at float32 through the package beside the
     script, for the same A/B. `--plant-faults`, a one-off run
     after a change to the modes, builds each planted fault of
     PROBE_FAULTS, MMA_PROBE_FAULTS and LEARNER_FAULTS from a patched copy
     of csrc/ and shows phase 32's checks catch it.)
Then one JSON line of per-kernel numbers (each with its bound: the larger
of its float32 operations over 67 TFLOP/s and its bytes over 3.35 TB/s,
counted from this run's shapes; B3, B5, B7 and B9 also with each product
mode's ms, bound, chain bound and launches, B3 and B9 with the fmaf
instances' ms) and, last, the device line. A line "[phase: s]" after each
phase gives its host seconds. The script imports no JAX and nothing of
the JAX package.
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
PIXEL_SPLIT_ROUNDS = 2  # phase 26's (each pixel agent's step is long)
HARNESS_STEPS = 128     # phase 31's throughput harness, steps per env
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
    """A mangled entry function -> its name, with its bool and int
    template arguments (`<0>`, `<1, 2>`): the identifier ending in
    `_kernel` that its length prefix delimits (names in an anonymous
    namespace carry a file hash before it)."""
    import re

    end = mangled.find("_kernel") + len("_kernel")
    for n in range(len("_kernel") + 1, end + 1):
        if mangled[:end - n].endswith(str(n)):
            args = re.match(r"I((?:L[bi]\d+E)+)E", mangled[end:])
            vals = re.findall(r"L[bi](\d+)E", args.group(1)) if args else []
            return mangled[end - n:end] + (f"<{', '.join(vals)}>" if vals
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


def b1_times(dev) -> dict:
    """B1's ms by CUDA events (mean of several launches after a warm-up)
    for the package on sys.path, discrete and continuous params: 4096 envs
    x B1_STEPS and x BENCH_STEPS, and one env alone x BENCH_STEPS (its
    chain's dependent latency, the card otherwise idle). `python3
    chip_smoke.py --b1-times` prints them; from another checkout's root,
    `python -c "import runpy, sys; sys.argv = ['', '--b1-times'];
    runpy.run_path('<this checkout>/chip_smoke.py', run_name='__main__')"`
    times that checkout's kernel."""
    from cartpoleplusplus_tpu_torch import (CartPole3D, CartPoleParams,
                                            continuous_params)
    from cartpoleplusplus_tpu_torch.ops.fused_rollout import fused_rollout

    import hashlib

    out = {}
    for name, p in (("discrete", CartPoleParams()),
                    ("continuous", continuous_params())):
        for b, t, reps in ((N_ENVS, B1_STEPS, 50), (N_ENVS, BENCH_STEPS, 5),
                           (1, BENCH_STEPS, 5)):
            env = CartPole3D(p, num_envs=b, device=dev)
            state, _ = env.reset(7)
            out[f"{name} {b}x{t}"] = _time_ms(
                lambda: fused_rollout(env, state, t), reps)
            # A digest of the output bits, to hold two checkouts equal.
            final, checksum = fused_rollout(env, state, t)
            h = hashlib.sha1()
            for x in (*final.phys, final.steps, final.episode, checksum):
                h.update(x.cpu().numpy().tobytes())
            out[f"{name} {b}x{t} bits"] = h.hexdigest()[:16]
    return out


# A probe of B1's substep on the card, compiled apart from the library:
# the exact fast forms of csrc/cartpole_env.cuh against nvcc's IEEE forms
# over every float they are claimed for, each instruction's dependent
# latency (a chain of 4096 in one thread, clock64), the SM clock, and the
# substep chain alone in one thread.
_B1_PROBE_CU = r"""
#include "cartpole_env.cuh"
namespace {
__global__ void exact_kernel(int which, uint32_t lo, uint32_t n, float b,
                             double inv_b, unsigned long long* bad) {
  unsigned long long mine = 0;
  for (uint32_t k = blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += gridDim.x * blockDim.x) {
    const float x = __uint_as_float(lo + k);
    float got, want;
    if (which == 0) { got = cp::sqrt_fast(x); want = sqrtf(x); }
    else if (which == 1) { got = cp::rcp_fast(x); want = 1.0f / x; }
    else { got = cp::div_by(x, inv_b); want = x / b; }
    mine += __float_as_uint(got) != __float_as_uint(want);
  }
  if (mine) atomicAdd(bad, mine);
}
constexpr int kChain = 4096;
#define CHAIN(i, body) { const long long t0 = clock64();                  \
  _Pragma("unroll 16") for (int k = 0; k < kChain; ++k) { body; }         \
  cyc[i] = clock64() - t0; }
__global__ void latency_kernel(float x, double* out, long long* cyc,
                               float* sink) {
  float a = x, b = x, c = x, d = x, e = x, f = x, g = x;
  double h = x;
  CHAIN(0, asm volatile("add.f32 %0, %0, %1;" : "+f"(a) : "f"(x)))
  CHAIN(1, asm volatile("mul.f32 %0, %0, %1;" : "+f"(b) : "f"(x)))
  CHAIN(2, asm volatile("fma.rn.f32 %0, %0, %1, %1;" : "+f"(c) : "f"(x)))
  CHAIN(3, asm volatile("max.f32 %0, %0, %1;" : "+f"(d) : "f"(x)))
  CHAIN(4, asm volatile("rsqrt.approx.ftz.f32 %0, %0;" : "+f"(e)))
  CHAIN(5, asm volatile("rcp.approx.ftz.f32 %0, %0;" : "+f"(f));
           asm volatile("add.f32 %0, %0, %1;" : "+f"(f) : "f"(x)))
  CHAIN(6, asm volatile("mul.f64 %0, %0, %1;" : "+d"(h) : "d"(1.0)))
  CHAIN(7, asm volatile("{.reg .f64 t; cvt.f64.f32 t, %0; "
                        "cvt.rn.f32.f64 %0, t;}" : "+f"(g)))
  unsigned long long ns0, ns1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
  const long long c0 = clock64();
  while (clock64() - c0 < 200000000ll) {}
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
  *out = 2e8 / static_cast<double>(ns1 - ns0);  // cycles per ns
  *sink = a + b + c + d + e + f + g + static_cast<float>(h);
}
__global__ void substep_kernel(EnvConsts c, int n, long long* cyc,
                               float* sink) {
  const cp::Phys s0{0.0f, 0.0f, c.z0, 0.3f, -0.2f, 0.0f, 0.0f, 0.0f, 0.4f,
                   0.2f};
  cp::Phys s = s0;
  const long long t0 = clock64();
  for (int k = 0; k < n; ++k) {  // an episode's start every 5 env-steps
    cp::substep(c, s, 1.0f, 0.0f, 0.0f, 0.0f);
    if (k % 75 == 74) s = s0;
  }
  *cyc = clock64() - t0;
  *sink = s.x + s.y + s.z + s.vx + s.vy + s.vz + s.sx + s.sy + s.sdx + s.sdy;
}
}  // namespace
extern "C" {
long long probe_exact(int which, uint32_t lo, uint32_t hi, float b,
                      double inv_b) {
  unsigned long long* bad;
  unsigned long long host = 0;
  cudaMalloc(&bad, sizeof(host));
  cudaMemset(bad, 0, sizeof(host));
  exact_kernel<<<1024, 256>>>(which, lo, hi - lo + 1, b, inv_b, bad);
  cudaMemcpy(&host, bad, sizeof(host), cudaMemcpyDeviceToHost);
  cudaFree(bad);
  return cudaGetLastError() == cudaSuccess ? static_cast<long long>(host)
                                           : -1;
}
int probe_latency(double* cycles_per_op, double* cycles_per_ns) {
  long long* cyc;
  double* out;
  float* sink;
  cudaMalloc(&cyc, 8 * sizeof(long long));
  cudaMalloc(&out, sizeof(double));
  cudaMalloc(&sink, sizeof(float));
  long long host[8];
  for (int rep = 0; rep < 2; ++rep)  // the first run warms the code
    latency_kernel<<<1, 1>>>(0.999f, out, cyc, sink);
  cudaMemcpy(host, cyc, sizeof(host), cudaMemcpyDeviceToHost);
  cudaMemcpy(cycles_per_ns, out, sizeof(double), cudaMemcpyDeviceToHost);
  for (int i = 0; i < 8; ++i) cycles_per_op[i] = host[i] / 4096.0;
  cudaFree(cyc);
  cudaFree(out);
  cudaFree(sink);
  return static_cast<int>(cudaGetLastError());
}
int probe_substep(const EnvConsts* c, int n, double* cycles_per_substep) {
  long long* cyc;
  float* sink;
  long long host = 0;
  cudaMalloc(&cyc, sizeof(long long));
  cudaMalloc(&sink, sizeof(float));
  for (int rep = 0; rep < 2; ++rep)
    substep_kernel<<<1, 1>>>(*c, n, cyc, sink);
  cudaMemcpy(&host, cyc, sizeof(host), cudaMemcpyDeviceToHost);
  *cycles_per_substep = static_cast<double>(host) / n;
  cudaFree(cyc);
  cudaFree(sink);
  return static_cast<int>(cudaGetLastError());
}
}
"""
_PROBE_OPS = ("FADD", "FMUL", "FFMA", "FMNMX", "MUFU.RSQ", "MUFU.RCP",
              "DMUL", "F2F pair")
# The substep's two loop-carried chains at the defaults (no friction or
# damping), counted from cp::substep: the instructions of each kind that
# each wait on the one before. The s chain runs sx^2, w2, sqrt_fast,
# rcp_fast, inv_w^2, c_z, rv_z, the (jc sx inv_w) rv_z product and its
# difference, div_by, rhs, dot, asx, sdx, sx and the clamp test (its FSETP
# counted as an FMNMX); the z chain runs pen, the contact force and its
# select (as an FMNMX), rv_z, the same rhs, dot and asx, the az sum and its
# div_by, vz and z.
_SUBSTEP_CHAINS = {
    "s": {"FADD": 13, "FMUL": 12, "FFMA": 4, "FMNMX": 4, "MUFU.RSQ": 1,
          "MUFU.RCP": 1, "DMUL": 1, "F2F pair": 1},
    "z": {"FADD": 11, "FMUL": 10, "FFMA": 0, "FMNMX": 4, "MUFU.RSQ": 0,
          "MUFU.RCP": 0, "DMUL": 2, "F2F pair": 2},
}


def b1_probe(dev) -> dict:
    """Builds and runs the probe above: asserts every fast form gives the
    IEEE bits over its range, and returns the latencies (cycles), the SM
    clock, the substep chain's latency floor and the substep alone."""
    import ctypes
    import os

    import numpy as np

    from cartpoleplusplus_tpu_torch import CartPoleParams, continuous_params
    from cartpoleplusplus_tpu_torch.ops import _native

    os.makedirs(_native.BUILD_DIR, exist_ok=True)
    src = os.path.join(_native.BUILD_DIR, "b1_probe.cu")
    lib_path = os.path.join(_native.BUILD_DIR, "libb1_probe.so")
    with open(src, "w") as f:
        f.write(_B1_PROBE_CU)
    flags = [x for x in _native.NVCC_FLAGS if x not in ("-Xptxas", "-v")]
    subprocess.run([_native._nvcc(), *flags, "-shared", "-I", _native.CSRC,
                    "-o", lib_path, src], check=True, capture_output=True,
                   timeout=300)
    lib = ctypes.CDLL(lib_path)
    lib.probe_exact.argtypes = [ctypes.c_int, ctypes.c_uint32,
                                ctypes.c_uint32, ctypes.c_float,
                                ctypes.c_double]
    lib.probe_exact.restype = ctypes.c_longlong
    bits = lambda v: int(np.float32(v).view(np.uint32))  # noqa: E731
    ranges = {"sqrt_fast [1e-30, 2^100]": (0, bits(1e-30), bits(2.0 ** 100),
                                            1.0, 1.0),
              "rcp_fast [1e-15, 4]": (1, bits(1e-15), bits(4.0), 1.0, 1.0)}
    for p in (CartPoleParams(), continuous_params()):
        c = _native.env_consts(p)
        for name, inv in (("mt", c.inv_mt), ("reset_det", c.inv_reset_det)):
            b = getattr(c, name)
            for sign, (lo, hi) in (("+", (0, 0x7F7FFFFF)),
                                   ("-", (0x80000000, 0xFF7FFFFF))):
                ranges[f"div_by {name} {b:.6g} {sign}finite"] = (2, lo, hi,
                                                                  b, inv)
    exact = {}
    for name, (which, lo, hi, b, inv) in ranges.items():
        exact[name] = int(lib.probe_exact(which, lo, hi, b, inv))
        assert exact[name] == 0, (name, exact[name])
    lat = (ctypes.c_double * len(_PROBE_OPS))()
    per_ns = ctypes.c_double()
    assert lib.probe_latency(lat, ctypes.byref(per_ns)) == 0
    lat = dict(zip(_PROBE_OPS, lat))
    # ptxas folds rcp(rcp(x)), so that chain interleaves an FADD.
    lat["MUFU.RCP"] -= lat["FADD"]
    cyc = ctypes.c_double()
    c = _native.env_consts(CartPoleParams())
    assert lib.probe_substep(_native.struct_ptr(c), 4096,
                             ctypes.byref(cyc)) == 0
    chains = {k: sum(n * lat[op] for op, n in ops.items())
              for k, ops in _SUBSTEP_CHAINS.items()}
    floor = max(chains.values())
    p = CartPoleParams()
    substeps = B1_STEPS * p.action_repeats * p.steps_per_repeat
    return dict(exact=exact, latency_cycles=lat,
                ghz=per_ns.value, chain_cycles=chains,
                substep_alone_cycles=cyc.value,
                floor_ms=substeps * floor / per_ns.value * 1e-6)


def phase_b1(dev):
    import torch

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
        # The benchmark's length: two launches bit for bit.
        bench = [fused_rollout(env, state, BENCH_STEPS) for _ in range(2)]
        assert all(torch.equal(a, b) for a, b in zip(
            (*bench[0][0].phys, bench[0][0].steps, bench[0][0].episode,
             bench[0][1]),
            (*bench[1][0].phys, bench[1][0].steps, bench[1][0].episode,
             bench[1][1]))), f"B1 {name} {BENCH_STEPS} steps not repeatable"
        plain_ms = _time_ms(lambda: reference_rollout(env, state, B1_STEPS),
                            2)
        st_bytes = _nbytes(*state.phys, state.steps, state.episode)
        out[name] = dict(max_abs_err=max(errs), errs=errs, plain_ms=plain_ms,
                         rel=rel, ended=int(rs.episode.sum()),
                         **_bound(N_ENVS * B1_STEPS * (_env_step_flop(p) + 2),
                                  2 * st_bytes + _nbytes(state.env_seed)
                                  + 4))
    times = b1_times(dev)
    for name, r in out.items():
        ms = times[f"{name} {N_ENVS}x{B1_STEPS}"]
        bench_ms = times[f"{name} {N_ENVS}x{BENCH_STEPS}"]
        one_ms = times[f"{name} 1x{BENCH_STEPS}"]
        print(f"B1 {name}: max_abs_err pos/s/vel/sd "
              f"{' '.join(f'{e:.3g}' for e in r.pop('errs'))}, checksum rel "
              f"err {r['rel']:.3g}, episodes ended "
              f"{r['ended']}; {N_ENVS}x{B1_STEPS}: kernel {ms:.4f} ms "
              f"({N_ENVS * B1_STEPS / ms * 1e3:.4g} env-steps/s), plain "
              f"{r['plain_ms']:.2f} ms; {N_ENVS}x{BENCH_STEPS}: kernel "
              f"{bench_ms:.4f} ms ({N_ENVS * BENCH_STEPS / bench_ms * 1e3:.4g}"
              f" env-steps/s, CUDA events), two runs bit for bit; one env "
              f"alone x {BENCH_STEPS} (the chain's latency) {one_ms:.4f} ms, "
              f"{bench_ms / one_ms:.3f} of it for {N_ENVS} envs", flush=True)
        r.update(ms=ms, bench_ms=bench_ms, chain_ms=one_ms)
    probe = b1_probe(dev)
    _print_b1_probe(probe, {k: r["ms"] for k, r in out.items()})
    return out


def _print_b1_probe(probe: dict, ms: dict) -> None:
    """The probe's line; `ms`: B1's ms at N_ENVS x B1_STEPS by params."""
    lat = ", ".join(f"{k} {v:.2f}" for k, v in
                    probe["latency_cycles"].items())
    chains = ", ".join(f"{k} {v:.1f}" for k, v in
                       probe["chain_cycles"].items())
    shares = "".join(f", {k} kernel {v:.4f} ms at {probe['floor_ms'] / v:.3f}"
                     f" of it" for k, v in ms.items())
    print(f"B1 probe: fast forms bit for bit the IEEE forms over "
          f"{len(probe['exact'])} ranges (every float); dependent latency "
          f"(cycles, one thread) {lat}; SM clock {probe['ghz']:.4f} GHz; "
          f"substep chains (cycles) {chains}; the substep alone in one "
          f"thread {probe['substep_alone_cycles']:.1f} cycles; latency floor "
          f"at {N_ENVS}x{B1_STEPS} (375 substeps x the longer chain) "
          f"{probe['floor_ms']:.4f} ms{shares} ({_card()})", flush=True)


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


def _b3_compare(dev, hidden, k, batch=B3_BATCH, batches=None, **kw):
    """B3 and its twin on the same inputs (`batches`, or seeded random
    ones): max abs error over the 8 groups and both loss vectors (held to
    B3_RTOL/B3_ATOL), and whether a second run of the kernel gave the same
    bits."""
    import torch

    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk

    groups, drawn = _b3_inputs(dev, hidden, batch, k, seed=21)
    batches = drawn if batches is None else batches
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
    ms = _time_ms(lambda: fused_rollout(env, state, BENCH_STEPS), 3)
    print(f"physics-only rollout: {N_ENVS}x{BENCH_STEPS} in {secs:.4f} s "
          f"({N_ENVS * BENCH_STEPS / secs:.4g} env-steps/s, host clock, "
          f"first call), {ms:.4f} ms ({N_ENVS * BENCH_STEPS / (ms / 1e3):.4g} "
          f"env-steps/s, CUDA events, mean of 3 after a warm-up); launches "
          f"{launches}", flush=True)
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


def _print_split(title, parts, step, n_rounds=SPLIT_ROUNDS):
    """Times each part alone, round-robin over n_rounds (host dispatch
    bounds these times, so they drift with the host's load: each keeps its
    median round), and profiles one `step()` for its device time and
    kernel count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    rounds = {name: [] for name in parts}
    for _ in range(n_rounds):
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
    return ms


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
    main library's argument types (_load_like_main)."""
    import ctypes

    out = proc.communicate(timeout=600)[0]
    assert proc.returncode == 0, f"stage-clock nvcc failed:\n{out}"
    lib = _load_like_main(path)
    lib.cp_stage_clock_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
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


def _b9_split_flop(n, hidden) -> tuple:
    """Float operations of one LRPG update over n rows: (the products': per
    row the forward, the weight gradients and the input gradients below
    the head (all but layer 0's) as 2 per multiply-add; the others: the
    LayerNorm, softmax and entropy epilogues at ~10 per element per row,
    then Adam at ~10 per parameter)."""
    dims = (42,) + tuple(hidden) + (5,)
    macs = _mlp_macs(dims)
    dx = _mlp_macs(dims[1:])
    p = sum(a * b + b for a, b in zip(dims[:-1], dims[1:])) \
        + 2 * sum(hidden)
    return (n * 2 * (2 * macs + dx),
            n * 10 * (sum(hidden) + 5) + 10 * p)


def _b9_flop(n, hidden) -> int:
    """Float operations of one LRPG update over n rows (_b9_split_flop's
    two counts together)."""
    return sum(_b9_split_flop(n, hidden))


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
SUITE_LEARNER = (8192, 8)  # the `*.suite` cells' learner batch and K
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
    errs, bitwise, groups, batches = _all_wide(
        lk.ddpg_update_phase, lambda: _b3_compare(dev, hidden, k, batch=b,
                                                  **kw))
    assert bitwise, "B3 at batch 8192: two runs differ"
    ms = _time_ms(lambda: lk.ddpg_update_phase(groups, batches, B3_T0,
                                               hidden, **kw), 10)
    lay_a, lay_c = lk.actor_layout(42, hidden), lk.critic_layout(42, hidden)
    views = [lk.group_views(g, lay) for g, lay in zip(
        groups, (lay_a, lay_c, lay_a, lay_c, lay_a, lay_a, lay_c, lay_c))]
    plain_ms = _time_ms(lambda: lk.update_phase_math(
        *views, batches, B3_T0, hidden, **kw), 1)
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
        *views, window, B3_T0, hidden, **kw), 2)
    b9 = dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
              **_bound(_b9_flop(B9_FAST_N, hidden),
                       _nbytes(*window) + 2 * _nbytes(*groups) + 4))
    print(f"B9 over {B9_FAST_N} rows, hidden {hidden}: max_abs_err "
          f"{b9['max_abs_err']:.3g} (rtol {B3_RTOL}, atol {B3_ATOL}); two "
          f"runs bitwise equal; kernel {ms:.4f} ms, plain {plain_ms:.2f} "
          f"ms, bound {b9['bound_ms']:.4f} ms by {b9['bound_by']} [{_card()}]",
          flush=True)
    return b3, b9


def _all_wide(phase, run):
    """run()'s result; every launch of the learner wrapper `phase` that it
    made must have taken the wide row items (`phase.wide_launches`)."""
    before = phase.launches, phase.wide_launches
    out = run()
    n, wide = phase.launches - before[0], phase.wide_launches - before[1]
    assert n >= 1 and wide == n, \
        f"{phase.__name__}: {wide} of {n} launches in the wide items"
    return out


def phase_suite_learners(dev):
    """B5 (double DQN on and off) and B7 (clip 10) at the suite cells'
    learner shape, batch 8192 x K 8 on (256, 256) from warmed moments, in
    their wide row items (B3 at that shape: phase_preset_kernels): each
    against its twin at B3's bar, two runs bit for bit, every launch
    counted in `wide_launches`; then each timed (CUDA events)."""
    from cartpoleplusplus_tpu_torch.agents.common import lr_schedule
    from cartpoleplusplus_tpu_torch.agents.naf import NAFConfig
    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk

    hidden, (b, k), out = (256, 256), SUITE_LEARNER, {}
    groups, batches = _b5_inputs(dev, hidden, b, k, seed=21)
    for double_dqn in (True, False):
        tag = f"B5 {'double' if double_dqn else 'max'}"
        errs = _all_wide(lk.dqn_update_phase, lambda: _b5_compare(
            groups, batches, hidden, double_dqn, tag))
        ms = _all_wide(lk.dqn_update_phase, lambda: _time_ms(
            lambda: lk.dqn_update_phase(groups, batches, B3_T0, hidden,
                                        lr=5e-5, gamma=0.99, tau=0.01,
                                        double_dqn=double_dqn), 5))
        out[tag] = dict(max_abs_err=max(errs.values()), ms=ms)
    del groups, batches
    cfg = NAFConfig()
    kw = dict(lr=cfg.lr, gamma=cfg.gamma, tau=cfg.tau, max_grad_norm=10.0,
              lr_schedule=lr_schedule(cfg))
    groups, batches = _b7_inputs(dev, hidden, b, k, seed=33)
    errs = _all_wide(lk.naf_update_phase, lambda: _b7_compare(
        groups, batches, hidden, kw, "clip 10.0"))
    ms = _all_wide(lk.naf_update_phase, lambda: _time_ms(
        lambda: lk.naf_update_phase(groups, batches, B3_T0, hidden, **kw),
        5))
    out["B7 clip 10.0"] = dict(max_abs_err=max(errs.values()), ms=ms)
    for tag, r in out.items():
        print(f"{tag} at batch {b} x K {k}, hidden {hidden}, wide row "
              f"items: max_abs_err {r['max_abs_err']:.3g} (rtol {B3_RTOL}, "
              f"atol {B3_ATOL}); two runs bitwise equal; every launch "
              f"wide; kernel {r['ms']:.4f} ms per phase [{_card()}]",
              flush=True)
    return out


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


# Pixel DQN, NAF and LRPG (phases 25-26): the `pixels` preset's env fields
# (2048 envs, 48 x 48 gray uint8 frames, 2 cameras, frame-diff gain 4) with
# each agent's default widths; DQN and NAF take the DDPG pixel preset's
# replay fields (64 slots per env, block sampling), the one cut of depth.
PIXEL_ENV_ARGV = PIXEL_ARGV[:PIXEL_ARGV.index("--ddpg.sample")]
PIXEL_AGENT_ARGV = {
    "dqn": ["--agent", "dqn", "--dqn.sample", "block",
            "--dqn.replay-capacity-per-env", "64"],
    "naf": ["--agent", "naf", "--naf.sample", "block",
            "--naf.replay-capacity-per-env", "64"],
    "lrpg": ["--agent", "lrpg"],
}
# Each agent's rollout kernel, which pixels leave out (the plain rollout
# runs on the card and says so once on stderr), and the env-steps run.
PIXEL_AGENT_ROLLOUT = {"dqn": ("B4", 64), "naf": ("B6", 64),
                       "lrpg": ("B8", 256)}


def phase_pixel_agents_main_path():
    """Phase 25: pixel DQN, NAF and LRPG through train.main at this slice's
    widths with the counters zeroed (DQN and NAF 64 env-steps, LRPG 256,
    each plus a 200-step greedy eval): B10 once per env.step and env.reset
    and once for the cached reset frame, every other kernel never, the
    plain rollout (one stderr line naming the kernel it leaves out) and the
    plain learner; LRPG's peak card memory over its run. Then 2 train
    steps of pixel DQN under CARTPOLE_RENDER_CULL=1: B11 in B10's place."""
    import torch

    eval_steps = 200
    out = {}
    for name, argv in PIXEL_AGENT_ARGV.items():
        kernel, total = PIXEL_AGENT_ROLLOUT[name]
        _zero_counts()
        torch.cuda.reset_peak_memory_stats()
        rc, lines, err, secs = _train_lines(
            PIXEL_ENV_ARGV + argv + [
                "--total-env-steps", str(total), "--log-interval", "1",
                "--final-eval", "--eval-steps", str(eval_steps), "--seed",
                "0"])
        peak = torch.cuda.max_memory_allocated()
        launches = _read_counts()
        assert rc == 0, f"pixel {name} train.main returned {rc}"
        steps, ev = lines[:-1], lines[-1]
        t = total // len(steps)
        b10_want = 1 + total + 1 + 1 + eval_steps
        assert _only(launches, B10=b10_want), \
            f"pixel {name}: launches {launches}, want B10 {b10_want} only"
        told = [ln for ln in err.splitlines()
                if f"kernel {kernel} does not cover" in ln]
        assert len(told) == 1, err
        for m in lines:
            assert all(math.isfinite(v) for v in m.values()), m
        assert all(m["rollout_impl"] == 0.0 and m["learner_impl"] == 0.0
                   for m in steps)
        assert steps[-1]["loss"] != 0.0
        assert 0 < ev["eval_mean_episode_length"] <= eval_steps
        for m in steps:
            print(f"pixel {name} train step {m['train_step']}: loss "
                  f"{m['loss']:.6g} reward_mean {m['reward_mean']:.6g} "
                  f"done_frac {m['done_frac']:.6g} env_steps_per_sec "
                  f"{m['env_steps_per_sec']}", flush=True)
        sec_per_step = PIX_ENVS * t / steps[-1]["env_steps_per_sec"]
        print(f"pixel {name} main path: {len(steps)} train steps "
              f"({sec_per_step:.4f} s per train step over the run, "
              f"train.main total {secs:.2f} s incl. init and eval); peak "
              f"card memory {peak / 2**30:.3f} GiB; eval {json.dumps(ev)}; "
              f"launches {launches}; {_card()}", flush=True)
        out[name] = dict(launches=launches, peak=peak)

    _zero_counts()
    rc, lines, _, secs = _train_lines(
        PIXEL_ENV_ARGV + PIXEL_AGENT_ARGV["dqn"] + [
            "--total-env-steps", "16", "--log-interval", "1", "--seed", "0"],
        env={"CARTPOLE_RENDER_CULL": "1"})
    cull = _read_counts()
    assert rc == 0, f"culled pixel dqn train.main returned {rc}"
    assert _only(cull, B11=1 + 1 + 16), cull
    assert all(math.isfinite(v) for m in lines for v in m.values())
    print(f"pixel dqn under CARTPOLE_RENDER_CULL=1: 2 train steps in "
          f"{secs:.2f} s (host clock, incl. init); launches {cull}",
          flush=True)
    out["cull"] = cull
    return out


def phase_pixel_agents_step_split(dev):
    """Phase 26: where a pixel DQN, NAF and LRPG train step's time goes, as
    phase 23: the plain rollout (and within it B10), the late insert and
    the block presample (LRPG: the window's returns and advantages), the
    plain learner, the profiler's device time, kernel count and idle
    share, the env-steps/s of the whole step, and LRPG's peak card memory
    over one train step."""
    import argparse

    import torch

    from cartpoleplusplus_tpu_torch import train
    from cartpoleplusplus_tpu_torch.agents.lrpg import returns_to_go
    from cartpoleplusplus_tpu_torch.config import RunConfig, from_args
    from cartpoleplusplus_tpu_torch.ops import render_kernel as rk
    from cartpoleplusplus_tpu_torch.ops.naf_rollout import (
        reference_naf_rollout)
    from cartpoleplusplus_tpu_torch.ops.pg_rollout import (
        reference_pg_rollout)
    from cartpoleplusplus_tpu_torch.ops.q_rollout import reference_q_rollout

    out = {}
    for name, argv in PIXEL_AGENT_ARGV.items():
        ap = train.build_parser()
        args: argparse.Namespace = ap.parse_args(PIXEL_ENV_ARGV + argv)
        with contextlib.redirect_stderr(io.StringIO()):
            _, agent = train.build(from_args(RunConfig, args), args, set())
        c, env = agent.cfg, agent.env
        t = c.rollout_steps
        st = agent.init(0)
        for _ in range(3 if name != "lrpg" else 1):  # past the warmup
            st, _ = agent.train_step(st)
        phys = st.env_state.phys
        snaps = type(phys)(*(torch.cat([x] * env.params.action_repeats)
                             for x in phys))
        reps = 1 if name == "lrpg" else 2
        parts = {"whole train step": (lambda: agent.train_step(st), reps)}
        if name == "lrpg":
            def rollout():
                return reference_pg_rollout(env, st.policy, st.env_state,
                                            st.obs, st.env_steps, t)
        elif name == "dqn":
            def rollout():
                return reference_q_rollout(env, st.q, st.env_state, st.obs,
                                           st.env_steps,
                                           agent.epsilon(st.env_steps), t)
        else:
            def rollout():
                return reference_naf_rollout(env, st.net, st.env_state,
                                             st.obs, st.env_steps,
                                             agent._sigma(st.env_steps), t)
        traj = rollout()[2]
        parts[f"plain rollout ({t} env-steps)"] = (rollout, reps)
        parts[f"of which B10 render ({t} env-steps)"] = (
            lambda: [rk.render_frames(env.params, env.render_config, snaps)
                     for _ in range(t)], 2)
        if name == "lrpg":
            obs_t, act_t, rew_t, done_t = traj

            def advantages():
                g = returns_to_go(rew_t, done_t, c.gamma,
                                  st.baseline.expand(env.num_envs))
                adv = g - g.mean()
                return adv / (torch.sqrt(torch.mean(adv * adv)) + 1e-6)

            adv = advantages()

            def plain_update():
                loss = agent._loss(st.policy, obs_t, act_t, adv)
                return torch.autograd.grad(loss,
                                           list(st.policy.parameters()))

            parts["returns-to-go and advantages"] = (advantages, 3)
            parts[f"plain update's gradient over "
                  f"{obs_t.shape[0] * obs_t.shape[1]} frames"] = (
                plain_update, 1)
        else:
            def presample():
                return agent.replay.presample_block(
                    st.replay, c.batch_size, c.updates_per_step,
                    generator=st.generator)

            def plain_learner():
                batches = presample()
                s = st
                for k in range(c.updates_per_step):
                    s, _ = agent._update_once(s, tuple(x[k] for x in
                                                       batches))

            parts["late replay insert"] = (
                lambda: agent.replay.add_trajectory(st.replay, *traj), 3)
            parts["block presample"] = (presample, 3)
            parts[f"plain learner, {c.updates_per_step} conv updates"] = (
                plain_learner, 2)
        ms = _print_split(f"pixel {name} train-step split ({_card()})",
                          parts, lambda: agent.train_step(st),
                          PIXEL_SPLIT_ROUNDS)
        rate = env.num_envs * t / (ms["whole train step"] / 1e3)
        line = f"pixel {name}: {rate:.6g} env-steps/s over the whole step"
        if name == "lrpg":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            agent.train_step(st)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            line += (f"; peak card memory over one train step "
                     f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} "
                     f"GiB above the {base / 2**30:.3f} GiB held before it)")
            out["lrpg_peak"] = peak
        print(line + f"; {_card()}", flush=True)
        out[name] = ms
        del st, agent, traj
        torch.cuda.empty_cache()
    return out


def phase_sampling(dev):
    """Phase 27: block sampling on state obs for DQN and NAF, uniform for
    DDPG, at the CLI defaults with the counters zeroed (64 env-steps): B4 x
    8 and B5 x 7, B6 x 8 and B7 x 7 (`--naf.learner kernel`), B2 x 8 and B3
    x 7, nothing else. Then each learner kernel on one presample of that
    mode drawn from a filled ring, from warmed moments, against its twin:
    B5 and B7 at phases 9 and 17's bars, B3 at phase 4b's."""
    import argparse

    from cartpoleplusplus_tpu_torch import train
    from cartpoleplusplus_tpu_torch.agents.common import lr_schedule
    from cartpoleplusplus_tpu_torch.config import RunConfig, from_args

    runs = {"dqn": (["--agent", "dqn", "--dqn.sample", "block"],
                    dict(B4=8, B5=7)),
            "naf": (["--agent", "naf", "--naf.learner", "kernel",
                     "--naf.sample", "block"], dict(B6=8, B7=7)),
            "ddpg": (["--ddpg.sample", "uniform"], dict(B2=8, B3=7))}
    out = {}
    for name, (argv, want) in runs.items():
        _zero_counts()
        rc, lines, _, secs = _train_lines(argv + [
            "--total-env-steps", "64", "--log-interval", "1", "--seed",
            "0"])
        launches = _read_counts()
        assert rc == 0, f"{name} {argv} returned {rc}"
        assert _only(launches, **want), (name, launches)
        assert all(m["rollout_impl"] == 1.0 and m["learner_impl"] == 1.0
                   and all(math.isfinite(v) for v in m.values())
                   for m in lines)
        loss = "critic_loss" if name == "ddpg" else "loss"
        assert all(m[loss] > 0.0 for m in lines[1:])
        print(f"{name} {' '.join(argv)}: 8 train steps in {secs:.2f} s (host "
              f"clock, incl. init), last step {loss} {lines[-1][loss]:.6g}, "
              f"env_steps_per_sec {lines[-1]['env_steps_per_sec']}; "
              f"launches {launches}", flush=True)

        ap = train.build_parser()
        args: argparse.Namespace = ap.parse_args(argv)
        _, agent = train.build(from_args(RunConfig, args), args, set())
        c = agent.cfg
        st = agent.init(0)
        for _ in range(3):
            st, _ = agent.train_step(st)
        draw = {"block": agent.replay.presample_block,
                "uniform": agent.replay.presample_uniform}[c.sample]
        batches = tuple(x.contiguous() for x in draw(
            st.replay, c.batch_size, c.updates_per_step,
            generator=st.generator))
        hidden = tuple(c.hidden)
        tag = f"{c.sample} presample"
        if name == "dqn":
            groups, _ = _b5_inputs(dev, hidden, B5_BATCH, B5_K, seed=21)
            errs = _b5_compare(groups, batches, hidden, c.double_dqn, tag)
        elif name == "naf":
            groups, _ = _b7_inputs(dev, hidden, B7_BATCH, B7_K, seed=33)
            errs = _b7_compare(groups, batches, hidden, dict(
                lr=c.lr, gamma=c.gamma, tau=c.tau,
                max_grad_norm=c.max_grad_norm, lr_schedule=lr_schedule(c)),
                tag)
        else:
            errs, bitwise, _, _ = _b3_compare(
                dev, hidden, c.updates_per_step, batches=batches,
                actor_lr=c.actor_lr, critic_lr=c.critic_lr, gamma=c.gamma,
                tau=c.tau)
            assert bitwise, "B3: two runs on the uniform presample differ"
        kernel = {"dqn": "B5", "naf": "B7", "ddpg": "B3"}[name]
        err = max(errs.values())
        print(f"{kernel} on a {tag} of the filled ring (batch "
              f"{c.batch_size} x K {c.updates_per_step}, warmed moments): "
              f"max_abs_err {err:.3g} (rtol {B3_RTOL}, atol {B3_ATOL}), "
              f"two runs bitwise equal", flush=True)
        out[name] = dict(launches=launches, max_abs_err=err)
        del st, agent, batches
    return out


def phase_render_bfloat16(dev):
    """Phase 28: `--render-dtype bfloat16` on the card. Two pixel DDPG
    train steps through train.main at float32 and at bfloat16 launch B10
    equally often (18 each) and nothing else; the same two train steps
    through train.build give frames equal bit for bit (the current frames
    and the ring after the late insert), since B10 renders in float32
    whatever the dtype, as the reference's kernel does."""
    import argparse

    import torch

    from cartpoleplusplus_tpu_torch import train
    from cartpoleplusplus_tpu_torch.config import RunConfig, from_args

    counts, states = {}, {}
    for dtype in ("float32", "bfloat16"):
        argv = PIXEL_ARGV + ["--render-dtype", dtype]
        _zero_counts()
        rc, lines, _, _ = _train_lines(argv + [
            "--total-env-steps", "16", "--log-interval", "1", "--seed", "0"])
        counts[dtype] = _read_counts()
        assert rc == 0 and len(lines) == 2, f"--render-dtype {dtype}: {rc}"
        assert _only(counts[dtype], B10=1 + 1 + 16), counts[dtype]
        args: argparse.Namespace = train.build_parser().parse_args(argv)
        env, agent = train.build(from_args(RunConfig, args), args, set())
        assert env.render_config.dtype == dtype
        st = agent.init(0)
        for _ in range(2):
            st, _ = agent.train_step(st)
        states[dtype] = (st.obs, st.replay.obs)
        del agent, st
    same = all(torch.equal(a, b) for a, b in zip(states["float32"],
                                                 states["bfloat16"]))
    assert same, "bfloat16-config frames differ from float32's on the card"
    print(f"--render-dtype bfloat16 on the card: 2 pixel DDPG train steps, "
          f"launches float32 {counts['float32']}, bfloat16 "
          f"{counts['bfloat16']}; current frames and the ring's "
          f"{int(states['float32'][1].numel())} uint8 values equal bit for "
          f"bit", flush=True)
    return counts


DIST_ENVS = 8192         # BASELINE config 5's global envs (2 x 4096)
DIST_CHECK_STEPS = 4     # train steps held bit for bit (3 learn)
DIST_TIME_STEPS = 6      # train steps timed per rank, then as many with
                         # the collectives timed
DIST_AGENT_ENVS = 4096   # DQN, NAF and LRPG shardmap steps
DIST_AGENT_STEPS = 3
DIST_TIMEOUT_S = 420
# Pixel DDPG under shardmap: the pixels preset's agent fields on its
# frames (gray, uint8, frame-diff gain 4) at 16 x 16, 2 train steps.
DIST_PIXEL_STEPS = 2
DIST_PIXEL_ARGV = PIXEL_ARGV + ["--render-size", "16"]


def _state_digest(st, with_ring: bool = True) -> dict:
    """A state's tree on the CPU for bitwise comparison: everything but
    the replay ring's tensors, which become a per-env int64 sum of their
    bit patterns (computed on the card)."""
    import torch

    from cartpoleplusplus_tpu_torch.ckpt.checkpoint import to_tree

    tree = to_tree(st, exclude=("replay",))
    rs = getattr(st, "replay", None)
    if rs is not None and with_ring:
        def bits(x):
            x = x.reshape(x.shape[0], -1)
            if x.dtype == torch.float32:
                x = x.view(torch.int32)
            return x.to(torch.int64).sum(1).cpu()
        tree["replay"] = {"obs": bits(rs.obs), "action": bits(rs.action),
                          "reward": bits(rs.reward), "done": bits(rs.done),
                          "cursor": rs.cursor, "filled": rs.filled}
    return tree


def _trees_equal(a, b, path="") -> list:
    """The paths where two digest trees differ (bit for bit)."""
    import torch

    if isinstance(a, dict):
        return [p for k in a for p in _trees_equal(a[k], b[k],
                                                   f"{path}.{k}")]
    if isinstance(a, (list, tuple)):
        return [p for i, (x, y) in enumerate(zip(a, b))
                for p in _trees_equal(x, y, f"{path}[{i}]")]
    if isinstance(a, torch.Tensor):
        return [] if a.dtype == b.dtype and torch.equal(a, b) else [path]
    return [] if a == b else [path]


def _dist_agent(name, num_envs, mesh=None, spmd=True, argv=None, **cfg):
    """A port agent at its CLI defaults (DDPG and NAF on the continuous
    preset) on `num_envs` global envs, this rank's shard over `mesh`; or,
    given `argv`, pixel DDPG at the env and agent fields train.main takes
    from it."""
    import torch

    from cartpoleplusplus_tpu_torch import agents
    from cartpoleplusplus_tpu_torch.env import CartPole3D
    from cartpoleplusplus_tpu_torch.physics.params import (
        CartPoleParams, continuous_params)

    cls, cfg_cls = {"ddpg": (agents.DDPG, agents.DDPGConfig),
                    "dqn": (agents.DQN, agents.DQNConfig),
                    "naf": (agents.NAF, agents.NAFConfig),
                    "lrpg": (agents.LRPG, agents.LRPGConfig)}[name]
    params = (continuous_params() if name in ("ddpg", "naf")
              else CartPoleParams())
    n = mesh.size if mesh is not None else 1
    dev = mesh.device if mesh is not None else torch.device("cuda", 0)
    pixels, config = {}, cfg_cls(**cfg)
    if argv is not None:
        render_config, config = _preset(argv)
        pixels = dict(obs_mode="pixels", render_config=render_config)
    env = CartPole3D(params, num_envs=num_envs // n, device=dev, **pixels)
    shard = dict(group=mesh, num_shards=n) if mesh is not None else {}
    return cls(env, config, spmd=spmd, **shard)


def _timed_steps(step, st, n, timed_collectives=False):
    """n train steps: (state, seconds per step by the host clock, the
    collectives' calls, bytes and seconds per step)."""
    import torch

    from cartpoleplusplus_tpu_torch.dist import STATS, reset_stats

    torch.cuda.synchronize()
    reset_stats(timed=timed_collectives)
    t0 = time.perf_counter()
    for _ in range(n):
        st, m = step(st)
    float(m["reward_mean"])
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / n
    per = {k: STATS[k] / n for k in ("calls", "bytes", "seconds")}
    reset_stats()
    return st, secs, per


def _dist_worker(spec_path: str, rank: int) -> int:
    """One rank of phase 29 (run as `chip_smoke.py --dist-rank SPEC RANK`
    by phase_distribution): joins the group, runs the spec's jobs with
    the launch counters zeroed around each, and saves its results."""
    import os

    import torch

    from cartpoleplusplus_tpu_torch.dist import (
        initialize_multihost, make_distributed_train_step, make_mesh,
        make_shardmap_train_step)

    spec = json.load(open(spec_path))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_multihost(spec["init"], spec["world"], rank,
                         backend=spec["backend"], device="cuda",
                         timeout_s=DIST_TIMEOUT_S)
    mesh = make_mesh()
    out = {}
    if spec.get("job") == "probe":
        # Which collectives gloo (or NCCL) takes on CUDA tensors.
        from cartpoleplusplus_tpu_torch.dist.mesh import gather_to_root

        x = torch.arange(4.0, device=mesh.device) + rank
        u = (torch.arange(4, device=mesh.device) * (rank + 1)).to(
            torch.uint8)

        def reduce_uint8():
            w = u.clone()
            torch.distributed.all_reduce(w)
            want = sum(torch.arange(4) * (r + 1) for r in range(mesh.size))
            assert torch.equal(w.cpu(), want.to(torch.uint8)), w

        def gather():
            got = gather_to_root(x, mesh)
            want = torch.cat([torch.arange(4.0) + r
                              for r in range(mesh.size)])
            assert (got is None) == (rank != 0)
            assert got is None or torch.equal(got, want), got

        res = {}
        for name, fn in (("all_reduce", lambda: torch.distributed
                          .all_reduce(x.clone())),
                         ("all_reduce_uint8", reduce_uint8),
                         ("all_gather", lambda: torch.distributed.all_gather(
                             [torch.empty_like(x) for _ in
                              range(mesh.size)], x)),
                         ("gather_to_root", gather)):
            try:
                fn()
                torch.cuda.synchronize()
                res[name] = "ok"
            except Exception as e:  # reported, and the phase decides
                res[name] = f"{type(e).__name__}: {e}"[:200]
        if spec["backend"] == "nccl":
            # One rank: the sum and the gather of one tensor are the tensor.
            y = torch.randn(1 << 20, device=mesh.device)
            w, g = y.clone(), [torch.empty_like(y)]
            torch.distributed.all_reduce(w)
            torch.distributed.all_gather(g, y)
            torch.cuda.synchronize()
            res["exact"] = bool(torch.equal(w, y) and torch.equal(g[0], y))
            t0 = time.perf_counter()
            for _ in range(20):
                torch.distributed.all_reduce(w)
            torch.cuda.synchronize()
            res["all_reduce_4MiB_ms"] = (time.perf_counter() - t0) / 20 * 1e3
        out = res
    else:
        _zero_counts()
        for job in spec["jobs"]:
            name, spmd = job["agent"], job["learner"] == "spmd"
            agent = _dist_agent(name, job["envs"], mesh, spmd,
                                job.get("argv"), **job["cfg"])
            st = agent.init(0)
            make = (make_distributed_train_step if spmd
                    else make_shardmap_train_step)
            step = make(agent, mesh)
            _zero_counts()
            for _ in range(job["steps"]):
                st, m = step(st)
            torch.cuda.synchronize()
            res = {"digest": _state_digest(st), "launches": _read_counts(),
                   "metrics": {k: float(v) for k, v in m.items()}}
            if job.get("time"):
                st, res["step_s"], _ = _timed_steps(step, st,
                                                    DIST_TIME_STEPS)
                st, res["timed_step_s"], res["collectives"] = _timed_steps(
                    step, st, DIST_TIME_STEPS, timed_collectives=True)
            out[job["tag"]] = res
            del st, agent, step
            torch.cuda.empty_cache()
    torch.save(out, os.path.join(spec["out"], f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def _spawn_ranks(tmp, tag, spec):
    """Run phase 29's ranks (this script with --dist-rank) and return
    their results; any rank that fails or outlives the timeout fails the
    phase (every rank is killed first)."""
    import os

    import torch

    out = os.path.join(tmp, tag)
    os.makedirs(out)
    spec = dict(spec, out=out, init=f"file://{out}/rendezvous")
    path = os.path.join(out, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, WORLD_SIZE=str(spec["world"]),
               LOCAL_WORLD_SIZE=str(spec["world"]))
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--dist-rank", path, str(r)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(spec["world"])]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DIST_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{tag} rank {r} exit {p.returncode}:\n" \
            f"{log[-4000:]}"
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(spec["world"])]


def phase_distribution(dev) -> dict:
    """Phase 29 (see the module docstring): returns the per-rank launches
    of each sharded path."""
    import tempfile

    import torch

    card = _card()
    tmp = tempfile.mkdtemp(prefix="cp_dist_")
    pre = presample_times(dev)
    print(f"presample (DDPG defaults: {N_ENVS} envs, ring 1024, K 16, "
          f"batch 256; card {card}), ms: {json.dumps(pre)}", flush=True)
    probe = _spawn_ranks(tmp, "probe", dict(world=2, backend="gloo",
                                            job="probe"))
    print(f"dist: gloo on cuda tensors, 2 ranks on cuda:0: "
          f"{json.dumps(probe)}", flush=True)
    assert all(v == "ok" for r in probe for v in r.values()), probe

    # One process at 8192 envs: the SPMD learner's reference and the
    # 1-process step time.
    agent = _dist_agent("ddpg", DIST_ENVS)
    st = agent.init(0)
    step = functools.partial(agent.train_step)
    _zero_counts()
    for _ in range(DIST_CHECK_STEPS):
        st, m = step(st)
    one_launches = _read_counts()
    want = _state_digest(st)
    st, one_s, _ = _timed_steps(step, st, DIST_TIME_STEPS)
    del st, agent, step
    torch.cuda.empty_cache()
    assert one_launches["B2"] == DIST_CHECK_STEPS and \
        one_launches["B3"] == DIST_CHECK_STEPS - 1, one_launches

    jobs = [dict(tag="spmd", agent="ddpg", learner="spmd", envs=DIST_ENVS,
                 steps=DIST_CHECK_STEPS, cfg={}, time=True),
            dict(tag="shardmap", agent="ddpg", learner="shardmap",
                 envs=DIST_ENVS, steps=DIST_CHECK_STEPS, cfg={}, time=True),
            dict(tag="dqn", agent="dqn", learner="shardmap",
                 envs=DIST_AGENT_ENVS, steps=DIST_AGENT_STEPS, cfg={}),
            dict(tag="naf", agent="naf", learner="shardmap",
                 envs=DIST_AGENT_ENVS, steps=DIST_AGENT_STEPS,
                 cfg={"learner": "kernel"}),
            dict(tag="lrpg", agent="lrpg", learner="shardmap",
                 envs=DIST_AGENT_ENVS, steps=DIST_AGENT_STEPS, cfg={}),
            dict(tag="pixel", agent="ddpg", learner="shardmap",
                 envs=PIX_ENVS, steps=DIST_PIXEL_STEPS, cfg={},
                 argv=DIST_PIXEL_ARGV)]
    t0 = time.perf_counter()
    ranks = _spawn_ranks(tmp, "ranks", dict(world=2, backend="gloo",
                                            jobs=jobs))
    ranks_s = time.perf_counter() - t0

    # SPMD: the ranks' shards concatenated equal one process, bit for bit.
    spmd = [r["spmd"] for r in ranks]
    got = dict(spmd[0]["digest"])
    for key in ("env_state", "obs", "noise", "replay"):
        got[key] = _cat_digest([r["digest"][key] for r in spmd])
    diff = _trees_equal(got, want)
    err = _digest_err(got, want)
    print(f"dist spmd ddpg 2 ranks x 4096 vs 1 process x 8192, "
          f"{DIST_CHECK_STEPS} steps: {len(diff)} fields differ "
          f"(max abs err {err:.3g}); launches per rank "
          f"{[r['launches'] for r in spmd]}", flush=True)
    assert not diff, f"SPMD differs from one process at {diff[:10]}"

    per_rank = {}
    for tag, want_k in (("spmd", dict(B2=DIST_CHECK_STEPS,
                                      B3=DIST_CHECK_STEPS - 1)),
                        ("shardmap", dict(B2=DIST_CHECK_STEPS,
                                          B3=DIST_CHECK_STEPS - 1)),
                        ("dqn", dict(B4=DIST_AGENT_STEPS,
                                     B5=DIST_AGENT_STEPS - 1)),
                        ("naf", dict(B6=DIST_AGENT_STEPS,
                                     B7=DIST_AGENT_STEPS - 1)),
                        ("lrpg", dict(B8=DIST_AGENT_STEPS,
                                      B9=DIST_AGENT_STEPS)),
                        # Counted from after init: the cached reset frame,
                        # then one launch per env.step.
                        ("pixel", dict(B10=1 + DIST_PIXEL_STEPS * 8))):
        rs = [r[tag] for r in ranks]
        for r in rs:
            assert _only(r["launches"], **want_k), (tag, r["launches"])
            for v in r["metrics"].values():
                assert math.isfinite(v), (tag, r["metrics"])
        # Replicated fields (everything but the env-shaped ones) equal.
        rep = [{k: v for k, v in r["digest"].items()
                if k not in ("env_state", "obs", "noise", "replay")}
               for r in rs]
        diff = _trees_equal(rep[1], rep[0])
        assert not diff, f"{tag}: ranks differ at {diff[:10]}"
        per_rank[tag] = rs[0]["launches"]
        print(f"dist {tag}: ranks bit-identical; launches per rank "
              f"{rs[0]['launches']}; metrics {json.dumps(rs[0]['metrics'])}",
              flush=True)

    timing = {}
    for tag in ("spmd", "shardmap"):
        rs = [r[tag] for r in ranks]
        timing[tag] = dict(
            step_ms=[r["step_s"] * 1e3 for r in rs],
            timed_step_ms=[r["timed_step_s"] * 1e3 for r in rs],
            collective_ms=[r["collectives"]["seconds"] * 1e3 for r in rs],
            collective_calls=rs[0]["collectives"]["calls"],
            collective_bytes=rs[0]["collectives"]["bytes"])
    print(f"dist timing (DDPG defaults, 8192 global envs; card {card}): "
          f"1 process {one_s * 1e3:.4f} ms per train step; "
          f"{json.dumps(timing)}; the 2-rank spawn {ranks_s:.1f} s",
          flush=True)

    nccl = _spawn_ranks(tmp, "nccl", dict(world=1, backend="nccl",
                                          job="probe"))[0]
    print(f"dist nccl 1 rank: {json.dumps(nccl)}", flush=True)
    assert all(nccl[k] == "ok" for k in ("all_reduce", "all_reduce_uint8",
                                         "all_gather", "gather_to_root")), \
        nccl
    assert nccl["exact"], nccl
    return {"per_rank": per_rank, "timing": timing, "one_ms": one_s * 1e3,
            "presample_ms": pre}


PRESAMPLE_REPS = 50


def presample_times(dev) -> dict:
    """Milliseconds (host clock, the card synchronised; median of
    PRESAMPLE_REPS) of one presample of K minibatches at the DDPG
    defaults (4096 envs, ring 1024 per env, K 16, batch 256) from a full
    ring, per sample mode, the CPU draw included as on the train path."""
    import torch

    from cartpoleplusplus_tpu_torch import agents
    from cartpoleplusplus_tpu_torch.env import CartPole3D
    from cartpoleplusplus_tpu_torch.physics.params import continuous_params

    agent = agents.DDPG(CartPole3D(continuous_params(), num_envs=N_ENVS,
                                   device=dev), agents.DDPGConfig())
    cfg, rb = agent.cfg, agent.replay
    rs = agent.init(0).replay
    rs = rs._replace(filled=rb.capacity, cursor=0)
    gen = torch.Generator().manual_seed(0)
    out = {}
    for mode, fn in (("column", rb.presample_columns),
                     ("block", rb.presample_block),
                     ("uniform", rb.presample_uniform)):
        times = []
        for _ in range(PRESAMPLE_REPS + 3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(rs, cfg.batch_size, cfg.updates_per_step, generator=gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[mode] = statistics.median(times[3:])
    return out


def _cat_digest(parts):
    """Rank digests' env-shaped tensors concatenated in rank order."""
    import torch

    a = parts[0]
    if isinstance(a, dict):
        return {k: _cat_digest([p[k] for p in parts]) for k in a}
    if isinstance(a, list):
        return [_cat_digest([p[i] for p in parts]) for i in range(len(a))]
    if isinstance(a, torch.Tensor) and a.ndim >= 1:
        return torch.cat(parts)
    return a


def _digest_err(a, b) -> float:
    """The largest absolute float difference between two digest trees."""
    import torch

    if isinstance(a, dict):
        return max([_digest_err(a[k], b[k]) for k in a] or [0.0])
    if isinstance(a, (list, tuple)):
        return max([_digest_err(x, y) for x, y in zip(a, b)] or [0.0])
    if isinstance(a, torch.Tensor) and a.is_floating_point():
        return float((a - b).abs().max()) if a.numel() else 0.0
    return 0.0


BF16_STEPS = 3           # phase 30: train steps of each agent at bfloat16
BF16_PIXEL_STEPS = 2     # and of pixel DDPG
BF16_ROUNDS = 2          # timing rounds, the configs in turns
BF16_ROWS = 4096         # rows of the card-vs-CPU forward comparison
BF16_ROLLOUT = {"ddpg": "B2", "dqn": "B4", "naf": "B6", "lrpg": "B8"}
BF16_LEARNER = {"ddpg": "B3", "dqn": "B5", "naf": "B7", "lrpg": "B9"}
BF16_NETS = ("actor", "critic", "qnet", "policy", "naf", "visual_actor",
             "visual_critic", "visual_qnet", "visual_policy", "visual_naf")


def _build(argv):
    """(env, agent) as train.main builds them from `argv`."""
    from cartpoleplusplus_tpu_torch import train
    from cartpoleplusplus_tpu_torch.config import RunConfig, from_args

    args = train.build_parser().parse_args(argv)
    return train.build(from_args(RunConfig, args), args, set())


def _float32_state(st) -> bool:
    """Whether every parameter and Adam moment of an agent state is
    float32."""
    import torch

    ok = True
    for v in st._asdict().values():
        if isinstance(v, torch.nn.Module):
            ok &= all(p.dtype == torch.float32 for p in v.parameters())
        elif hasattr(v, "mu") and hasattr(v, "nu"):
            ok &= all(x.dtype == torch.float32 for x in v.mu + v.nu)
    return ok


def _steps_ms(agent, st, n):
    """n train steps: (state, last metrics, ms per step by the host clock
    with the card synchronised)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        st, m = agent.train_step(st)
    torch.cuda.synchronize()
    return st, m, (time.perf_counter() - t0) / n * 1e3


def _preset(argv):
    """(RenderConfig, DDPGConfig) that train.main builds from `argv`."""
    from cartpoleplusplus_tpu_torch import train
    from cartpoleplusplus_tpu_torch.agents import DDPGConfig
    from cartpoleplusplus_tpu_torch.config import RunConfig, from_args

    args = train.build_parser().parse_args(argv)
    return (train.pixel_render_config(from_args(RunConfig, args)),
            from_args(DDPGConfig, args, prefix="ddpg."))


def _bf16_frames(dev, n):
    """n uint8 frames of the pixels preset's env (PIXEL_ARGV) after 3
    env-steps of random actions (B10 renders them)."""
    import torch

    from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams

    env = CartPole3D(CartPoleParams(), num_envs=n, obs_mode="pixels",
                     device=dev, render_config=_preset(PIXEL_ARGV)[0])
    st, _ = env.reset(0)
    g = torch.Generator().manual_seed(0)
    for _ in range(3):
        a = torch.randint(0, 5, (n,), generator=g, dtype=torch.int32)
        st, obs, *_ = env.step(st, a.to(dev))
    return obs


def phase_bfloat16_agents(dev) -> dict:
    """Phase 30 (`--bf16-only` runs it alone): every agent at its CLI
    defaults with `--<agent>.dtype bfloat16` for BF16_STEPS train steps
    (pixel DDPG at the pixels preset's fields for BF16_PIXEL_STEPS) with
    the counters zeroed: the rollout kernel (B2, B4, B6, B8; B10 for
    pixels) launches from the float32 weights, no learner kernel does,
    parameters and Adam moments stay float32, metrics finite. Then the
    train step's ms at bfloat16 (the plain learner) beside float32's on
    the plain and on the kernel learner, in turns; then each bfloat16
    net's forward on the card against the CPU at BF16_ROWS rows, end to
    end (bf16_parity.card_vs_cpu): the state nets inside
    bf16_parity.TIGHT, the pixel nets inside bf16_parity.PIXEL_CARD, and
    each net with the fault planted outside its bar."""
    import torch

    from cartpoleplusplus_tpu_torch.utils import bf16_parity as bp

    card = _card()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    launches, times = {}, {}
    for name in ("ddpg", "dqn", "naf", "lrpg"):
        base = ["--agent", name, "--seed", "0"]
        configs = {"bfloat16": [f"--{name}.dtype", "bfloat16"],
                   "float32 plain": [f"--{name}.learner", "xla"],
                   "float32 kernel": [f"--{name}.learner", "kernel"]}
        built = {}
        for label, extra in configs.items():
            env, agent = _build(base + extra)
            st = agent.init(0)
            if label == "bfloat16":
                assert not agent.kernel_mode and agent.kernel_rollout
                _zero_counts()
                st, m, _ = _steps_ms(agent, st, BF16_STEPS)
                torch.cuda.synchronize()
                launches[name] = _read_counts()
                want = {BF16_ROLLOUT[name]: BF16_STEPS}
                assert _only(launches[name], **want), (name, launches[name])
                assert _float32_state(st), f"{name}: non-float32 state"
                assert all(math.isfinite(float(v)) for v in m.values()), m
                assert m["learner_impl"] == 0.0 and m["rollout_impl"] == 1.0
            else:
                st, m, _ = _steps_ms(agent, st, BF16_STEPS)
            built[label] = [agent, st]
        ms = {label: [] for label in configs}
        for _ in range(BF16_ROUNDS):
            for label, pair in built.items():
                pair[1], _, t = _steps_ms(pair[0], pair[1], 1)
                ms[label].append(t)
        times[name] = ms
        print(f"bfloat16 {name} (CLI defaults, {N_ENVS} envs; card {card}): "
              f"{BF16_STEPS} train steps launch {launches[name]}; "
              f"parameters and Adam moments float32; train step ms in "
              f"turns: {json.dumps(ms)}", flush=True)
        del built, env, agent, st
        torch.cuda.empty_cache()

    built, pix = {}, {}
    for label, extra in (("bfloat16", ["--ddpg.dtype", "bfloat16"]),
                         ("float32", [])):
        env, agent = _build(PIXEL_ARGV + extra + ["--seed", "0"])
        st = agent.init(0)
        _zero_counts()
        st, m, _ = _steps_ms(agent, st, BF16_PIXEL_STEPS)
        pix[label] = _read_counts()
        assert _only(pix[label], B10=1 + BF16_PIXEL_STEPS * 8), pix[label]
        assert _float32_state(st) and all(
            math.isfinite(float(v)) for v in m.values()), m
        built[label] = [agent, st]
    launches["pixel ddpg"] = pix["bfloat16"]
    ms = {label: [] for label in built}
    for _ in range(BF16_ROUNDS):
        for label, pair in built.items():
            pair[1], _, t = _steps_ms(pair[0], pair[1], 1)
            ms[label].append(t)
    times["pixel ddpg"] = ms
    print(f"bfloat16 pixel ddpg (pixels preset fields, {PIX_ENVS} envs, "
          f"{PIX_SIZE} x {PIX_SIZE}; card {card}): {BF16_PIXEL_STEPS} train "
          f"steps launch {pix['bfloat16']} (float32 {pix['float32']}: B10 "
          f"once per env.step and once for the cached reset frame); train "
          f"step ms in turns: {json.dumps(ms)}", flush=True)
    del built, env, agent, st
    torch.cuda.empty_cache()

    frames = _bf16_frames(dev, BF16_ROWS)
    forward = {}
    for name in BF16_NETS:
        ends, bar, faults = bp.card_vs_cpu(name, dev, frames, BF16_ROWS)
        naf = name.endswith("naf")
        forward[name] = dict(ulps=[u for u, _ in ends],
                             off=[o for _, o in ends],
                             fault_ulps=[u for u, _ in faults],
                             fault_off=[o for _, o in faults])

        def show(errs):
            return (f"max err {', '.join(f'{u:.3f}' for u, _ in errs)} "
                    f"bfloat16 ulps of the magnitude, elements off "
                    f"{', '.join(f'{o:.5f}' for _, o in errs)}")

        print(f"bfloat16 {name} forward, card vs CPU ({BF16_ROWS} rows, "
              f"(256, 256), weights perturbed"
              f"{', conv encoder on B10 frames' if 'visual' in name else ''}"
              f"): per output {show(ends)} (bar {bar[0]} ulps, {bar[1]}); "
              f"with the fused-bias fault planted on the card "
              f"{show(faults)}", flush=True)
        assert bp.within(ends, bar, naf), (name, ends)
        assert not bp.within(faults, bar, naf), (name, faults)
    del frames
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": times, "forward": forward}


def phase_tools(dev) -> dict:
    """Phase 31: the gym adapter's episode on the card to termination and
    one render() (B10); params_from_urdf from an edited copy of the
    bodies through B1 at N_ENVS x B1_STEPS against its twin, apart from
    the defaults' run; checked_step clean over 8 steps, then raising on a
    NaN-corrupted state; measure_env_steps_per_sec at N_ENVS x
    HARNESS_STEPS; a
    2-point sweep of a tiny DQN run, and the plot of its results where
    matplotlib is installed."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from cartpoleplusplus_tpu_torch import CartPole3D, CartPoleParams
    from cartpoleplusplus_tpu_torch import plot, sweep
    from cartpoleplusplus_tpu_torch.bench.harness import (
        measure_env_steps_per_sec)
    from cartpoleplusplus_tpu_torch.env.gym_adapter import GymCartPole3D
    from cartpoleplusplus_tpu_torch.ops.fused_rollout import (
        fused_rollout, reference_rollout)
    from cartpoleplusplus_tpu_torch.physics import urdf
    from cartpoleplusplus_tpu_torch.utils.checks import checked_step

    card = _card()
    out = {}
    # The gym adapter: an episode to termination, one render through B10.
    gym = GymCartPole3D(seed=3)
    assert gym._env.device.type == "cuda"
    gym.reset()
    rng = np.random.RandomState(0)
    _zero_counts()
    t0 = time.perf_counter()
    for steps in range(1, 301):
        _, reward, done, info = gym.step(gym.action_space.sample(rng))
        if done:
            break
    gym_s = time.perf_counter() - t0
    assert done and steps <= 200, steps
    img = gym.render()
    counts = _read_counts()
    assert _only(counts, B10=1), counts
    assert img.dtype == np.uint8 and img.shape == (PIX_SIZE, PIX_SIZE, 3)
    print(f"gym adapter on the card: an episode of {steps} steps to "
          f"termination ({gym_s / steps * 1e3:.3f} ms per step, host clock); "
          f"render() {img.shape} uint8 through B10 (launches {counts})",
          flush=True)

    # URDF: an edited pole through B1 against its twin.
    tmp = tempfile.mkdtemp(prefix="cp_tools_")
    for f in ("cart.urdf", "pole.urdf", "ground.urdf"):
        shutil.copy(os.path.join(urdf.DEFAULT_ASSET_DIR, f), tmp)
    path = os.path.join(tmp, "pole.urdf")
    text = open(path).read()
    assert 'length="1.0"' in text
    open(path, "w").write(text.replace('length="1.0"', 'length="1.5"'))
    p = urdf.params_from_urdf(tmp)
    assert p.pole_length == 1.5 and p != CartPoleParams()
    finals = {}
    for label, params in (("edited", p), ("defaults", CartPoleParams())):
        env = CartPole3D(params, num_envs=N_ENVS, device=dev)
        state, _ = env.reset(7)
        _zero_counts()
        ks, kc = fused_rollout(env, state, B1_STEPS)
        assert _read_counts()["B1"] == 1
        rs, rc = reference_rollout(env, state, B1_STEPS)
        errs = [_close(f"B1 urdf {label} {k}", getattr(ks.phys, k),
                       getattr(rs.phys, k), tol, tol)
                for k, tol in (("pos", 2e-5), ("s", 2e-5), ("vel", 5e-4),
                               ("sd", 5e-4))]
        assert bool((ks.steps == rs.steps).all())
        assert bool((ks.episode == rs.episode).all())
        finals[label] = (ks, errs)
    moved = float((finals["edited"][0].phys.s
                   - finals["defaults"][0].phys.s).abs().max())
    assert moved > 0.0, "the edited pole ran the defaults' physics"
    out["urdf_errs"] = finals["edited"][1]
    print(f"params_from_urdf (pole length 1.0 -> 1.5 in a copy of "
          f"pole.urdf) through B1 at {N_ENVS} x {B1_STEPS}: max abs err "
          f"pos/s/vel/sd {' '.join(f'{e:.3g}' for e in finals['edited'][1])}"
          f" against its twin; the defaults' run "
          f"{' '.join(f'{e:.3g}' for e in finals['defaults'][1])}; final "
          f"tilts part from the defaults' by up to {moved:.4g}", flush=True)

    # checked_step: clean, then a NaN position.
    env = CartPole3D(CartPoleParams(), num_envs=N_ENVS, device=dev)
    step = checked_step(env)
    st, _ = env.reset(0)
    a = torch.zeros(N_ENVS, dtype=torch.int32, device=dev)
    for _ in range(8):
        err, (st, obs, reward, done, info) = step(st, a)
        err.throw()
    # A fresh state with one NaN (a corrupted env that terminates would be
    # auto-reset clean in the same step).
    st, _ = env.reset(1)
    pos = st.phys.pos.clone()
    pos[0, 0] = float("nan")
    err, _ = step(st._replace(phys=st.phys._replace(pos=pos)), a)
    assert err.get() == "non-finite pos in EnvState", err.get()
    try:
        err.throw()
        raise AssertionError("checked_step did not raise")
    except ValueError as e:
        assert "non-finite pos" in str(e)
    print(f"checked_step at {N_ENVS} envs: 8 clean steps, then "
          f"'{err.get()}' raised on a NaN position", flush=True)

    # The throughput harness (the plain env.step loop, no kernel).
    env = CartPole3D(CartPoleParams(), num_envs=N_ENVS, device=dev)
    _zero_counts()
    rate = measure_env_steps_per_sec(env, num_steps=HARNESS_STEPS,
                                     repeats=1)
    assert _only(_read_counts()), _read_counts()
    assert math.isfinite(rate["checksum"])
    out["harness"] = rate
    print(f"measure_env_steps_per_sec ({N_ENVS} envs x {HARNESS_STEPS} "
          f"steps of the "
          f"plain env.step, best of 1 after a warm-up; card {card}): "
          f"{rate['env_steps_per_sec']:.6g} env-steps/s, "
          f"{rate['best_seconds']:.4f} s; backend {rate['backend']}",
          flush=True)

    # A 2-point sweep of a tiny DQN run and its plot.
    res = os.path.join(tmp, "sweep.jsonl")
    _zero_counts()
    with contextlib.redirect_stderr(io.StringIO()):
        rc = sweep.main([
            "--out", res, "--base",
            "--agent dqn --num-envs 256 --total-env-steps 32 "
            "--log-interval 1 --dqn.hidden 32 32 "
            "--dqn.replay-capacity-per-env 64", "--grid", "seed=0,1"])
    recs = [json.loads(x) for x in open(res)]
    counts = _read_counts()
    assert rc == 0 and len(recs) == 2 and all(
        r["rc"] == 0 and r["final"] for r in recs), recs
    assert counts["B4"] == 2 * 4 and counts["B5"] == 2 * 3, counts
    try:
        import matplotlib  # noqa: F401  (plot's only dependency)
    except ImportError:
        plotted = "plot not run: matplotlib is not installed here"
    else:
        png = os.path.join(tmp, "sweep.png")
        with contextlib.redirect_stdout(io.StringIO()):
            assert plot.main([res, "--sweep", "--key", "final.loss",
                              "--out", png]) == 0
        assert open(png, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
        plotted = f"plot wrote {os.path.getsize(png)} bytes of PNG"
    print(f"sweep: 2 points of a tiny DQN run on the card (launches "
          f"{counts}), final losses "
          f"{[r['final']['loss'] for r in recs]}; {plotted}", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return out


# The product modes of the learners besides float32 (learner_precision),
# and the reference's bar for its bfloat16 kernel learner against its
# float32 plain learner (tests/test_learner_kernel.py:545-578).
PRECISION_MODES = ("bfloat16", "tensorfloat32", "BF16_BF16_F32_X3",
                   "BF16_BF16_F32_X6", "F64_F64_F64", "F16_F16_F16")
REF_RTOL, REF_ATOL = 2e-2, 2e-3
_X3, _X6, _F64 = "BF16_BF16_F32_X3", "BF16_BF16_F32_X6", "F64_F64_F64"
# The modes whose results lie within a tight bar of float32's, so that the
# float32 kernel does not lie past their share: the product probe shows
# them live (_product_probe), and _mode_holds requires bits other than
# float32's.
PROBED_MODES = ("BF16_BF16_F32_X3", "BF16_BF16_F32_X6", "F64_F64_F64")
# The card's peak for each mode's products, from the H100 SXM's published
# dense rates (NVIDIA's data sheet): the tensor cores' for the operand
# type (bfloat16's for X3's and X6's bfloat16 part products, 3 and 6 per
# product, and for float16; TF32's; IEEE float64's DMMA at F64), float32's
# outside the tensor cores at float32. The other operations (LayerNorm,
# softmax, Adam) are float32 at every mode. The chain bound beside it is
# the rate of the units the kernels use: FFMA, and DFMA (34 TFLOP/s) at
# F64.
MODE_PEAK = {"float32": F32_FLOPS, "bfloat16": 989e12,
             "tensorfloat32": 495e12, "BF16_BF16_F32_X3": 989e12,
             "BF16_BF16_F32_X6": 989e12, "F64_F64_F64": 67e12,
             "F16_F16_F16": 989e12}
MODE_PASSES = {"BF16_BF16_F32_X3": 3, "BF16_BF16_F32_X6": 6}
DFMA_FLOPS = 34e12
# The modes whose products lie within float32's rounding of float32's (X6
# keeps all 24 bits of each operand, F64 rounds its exact sum once): a
# LayerNorm output within that rounding of the relu edge falls either way
# between the twin at the mode and the float32 twin, so the kernel is held
# to the nearer of the two, tensor by tensor (PERF.md §6: B3 K 1's
# critic, one output at 2.1e-7).
NEAR_F32_MODES = ("BF16_BF16_F32_X6", "F64_F64_F64")
# The relative part of the one-update normwise bar per mode: B3's, and at
# F16 one float16 step (2^-10), since a float32 sum in another order may
# round a dot to the neighbouring float16.
ONE_UPDATE_RTOL = {p: B3_RTOL for p in PRECISION_MODES}
ONE_UPDATE_RTOL["F16_F16_F16"] = 2.0 ** -10
# The fast preset's B3 shape (rollout 64, K 8, batch 8192).
B3_FAST_BATCH, B3_FAST_K = 8192, 8
# B9's window besides the defaults' 131,072 rows.
B9_SMALL_N = 1000
# A CLI run at each of the other legacy values: envs and train steps.
PRECISION_CLI_ENVS, PRECISION_CLI_STEPS = 1000, 3
# The share of all the elements that a reduced-mode learner may have past
# B3's elementwise bar against its twin at the same mode, where the float32
# kernel against that twin must have more (_mode_holds; PERF.md §6 has the
# readings behind each): after one update (B9: its one window), B3 after
# K 16 at batch 256 (per mode) and after K 8 at batch 8192, B5 and B7
# after K 8.
ONE_UPDATE_SHARE = {p: 1e-5 for p in PRECISION_MODES}
ONE_UPDATE_SHARE["F16_F16_F16"] = 3e-4
B3_K_SHARE = {"bfloat16": 0.15, "tensorfloat32": 0.06,
              "BF16_BF16_F32_X3": 1e-5, "BF16_BF16_F32_X6": 1e-5,
              "F64_F64_F64": 1e-5, "F16_F16_F16": 0.075}
B3_FAST_SHARE = {"bfloat16": 0.02, "tensorfloat32": 0.02,
                 "BF16_BF16_F32_X3": 1e-4, "BF16_BF16_F32_X6": 1e-5,
                 "F64_F64_F64": 1e-5, "F16_F16_F16": 0.01}
ROW_CHAIN_K_SHARE = 0.0


# That each of X3, X6 and F64 launched its own instance, after one update
# (_mode_identity): X3's kernel lies nearest its own twin, and each other
# kernel nearer another twin than X3's, by a factor of IDENTITY_X3 at
# least; against the nearer of the float32 and F64 twins, F64's kernel
# lies nearer than float32's and float32's nearer than X6's (one rounding
# a product against six) by IDENTITY_ORDER at least. Distances in ulps of
# the twin, each element's capped at ULP_CAP. PERF.md §6 has the readings
# (factors 1.83-4.2 and 1.45-22 at phase 32's one-update cases).
IDENTITY_X3, IDENTITY_ORDER, ULP_CAP = 1.4, 1.2, 64


def _flat_run(groups, losses) -> list:
    return [x for g in groups for x in g] + list(losses)


def _beyond(got, want, rtol=B3_RTOL, atol=B3_ATOL) -> int:
    """Elements of the tensor lists outside the bar."""
    import torch

    return sum(int((~torch.isclose(a, b, rtol=rtol, atol=atol)).sum())
               for a, b in zip(got, want))


def _ulps(got, want) -> float:
    """The mean distance of the tensor list `got` from `want` over all the
    elements, in ulps of want's element (float32), each element's capped
    at ULP_CAP: a LayerNorm output that falls the other way at the relu
    edge moves some elements far, and the cap keeps them from outweighing
    the rest."""
    import torch

    total, n = 0.0, 0
    for a, b in zip(got, want):
        mag = b.abs()
        ulp = torch.nextafter(mag, torch.full_like(mag, math.inf)) - mag
        total += float(((a.double() - b.double()).abs() / ulp.double())
                       .clamp(max=ULP_CAP).sum())
        n += a.numel()
    return total / n


def _mode_identity(tag, run, twin) -> dict:
    """That each of X3, X6 and F64 launched its own instance (see
    IDENTITY_X3): run(p) and twin(p) as in _mode_holds, after one update.
    X6 and F64 lie within float32's rounding of float32, so no twin of
    theirs is nearest their kernel in every case (a LayerNorm output at
    the relu edge falls the other way in B3's twins at X6 and F64; at B9's
    131,072 rows the X6 kernel lies nearer the F64 twin): they are told
    apart by their error against the nearer of the float32 and F64 twins,
    the F64 kernel's least (exact dots, rounded once), the X6 kernel's
    most (six roundings a product). Returns the distances."""
    modes = (None, _X3, _X6, _F64)
    got = {p: _flat_run(*run(p)) for p in modes}
    want = {q: _flat_run(*twin(q)) for q in modes}
    d = {p: {q: _ulps(got[p], want[q]) for q in modes} for p in modes}
    err = {p: min(d[p][None], d[p][_F64]) for p in modes}
    names = {p: p or "float32" for p in modes}
    table = {names[p]: {names[q]: v for q, v in d[p].items()} for p in modes}
    nearest_other = min(v for q, v in d[_X3].items() if q != _X3)
    assert d[_X3][_X3] * IDENTITY_X3 <= nearest_other, \
        f"{tag}: the X3 kernel not nearest its own twin (ulps): {table}"
    for p in (None, _X6, _F64):
        assert min(v for q, v in d[p].items() if q != _X3) * IDENTITY_X3 \
            <= d[p][_X3], f"{tag}: the {names[p]} kernel near the X3 " \
                          f"twin (ulps): {table}"
    assert err[_F64] * IDENTITY_ORDER <= err[None] and \
        err[None] * IDENTITY_ORDER <= err[_X6], \
        f"{tag}: the F64, float32 and X6 kernels' ulps from the nearer " \
        f"of the float32 and F64 twins out of order: " \
        f"{[err[p] for p in (_F64, None, _X6)]}; {table}"
    print(f"{tag}: identity, the kernel at each mode against the twin at "
          f"each (float32, X3, X6, F64; mean ulps, each capped at "
          f"{ULP_CAP}): " + "; ".join(
              f"{names[p]} " + " ".join(f"{v:.4g}" for v in d[p].values())
              for p in modes)
          + f"; from the nearer of the float32 and F64 twins: F64 "
          f"{err[_F64]:.4g}, float32 {err[None]:.4g}, X6 {err[_X6]:.4g}",
          flush=True)
    return dict(ulps=table, err={names[p]: err[p] for p in modes})


def _mode_holds(tag, run, twin, nets, one_update, share,
                modes=PRECISION_MODES) -> dict:
    """A learner kernel at the product modes. run(p) and twin(p) give (the
    groups' parameter lists, the losses) of the kernel (synchronised) and
    of its twin at learner_precision p; the first `nets` groups are the
    networks and targets, the rest Adam's moments. The float32 spellings
    ("float32", "highest", "F32_F32_F32") give the default's bits, and
    "BF16_BF16_F32" bfloat16's. At each other mode two runs give the same
    bits, and against the twin at that mode at most `share` (a number, or
    one for each mode) of all the elements lie past B3's elementwise bar,
    while the float32 kernel against the same twin has more past it than
    that limit (the check tells the modes apart: PERF.md §6 has the
    readings behind each share); at X3, X6 and F64, which lie within that
    bar of float32, the bits differ from float32's instead and the product
    probe tells the modes apart; at X6 and F64 the kernel is held to the
    nearer of the twin at its mode and the float32 twin (NEAR_F32_MODES),
    and at F16 one update normwise within a float16 step
    (ONE_UPDATE_RTOL). Where an ulp between
    two summation orders crosses a rounding edge, one term of a sum moves
    by a whole bfloat16 or TF32 step, so a few elements part: after one
    update (or B9's one window)
    each tensor stays normwise within B3's bar (max error <= B3_ATOL +
    B3_RTOL x its largest magnitude); after several, the weights differ by
    such steps and a few LayerNorm outputs flip at the relu edge, and the
    networks, targets and losses stay within the reference's bar (REF_RTOL
    / REF_ATOL). Returns each mode's max abs error and counts."""
    import torch

    base = _flat_run(*run(None))
    for p, same_as in (("float32", None), ("highest", None),
                       ("F32_F32_F32", None),
                       ("BF16_BF16_F32", "bfloat16")):
        want = base if same_as is None else _flat_run(*run(same_as))
        assert all(torch.equal(a, b) for a, b in zip(_flat_run(*run(p)),
                                                     want)), \
            f"{tag}: learner_precision={p!r} parts from {same_as}'s bits"
    out = {}
    twin32 = _flat_run(*twin(None))
    n_held = sum(len(g) for g in run(None)[0][:nets])
    for p in modes:
        want_g, want_l = twin(p)
        got_g, got_l = run(p)
        again = _flat_run(*run(p))
        got, want = _flat_run(got_g, got_l), _flat_run(want_g, want_l)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), \
            f"{tag} {p}: two runs on the same inputs differ"
        if p in NEAR_F32_MODES:
            want = [w if _max_err(g, w) <= _max_err(g, w32) else w32
                    for g, w, w32 in zip(got, want, twin32)]
        elements = sum(x.numel() for x in got)
        res = dict(beyond_tight=_beyond(got, want), elements=elements,
                   f32_beyond_tight=_beyond(base, want),
                   limit=int((share[p] if isinstance(share, dict)
                              else share) * elements))
        if p in PROBED_MODES:
            assert res["beyond_tight"] <= res["limit"], \
                f"{tag} {p}: elements past rtol {B3_RTOL}, atol {B3_ATOL} " \
                f"(the kernel, its limit): {res}"
            assert not all(torch.equal(a, b) for a, b in zip(got, base)), \
                f"{tag} {p}: the float32 kernel's bits"
        else:
            assert res["beyond_tight"] <= res["limit"] < \
                res["f32_beyond_tight"], \
                f"{tag} {p}: elements past rtol {B3_RTOL}, atol {B3_ATOL} " \
                f"(the kernel, its limit, the float32 kernel): {res}"
        if one_update:
            err = 0.0
            for i, (a, b) in enumerate(zip(got, want)):
                e, scale = _max_err(a, b), float(b.abs().max())
                assert e <= B3_ATOL + ONE_UPDATE_RTOL[p] * scale, \
                    f"{tag} {p} [{i}]: max abs err {e} at scale {scale}"
                err = max(err, e)
        else:
            n_loss = len(got_l)
            held = zip(got[:n_held] + got[-n_loss:],
                       want[:n_held] + want[-n_loss:])
            err = max(_close(f"{tag} {p} [{i}]", a, b, REF_RTOL, REF_ATOL)
                      for i, (a, b) in enumerate(held))
        out[p] = dict(res, max_abs_err=err)
    if one_update:
        out["identity"] = _mode_identity(tag, run, twin)
    print(f"{tag}: " + "; ".join(
        f"{p} max_abs_err {v['max_abs_err']:.3g} " + (
            f"(normwise rtol {ONE_UPDATE_RTOL[p]:.3g}, atol {B3_ATOL})"
            if one_update else
            f"(networks, targets, losses: rtol {REF_RTOL}, atol {REF_ATOL})")
        + f", {v['beyond_tight']} of {v['elements']} elements past rtol "
        f"{B3_RTOL}, atol {B3_ATOL} elementwise (limit {v['limit']}; the "
        f"float32 kernel {v['f32_beyond_tight']})"
        for p, v in out.items() if p in modes) + "; float32, highest, "
        "F32_F32_F32: the "
        "default's bits; BF16_BF16_F32: bfloat16's", flush=True)
    return out


def _mode_times(fn, reps, ffma=None, kernel="B9") -> tuple:
    """fn(p)'s CUDA-event ms at each product mode, in turns (float32, then
    each mode of PRECISION_MODES, then back): (mode -> [ms, ms], and with
    `ffma` (the CP_MM_FFMA library, _ffma_build) at each of `kernel`'s
    tensor-core modes (lk.TC_MODES_OF) the same call through it, the fmaf
    instance before the kernel's on the way out and after it on the way
    back: mode -> [ms, ms])."""
    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk

    order = (None,) + PRECISION_MODES
    out = {p or "float32": [] for p in order}
    ref = {}
    for way, seq in enumerate((order, order[::-1])):
        for p in seq:
            turns = (False,)
            if ffma is not None and lk.mm_mode(p) in lk.TC_MODES_OF[kernel]:
                turns = (True, False) if way == 0 else (False, True)
            for use_ffma in turns:
                if use_ffma:
                    with _use_library(ffma):
                        ref.setdefault(p, []).append(
                            _time_ms(lambda: fn(p), reps))
                else:
                    out[p or "float32"].append(_time_ms(lambda: fn(p), reps))
    return out, ref


def _mode_bounds(prod: float, rest: float, nbytes: float) -> dict:
    """Each product mode's bound for work of `prod` float32 product FLOPs
    (X3 and X6: 3 and 6 part products each) and `rest` other FLOPs: the
    larger of the bytes over the HBM rate and the operations over the
    card's peak for their type (MODE_PEAK; at a mode other than float32
    the tensor cores' products and the float32 units' rest run side by
    side, so the larger of the two); chain_ms, the same at the rate of the
    units the kernels use (FFMA; DFMA at F64)."""
    t_bytes = nbytes / HBM_BYTES * 1e3
    out = {}
    for p in ("float32",) + PRECISION_MODES:
        n = prod * MODE_PASSES.get(p, 1)
        if p == "float32":
            t_ops = (n + rest) / F32_FLOPS * 1e3
        else:
            t_ops = max(n / MODE_PEAK[p], rest / F32_FLOPS) * 1e3
        if p == "F64_F64_F64":
            t_chain = max(n / DFMA_FLOPS, rest / F32_FLOPS) * 1e3
        else:
            t_chain = (n + rest) / F32_FLOPS * 1e3
        out[p] = dict(bound_ms=max(t_ops, t_bytes),
                      bound_by="operations" if t_ops >= t_bytes else "bytes",
                      library_ms=None, chain_ms=max(t_chain, t_bytes))
    return out


def _times_line(times: dict, bounds: dict, ffma=None) -> str:
    def ms(ts):
        return " ".join(f"{t:.4f}" for t in ts)

    ffma = ffma or {}
    return ", ".join(f"{p} {ms(ts)}"
                     + (f" (fmaf instance {ms(ffma[p])})" if p in ffma
                        else "")
                     + f" (bound {bounds[p]['bound_ms']:.4f}, chain "
                     f"{bounds[p]['chain_ms']:.4f})"
                     for p, ts in times.items()) + \
        " ms (bounds at each mode's peak: float32 67, bfloat16, float16 " \
        "and X3's and X6's bfloat16 parts 989, TF32 495, F64 67 TFLOP/s; " \
        "chains: FFMA 67, DFMA 34 TFLOP/s; fmaf instance: the same sources " \
        "built with CP_MM_FFMA, in turns)"


# Planted faults, built and checked by `chip_smoke.py --plant-faults` (a
# one-off run, not part of the default one): each is (what it breaks,
# the patches (file in csrc/, text found once, its replacement), the
# sources built, the phase-32 cases and the modes checked, and whether
# the checks must catch it). The product helpers' (csrc/learner_stages.cuh),
# which the product probe must catch at their mode; then the learners'
# wiring, which _mode_holds must catch, and one it does not: a single
# float32 product site in B9's F64 instance (one of its eight) moves
# the kernel's error by less than the identity check resolves.
_ROW_CHAIN_SOURCES = tuple(f"{n}_update{u}.cu" for n in ("ddpg", "dqn", "naf")
                           for u in ("", "_x3x6", "_f64f16", "_wide"))
_B9_SOURCES = ("lrpg_update.cu", "lrpg_update_x3x6.cu",
               "lrpg_update_f64f16.cu")
PROBE_FAULTS = {
    "X3 without lo.hi": (_X3, (
        "learner_stages.cuh",
        "    acc = fmaf(a.lo, b.hi, acc);\n    acc = fmaf(a.hi, b.lo, acc);\n"
        "    return fmaf(a.hi, b.hi, acc);",
        "    acc = fmaf(a.hi, b.lo, acc);\n    return fmaf(a.hi, b.hi, acc);")),
    "X6 without mid.mid": (_X6, ("learner_stages.cuh",
                                 "    acc = fmaf(a.mid, b.mid, acc);\n", "")),
    "F64 with float32 accumulators": (_F64, (
        "learner_stages.cuh", "  using In = double;\n  using Acc = double;",
        "  using In = double;\n  using Acc = float;")),
}
# The tensor cores' fragment helpers' (csrc/learner_stages.cuh), which the
# tensor-core probe (_mma_probe) must catch at their mode.
MMA_PROBE_FAULTS = {
    "X3's lo parts of a pair swapped": (_X3, (
        "learner_stages.cuh", "    p[1] = cvt_bf16x2(r0, r1);",
        "    p[1] = cvt_bf16x2(r1, r0);")),
    "B's second k-block register from the first's inputs": ("bfloat16", (
        "learner_stages.cuh", "      s.pair(n0 + g, k0 + 2 * t + q * 8, p);",
        "      s.pair(n0 + g, k0 + 2 * t, p);")),
}
LEARNER_FAULTS = {
    "X6's and F64's instances swapped in CP_MM_INSTANCES": (
        [("learner_stages.cuh", "x3x6(kMmX6), f64f16(kMmF64)",
          "f64f16(kMmF64), x3x6(kMmX6)")], _ROW_CHAIN_SOURCES,
        ("B3 K 1 updated", "B5 K 1", "B7 K 1 clip 10.0"), (_X6, _F64),
        True),
    "B3's X3 accessor returning the X6 instance": (
        [("ddpg_update.cu",
          "(m == kMmX3)\n    return reinterpret_cast<const void*>("
          "ddpg_update_kernel<kMmX3>)",
          "(m == kMmX3)\n    return reinterpret_cast<const void*>("
          "ddpg_update_kernel<kMmX6>)")], _ROW_CHAIN_SOURCES[:4],
        ("B3 K 1 updated",), (_X3,), True),
    "grad_w_tile's staged X6 rows without mid": (
        [("row_chain.cuh",
          "        Gs[idx] =\n            mm_in<M>(j0 + e < out ? "
          "__ldcg(G + b * out + j0 + e) : 0.0f);\n",
          "        Gs[idx] =\n            mm_in<M>(j0 + e < out ? "
          "__ldcg(G + b * out + j0 + e) : 0.0f);\n"
          "        if constexpr (M == kMmX6) Gs[idx].mid = 0.0f;\n")],
        _ROW_CHAIN_SOURCES, ("B3 K 1 updated", "B5 K 1", "B7 K 1 clip 10.0"),
        (_X6,), True),
    "B9's X3 and X6 dispatch swapped": (
        [("lrpg_update.cu", "  if (d.mm == kMmX3)\n    return run_phase<kMmX3>",
          "  if (d.mm != kMmX3)\n    return run_phase<kMmX3>")], _B9_SOURCES,
        ("B9 N 1000",), (_X3, _X6), True),
    "B9's head logits at float32 in the F64 instance": (
        [("lrpg_update.cu",
          "prod_rows<M, 1>(t.a, hl, MatRows{smem + woff, kPgHeadLd}",
          "prod_rows<(M == kMmF64 ? kMmF32 : M), 1>(t.a, hl, "
          "MatRows{smem + woff, kPgHeadLd}")], _B9_SOURCES,
        ("B9 N 1000", f"B9 N {B9_N}"), (_F64,), False),
}


def _load_like_main(path: str):
    """The library at `path`, its functions given the main library's
    argument types (those it has)."""
    import ctypes

    from cartpoleplusplus_tpu_torch.ops import _native

    main_lib, lib = _native.load_library(), ctypes.CDLL(path)
    for name in ("cp_ddpg_workspace_floats", "cp_ddpg_update_phase",
                 "cp_dqn_workspace_floats", "cp_dqn_update_phase",
                 "cp_naf_workspace_floats", "cp_naf_update_phase",
                 "cp_lrpg_workspace_floats", "cp_lrpg_update_phase",
                 "cp_mm_probe", "cp_mm_split", "cp_mma_probe"):
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = getattr(main_lib, name).argtypes
            fn.restype = getattr(main_lib, name).restype
    lib.cp_error_string = main_lib.cp_error_string
    return lib


def _planted_build(tag: str, patches, sources):
    """Starts nvcc, one process per source, on `sources` in a copy of
    csrc/ with `patches` planted, for a library of its own (the main
    library and csrc/ untouched). Returns a function that waits for them,
    links the objects and loads the library (_load_like_main)."""
    import os
    import re
    import shutil

    from cartpoleplusplus_tpu_torch.ops import _native

    out = os.path.join(_native.BUILD_DIR, "planted",
                       re.sub(r"[^A-Za-z0-9]+", "_", tag))
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_native.CSRC, out)
    for name, old, new in patches:
        path = os.path.join(out, name)
        text = open(path).read()
        assert text.count(old) == 1, f"planted {tag}: {old!r} in {name}"
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    nvcc, jobs = _native._nvcc(), []
    for s in sources:
        obj = os.path.join(out, s[:-3] + ".o")
        jobs.append((obj, subprocess.Popen(
            [nvcc, *_native.NVCC_FLAGS, "-c", "-o", obj,
             os.path.join(out, s)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))

    def load():
        for _, proc in jobs:
            log = proc.communicate(timeout=900)[0]
            if proc.returncode != 0:
                raise RuntimeError(f"planted {tag}: nvcc failed\n{log}")
        lib = os.path.join(out, "libplanted.so")
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-shared", "-o", lib, *(o for o, _ in jobs)],
                       check=True, capture_output=True, timeout=600)
        return _load_like_main(lib)

    return load


def _product_probe(dev) -> dict:
    """The product probe (csrc/mm_probe.cu, the learners' product helpers
    alone) at every mode on lk.probe_operands (64 x 384 @ 384 x 64: low
    mantissa bits set, sums that cancel): each mode's result equal bit for
    bit to its own exact chain (ops.learner_kernel.mm_chain, stepped in
    exact arithmetic on the CPU) and apart from every other mode's in more
    than a tenth of the elements; the split (mm_split) on the card equal
    to the CPU's on edge patterns and 100,000 random ones."""
    import numpy as np
    import torch

    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk

    a, b = lk.probe_operands(np.random.RandomState(0))
    ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    chains = [lk.mm_chain(a, b, m) for m in range(len(lk.MODE_NAMES))]

    def apart(got):
        return [float((got.view(np.uint32) != c.view(np.uint32)).mean())
                for c in chains]

    out = {}
    for m, name in enumerate(lk.MODE_NAMES):
        shares = apart(lk.mm_probe(ta, tb, m).cpu().numpy())
        assert shares[m] == 0.0, (name, shares)
        assert all(x > 0.1 for i, x in enumerate(shares) if i != m), \
            (name, shares)
        out[name] = shares
    rng = np.random.RandomState(1)
    bits = np.concatenate([
        np.array([0, 0x80000000, 1, 0x00008000, 0x3F808000, 0x3F818000,
                  0x7F7F7FFF, 0x7F7F8000, 0x7F800000, 0xFF800000,
                  0x7FC00000], np.uint32),
        rng.randint(0, 2 ** 32, 100000, dtype=np.uint64).astype(np.uint32)])
    x = torch.from_numpy(bits.view(np.float32).copy())
    for m, name in enumerate(lk.MODE_NAMES):
        got = lk.mm_split(x.to(dev), m).cpu().numpy()
        want = lk.mm_split(x, m).numpy()
        nan = np.isnan(want)
        assert np.array_equal(np.isnan(got), nan), name
        assert np.array_equal(got[~nan].view(np.uint32),
                              want[~nan].view(np.uint32)), name
    print("product probe (64 x 384 @ 384 x 64): each mode's share of "
          "elements apart from each mode's exact chain " + "; ".join(
              f"{n} [{', '.join(f'{x:.3f}' for x in v)}]"
              for n, v in out.items())
          + f" (in the order {', '.join(lk.MODE_NAMES)}); the split equal "
          f"to the CPU's on {len(bits)} patterns at every mode",
          flush=True)
    out["mma"] = _mma_probe(dev)
    return out


def _mma_probe(dev) -> dict:
    """The tensor cores' probe (csrc/mm_probe.cu's cp_mma_probe: B3's and
    B9's fragment helpers alone) at each tensor-core mode: equal bit for
    bit to its plain version (lk.mma_chain) on lk.mma_probe_operands,
    whose block sums are exact (the fragments' layouts, the parts and
    their order), and on lk.probe_operands (cancelling sums) within 1e-5
    of the terms' magnitudes of the twin's product (lk._mm); and the
    operands as the hardware's conversions give them (lk.mma_split) equal
    to the CPU's split bit for bit on edge patterns and 100,000 random
    ones. Returns each mode's largest error over the magnitudes."""
    import numpy as np
    import torch

    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk

    out = {}
    rng = np.random.RandomState(1)
    bits = np.concatenate([
        np.array([0, 0x80000000, 1, 0x00008000, 0x3F808000, 0x3F818000,
                  0x3F801000, 0x3F803000, 0x7F7F7FFF, 0x7F7F8000,
                  0x7F7FF000, 0x477FF000, 0x7F800000, 0xFF800000,
                  0x7FC00000, 0x7F800001], np.uint32),
        rng.randint(0, 2 ** 32, 100000, dtype=np.uint64).astype(np.uint32)])
    split_x = torch.from_numpy(bits.view(np.float32).copy())
    a2, b2 = lk.probe_operands(np.random.RandomState(0))
    ta2, tb2 = torch.from_numpy(a2), torch.from_numpy(b2)
    mag = ta2.double().abs() @ tb2.double().abs()
    for m in lk.TC_MODES:
        name = lk.MODE_NAMES[m]
        a, b = lk.mma_probe_operands(np.random.RandomState(0), m)
        got = lk.mma_probe(torch.from_numpy(a).to(dev),
                           torch.from_numpy(b).to(dev), m).cpu().numpy()
        assert np.array_equal(got.view(np.uint32),
                              lk.mma_chain(a, b, m).view(np.uint32)), name
        got = lk.mma_probe(ta2.to(dev), tb2.to(dev), m).cpu().double()
        err = (got - lk._mm(ta2, tb2, m).double()).abs()
        bar = 1e-5 * mag + (2.0 ** -10 * got.abs() if m == lk.F16 else 0.0)
        assert bool((err <= bar).all()), name
        out[name] = float((err / mag).max())
        got = lk.mma_split(split_x.to(dev), m).cpu().numpy()
        want = lk.mm_split(split_x, m).numpy()
        nan = np.isnan(want)
        assert np.array_equal(np.isnan(got), nan), name
        assert np.array_equal(got[~nan].view(np.uint32),
                              want[~nan].view(np.uint32)), name
    print("tensor-core probe (B3's and B9's mma fragment helpers): equal to "
          "mma_chain bit for bit at each tensor-core mode on operands whose "
          "block sums are exact; on cancelling operands (64 x 384 @ 384 x "
          "64) the largest error against the twin's product over the terms' "
          "magnitudes " + ", ".join(f"{n} {v:.3g}" for n, v in out.items())
          + f" (bar 1e-5); the hardware's conversions equal to the CPU's "
          f"split on {len(bits)} patterns at each mode", flush=True)
    return out


def _precision_cases(dev):
    """Phase 32's learner cases, one at a time (their inputs made as the
    case comes): dicts of the kernel's key in the kernels line and the
    case's label there, the tag _mode_holds prints, run(p) and twin(p),
    the networks' group count, whether it is one update (or B9's one
    window), the share of elements past B3's bar, and for the timed case
    of each key `time`: (a title, fn(p), reps, the products' FLOPs, the
    other FLOPs, the bytes)."""
    import torch

    from cartpoleplusplus_tpu_torch.agents.common import lr_schedule
    from cartpoleplusplus_tpu_torch.agents.naf import NAFConfig
    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk

    card = _card()
    hidden = (256, 256)
    la, lc = lk.actor_layout(42, hidden), lk.critic_layout(42, hidden)
    b3_lays = (la, lc, la, lc, la, la, lc, lc)
    b3_kw = dict(actor_lr=1e-4, critic_lr=1e-3, gamma=0.99, tau=0.01)

    def b3_case(batch, k, agc, label, share, reps=0):
        groups, batches = _b3_inputs(dev, hidden, batch, k, seed=21)
        kw = dict(b3_kw, actor_grad_critic=agc)

        def run(p):
            got = [g.clone() for g in groups]
            losses = lk.ddpg_update_phase(got, batches, B3_T0, hidden,
                                          mm_precision=p, **kw)
            torch.cuda.synchronize()
            return ([lk.group_views(g, lay) for g, lay in zip(got,
                                                               b3_lays)],
                    losses)

        def twin(p):
            res = lk.update_phase_math(
                *[lk.group_views(g, lay) for g, lay in zip(groups, b3_lays)],
                batches, B3_T0, hidden, mm_precision=p, **kw)
            return res[:8], res[8:]

        key = "B3" if batch == B3_BATCH else "B3 fast"
        case = dict(key=key, label=label, tag=f"B3 {label}", run=run,
                    twin=twin, nets=4, one_update=k == 1, share=share)
        if reps:
            case["time"] = (
                f"B3 batch {batch} x K {k} (card {card})",
                lambda p: lk.ddpg_update_phase(groups, batches, B3_T0,
                                               hidden, mm_precision=p, **kw),
                reps, k * _b3_update_flop(hidden, batch), 0,
                2 * _nbytes(*groups) + _nbytes(*batches) + 8 * k)
        return case

    for agc in ("updated", "pre"):
        yield b3_case(B3_BATCH, 1, agc, f"K 1 {agc}", ONE_UPDATE_SHARE)
    yield b3_case(B3_BATCH, B3_K, "updated", f"K {B3_K}", B3_K_SHARE, 10)
    yield b3_case(B3_FAST_BATCH, B3_FAST_K, "updated",
                  f"batch {B3_FAST_BATCH} K {B3_FAST_K}", B3_FAST_SHARE, 3)

    lay = lk.qnet_layout(42, hidden)
    b5_kw = dict(lr=5e-5, gamma=0.99, tau=0.01)

    def b5_case(k, share, reps=0):
        groups, batches = _b5_inputs(dev, hidden, B5_BATCH, k, seed=21)

        def run(p):
            got = [g.clone() for g in groups]
            loss = lk.dqn_update_phase(got, batches, B3_T0, hidden,
                                       mm_precision=p, **b5_kw)
            torch.cuda.synchronize()
            return [lk.group_views(g, lay) for g in got], [loss]

        def twin(p):
            res = lk.dqn_update_phase_math(
                *[lk.group_views(g, lay) for g in groups], batches, B3_T0,
                hidden, mm_precision=p, **b5_kw)
            return res[:4], res[4:]

        case = dict(key="B5", label=f"K {k}", tag=f"B5 K {k}", run=run,
                    twin=twin, nets=2, one_update=k == 1, share=share)
        if reps:
            h0, h1 = hidden
            fwd = 42 * h0 + h0 * h1 + h1 * 5
            case["time"] = (
                f"B5 batch {B5_BATCH} x K {k} (card {card})",
                lambda p: lk.dqn_update_phase(groups, batches, B3_T0, hidden,
                                              mm_precision=p, **b5_kw),
                reps, k * 2 * B5_BATCH * (3 * fwd + (5 * h1 + h1 * h0)
                                          + fwd), 0,
                2 * _nbytes(*groups) + _nbytes(*batches) + 4 * k)
        return case

    yield b5_case(1, ONE_UPDATE_SHARE)
    yield b5_case(B5_K, ROW_CHAIN_K_SHARE, 10)

    cfg = NAFConfig()
    lay7 = lk.naf_layout(42, hidden)
    b7_kw = dict(lr=cfg.lr, gamma=cfg.gamma, tau=cfg.tau,
                 lr_schedule=lr_schedule(cfg))

    def b7_case(k, clip, share, reps=0):
        groups, batches = _b7_inputs(dev, hidden, B7_BATCH, k, seed=33)
        kw = dict(b7_kw, max_grad_norm=clip)

        def run(p):
            got = [g.clone() for g in groups]
            loss = lk.naf_update_phase(got, batches, B3_T0, hidden,
                                       mm_precision=p, **kw)
            torch.cuda.synchronize()
            return [lk.group_views(g, lay7) for g in got], [loss]

        def twin(p):
            res = lk.naf_update_phase_math(
                *[lk.group_views(g, lay7) for g in groups], batches, B3_T0,
                hidden, mm_precision=p, **kw)
            return res[:4], res[4:5]

        label = f"K {k} clip {clip}"
        case = dict(key="B7", label=label, tag=f"B7 {label}", run=run,
                    twin=twin, nets=2, one_update=k == 1, share=share)
        if reps:
            case["time"] = (
                f"B7 batch {B7_BATCH} x K {k}, clip {clip} (card {card})",
                lambda p: lk.naf_update_phase(groups, batches, B3_T0, hidden,
                                              mm_precision=p, **kw),
                reps, k * _b7_update_flop(hidden, B7_BATCH), 0,
                2 * _nbytes(*groups) + _nbytes(*batches) + 4 * k)
        return case

    for clip in (cfg.max_grad_norm, 0.0):
        yield b7_case(1, clip, ONE_UPDATE_SHARE)
    yield b7_case(B7_K, cfg.max_grad_norm, ROW_CHAIN_K_SHARE, 10)

    lay9 = lk.policy_layout(42, LRPG_HIDDEN)
    b9_kw = dict(lr=3e-4, entropy_coef=0.1)

    def b9_case(n, reps=0):
        groups, window = _b9_inputs(dev, LRPG_HIDDEN, seed=29, n=n)

        def run(p):
            got = [x.clone() for x in groups]
            loss = lk.lrpg_update_phase(got, window, B3_T0, LRPG_HIDDEN,
                                        mm_precision=p, **b9_kw)
            torch.cuda.synchronize()
            return [lk.group_views(x, lay9) for x in got], [loss]

        def twin(p):
            res = lk.lrpg_update_phase_math(
                *[lk.group_views(x, lay9) for x in groups], window, B3_T0,
                LRPG_HIDDEN, mm_precision=p, **b9_kw)
            return res[:3], res[3:]

        case = dict(key="B9", label=f"N {n}", tag=f"B9 N {n}", run=run,
                    twin=twin, nets=1, one_update=True,
                    share=ONE_UPDATE_SHARE)
        if reps:
            case["time"] = (
                f"B9 N {n}, hidden {LRPG_HIDDEN} (card {card})",
                lambda p: lk.lrpg_update_phase(groups, window, B3_T0,
                                               LRPG_HIDDEN, mm_precision=p,
                                               **b9_kw),
                reps, *_b9_split_flop(n, LRPG_HIDDEN),
                _nbytes(*window) + 2 * _nbytes(*groups) + 4)
        return case

    # A window of 1000 rows besides the defaults' 131,072: the mean over
    # 131,072 rows hides a weight gradient's operand left unrounded.
    yield b9_case(B9_SMALL_N)
    yield b9_case(B9_N, 10)


def phase_planted_faults(dev) -> dict:
    """`chip_smoke.py --plant-faults`, a one-off check of phase 32's own
    checks: each planted fault built from a patched copy of csrc/ and
    caught. The product helpers' (PROBE_FAULTS) by the product probe (its
    mode's result off its own exact chain in more than a tenth of the
    elements); the tensor cores' fragment helpers' (MMA_PROBE_FAULTS) by
    the tensor-core probe (off mma_chain in more than a tenth of the
    elements); the learners' (LEARNER_FAULTS) by _mode_holds, at the
    fault's modes, in every case listed with it (where the fault is one
    the checks must catch; the other's readings are printed)."""
    import numpy as np
    import torch

    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk

    loads = {tag: _planted_build(f"probe {tag}", [patch], ["mm_probe.cu"])
             for tag, (_, patch) in {**PROBE_FAULTS,
                                     **MMA_PROBE_FAULTS}.items()}
    loads.update({tag: _planted_build(tag, patches, sources)
                  for tag, (patches, sources, *_) in
                  LEARNER_FAULTS.items()})
    a, b = lk.probe_operands(np.random.RandomState(0))
    ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    caught = {}
    for tag, (mode, _) in PROBE_FAULTS.items():
        m = lk.MODE_NAMES.index(mode)
        with _use_library(loads[tag]()):
            got = lk.mm_probe(ta, tb, m).cpu().numpy()
        share = float((got.view(np.uint32)
                       != lk.mm_chain(a, b, m).view(np.uint32)).mean())
        assert share > 0.1, f"planted {tag} not caught: {share}"
        caught[tag] = {"probe": f"{share:.4f} of the elements off the "
                                f"{mode} chain"}
    for tag, (mode, _) in MMA_PROBE_FAULTS.items():
        m = lk.MODE_NAMES.index(mode)
        lib = loads[tag]()
        ma, mb = lk.mma_probe_operands(np.random.RandomState(0), m)
        with _use_library(lib):
            got = lk.mma_probe(torch.from_numpy(ma).to(dev),
                               torch.from_numpy(mb).to(dev), m).cpu().numpy()
        share = float((got.view(np.uint32)
                       != lk.mma_chain(ma, mb, m).view(np.uint32)).mean())
        assert share > 0.1, f"planted {tag} not caught: {share}"
        caught[tag] = {"probe": f"{share:.4f} of the elements off "
                                f"mma_chain at {mode}"}
    libs = {tag: loads[tag]() for tag in LEARNER_FAULTS}
    for case in _precision_cases(dev):
        for tag, (_, _, tags, modes, must) in LEARNER_FAULTS.items():
            if case["tag"] not in tags:
                continue
            with _use_library(libs[tag]):
                try:
                    res = _mode_holds(case["tag"], case["run"], case["twin"],
                                      case["nets"], case["one_update"],
                                      case["share"], modes=modes)
                except AssertionError as e:
                    caught.setdefault(tag, {})[case["tag"]] = \
                        str(e).splitlines()[0][:400]
                    continue
            assert not must, f"planted {tag} not caught at {case['tag']}"
            caught.setdefault(tag, {})[case["tag"]] = \
                f"not caught; ulps from the nearer of the float32 and F64 " \
                f"twins: {res['identity']['err']}"
    for tag, where in caught.items():
        print(f"planted fault: {tag}: " + "; ".join(
            v if v.startswith(k) else f"{k}: {v}" for k, v in where.items()),
              flush=True)
    return caught


# B3's and B9's sources, which phase 32 builds again with CP_MM_FFMA
# (csrc/learner_stages.cuh: every mode on the fmaf chains, the instances
# as they were before the tensor cores) as the yardstick of its times.
_TC_SOURCES = tuple(f"{n}_update{u}.cu" for n in ("ddpg", "lrpg")
                    for u in ("", "_x3x6", "_f64f16")) + (
                        "ddpg_update_wide.cu",)


def _ffma_build():
    """Starts nvcc on _TC_SOURCES with CP_MM_FFMA defined, into a library
    of its own (_planted_build's copy of csrc/; the main library and csrc/
    untouched). Returns the function that waits for it and loads it."""
    return _planted_build("ffma", [("learner_stages.cuh",
                                    "#ifdef CP_MM_FFMA\n",
                                    "#define CP_MM_FFMA 1\n"
                                    "#ifdef CP_MM_FFMA\n")], _TC_SOURCES)


def _instances_of(case) -> dict:
    """The id the case's kernel (B3 or B9) wrote from inside each launch
    (lk.last_instance), at float32 and each mode of PRECISION_MODES: the
    mode, plus lk.INSTANCE_TC at the kernel's tensor-core modes
    (lk.TC_MODES_OF; an fmaf instance there fails, and so does a
    tensor-core one elsewhere)."""
    import torch

    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk

    kernel = "B9" if case["key"] == "B9" else "B3"
    out = {}
    for p in (None,) + PRECISION_MODES:
        lk._instances.clear()
        case["run"](p)
        got = lk.last_instance(kernel, torch.device("cuda", 0))
        mode = lk.mm_mode(p)
        tc = mode in lk.TC_MODES_OF[kernel]
        want = mode + (lk.INSTANCE_TC if tc else 0)
        assert got == want, f"{case['tag']} {p}: instance {got}, want {want}"
        out[p or "float32"] = got
    print(f"{case['tag']}: instance ids (the mode, + {lk.INSTANCE_TC} on the "
          f"tensor cores) {out}", flush=True)
    return out


def phase_learner_precision(dev, ffma_load=None) -> dict:
    """learner_precision on the card: the product probe against each
    mode's exact chain (_product_probe); B3, B5, B7 and B9 at each product
    mode against their twins (_mode_holds) at the defaults (B3 batch 256
    at "updated" and "pre", K 1 and 16; B5 K 1 and 8; B7 K 1 and 8 with
    the clip at 10 and off; B9 at 131,072 rows and at 1,000), B3 also at
    the fast preset's batch 8192 x K 8, each timed at every mode in turns
    with float32 (_precision_cases); then the CLI at each agent's defaults
    with `--<agent>.learner-precision bfloat16` (the counters zeroed
    before each run and read after it: the learner kernel as often as at
    float32, the rollout kernel every step), and each agent at the other
    values for a few steps."""
    card = _card()
    out = {"card": card, "probe": _product_probe(dev)}
    ffma = ffma_load() if ffma_load is not None else None
    for case in _precision_cases(dev):
        entry = out.setdefault(case["key"], {"holds": {}})
        entry["holds"][case["label"]] = _mode_holds(
            case["tag"], case["run"], case["twin"], case["nets"],
            case["one_update"], case["share"])
        if case["key"] in ("B3", "B9") and case["one_update"]:
            entry.setdefault("instances", {})[case["label"]] = \
                _instances_of(case)
        if "time" in case:
            title, fn, reps, prod, rest, nbytes = case["time"]
            tc = case["key"] in ("B3", "B3 fast", "B9")
            times, ref = _mode_times(fn, reps, ffma if tc else None,
                                     "B9" if case["key"] == "B9" else "B3")
            bounds = _mode_bounds(prod, rest, nbytes)
            print(f"{title}: {_times_line(times, bounds, ref)}", flush=True)
            entry.update(ms=times, bounds=bounds, **bounds["float32"])
            if ref:
                entry["ffma_ms"] = ref

    # The CLI: each agent's defaults at bfloat16 (the launches the kernels
    # line reports), then the other legacy values at a small size.
    learner = {"ddpg": "B3", "dqn": "B5", "naf": "B7", "lrpg": "B9"}
    rollout = {"ddpg": "B2", "dqn": "B4", "naf": "B6", "lrpg": "B8"}
    launches, t0 = {}, time.perf_counter()
    for agent in learner:
        t = LRPG_T if agent == "lrpg" else 8
        _zero_counts()
        rc, lines, _, secs = _train_lines([
            "--agent", agent, "--total-env-steps", str(8 * t),
            "--log-interval", "1", f"--{agent}.learner", "kernel",
            f"--{agent}.learner-precision", "bfloat16", "--seed", "0"])
        counts = _read_counts()
        assert rc == 0, f"{agent} at bfloat16 returned {rc}"
        n_learn = 8 if agent == "lrpg" else 7
        assert _only(counts, **{rollout[agent]: 8,
                                learner[agent]: n_learn}), (agent, counts)
        for m in lines:
            assert all(math.isfinite(v) for v in m.values()), m
        assert lines[-1]["learner_impl"] == 1.0
        launches[f"{agent} bfloat16"] = counts
        print(f"{agent} --{agent}.learner-precision bfloat16 at its defaults "
              f"(8 train steps, {secs:.2f} s): launches "
              f"{ {k: v for k, v in counts.items() if v} }; last loss "
              f"{lines[-1].get('critic_loss', lines[-1].get('loss')):.6g}",
              flush=True)
    others = ("default", "tensorfloat32", "high", "float32", "highest",
              "BF16_BF16_F32_X3", "BF16_BF16_F32_X6", "F64_F64_F64",
              "F16_F16_F16")
    for agent in learner:
        t = LRPG_T if agent == "lrpg" else 8
        for value in others:
            _zero_counts()
            rc, lines, _, _ = _train_lines([
                "--agent", agent, "--num-envs", str(PRECISION_CLI_ENVS),
                "--total-env-steps", str(PRECISION_CLI_STEPS * t),
                "--log-interval", "1", f"--{agent}.learner", "kernel",
                f"--{agent}.learner-precision", value])
            counts = _read_counts()
            n_learn = PRECISION_CLI_STEPS - (agent != "lrpg")
            assert rc == 0 and counts[learner[agent]] == n_learn, \
                (agent, value, rc, counts)
            assert all(math.isfinite(v) for m in lines for v in m.values())
            if value in PRECISION_MODES:
                launches[f"{agent} {value}"] = counts
    print(f"the other values {others} through each agent's learner "
          f"kernel ({PRECISION_CLI_ENVS} envs, {PRECISION_CLI_STEPS} train "
          f"steps each): rc 0, finite metrics, the learner kernel past the "
          f"warmup; CLI runs {time.perf_counter() - t0:.2f} s in all",
          flush=True)
    out["launches"] = launches
    return out


def learner_bits(dev, path: str) -> int:
    """The outputs of B3 ("updated", "pre"), B5, B7 (the clip at 10 and
    off) and B9 at their defaults, through whichever package sits beside
    the script, and each kernel's ms (CUDA events): B5 and B7 at float32
    (the wrappers' default call) and at every mode of PRECISION_MODES, B3
    at float32, TF32, X6 and F64, B9 at float32 and F64 (their fmaf and
    DFMA chains; their other modes run on the tensor cores and phase 32
    holds them to their twins instead). Saved to `path`, or, where `path`
    exists, compared with it bit for bit (exit 1 on a difference). Copy
    the script into an unpacked parent and run it there and here in turns
    to hold a change to the parent's bits and time."""
    import os

    import torch

    from cartpoleplusplus_tpu_torch.agents.common import lr_schedule
    from cartpoleplusplus_tpu_torch.agents.naf import NAFConfig
    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk

    hidden, cfg = (256, 256), NAFConfig()
    b3_kw = dict(actor_lr=1e-4, critic_lr=1e-3, gamma=0.99, tau=0.01)
    b5_kw = dict(lr=5e-5, gamma=0.99, tau=0.01)
    b7_kw = dict(lr=cfg.lr, gamma=cfg.gamma, tau=cfg.tau,
                 lr_schedule=lr_schedule(cfg))
    b9_kw = dict(lr=3e-4, entropy_coef=0.1)
    calls = {}
    for agc in ("updated", "pre"):
        g, b = _b3_inputs(dev, hidden, B3_BATCH, B3_K, seed=21)
        calls[f"B3 {agc}"] = (g, lambda gs, kw, b=b, agc=agc:
                              lk.ddpg_update_phase(
                                  gs, b, B3_T0, hidden, actor_grad_critic=agc,
                                  **b3_kw, **kw))
    g, b = _b5_inputs(dev, hidden, B5_BATCH, B5_K, seed=21)
    calls["B5"] = (g, lambda gs, kw, b=b: lk.dqn_update_phase(
        gs, b, B3_T0, hidden, **b5_kw, **kw))
    for clip in (cfg.max_grad_norm, 0.0):
        g, b = _b7_inputs(dev, hidden, B7_BATCH, B7_K, seed=33)
        calls[f"B7 clip {clip}"] = (g, lambda gs, kw, b=b, clip=clip:
                                    lk.naf_update_phase(
                                        gs, b, B3_T0, hidden,
                                        max_grad_norm=clip, **b7_kw, **kw))
    g, w = _b9_inputs(dev, LRPG_HIDDEN, seed=29)
    calls["B9"] = (g, lambda gs, kw, w=w: lk.lrpg_update_phase(
        gs, w, B3_T0, LRPG_HIDDEN, **b9_kw, **kw))
    outs, ms = {}, {}
    for name, (groups, call) in calls.items():
        modes = ((None,) + PRECISION_MODES if name[:2] in ("B5", "B7")
                 else (None, "tensorfloat32", _X6, _F64)
                 if name[:2] == "B3" else (None, _F64))
        for p in modes:
            kw = {} if p is None else dict(mm_precision=p)
            tag = name if p is None else f"{name} {p}"
            got = [x.clone() for x in groups]
            losses = call(got, kw)
            losses = list(losses) if isinstance(losses, tuple) else [losses]
            outs[tag] = [x.cpu() for x in got + losses]
            ms[tag] = _time_ms(lambda: call([x.clone() for x in groups], kw),
                               20)
    torch.cuda.synchronize()
    print(json.dumps({"learner_ms": ms, "card": _card()}), flush=True)
    print("learner bits: B5 and B7 at float32 and every mode, B3 at "
          "float32, TF32, X6 and F64, B9 at float32 and F64; B3's bfloat16, "
          "X3 and F16 and B9's and its TF32 and X6 run on the tensor cores "
          "and are held to their twins at the same mode in phase 32 "
          "instead", flush=True)
    if not os.path.exists(path):
        torch.save(outs, path)
        print(f"learner bits saved to {path}", flush=True)
        return 0
    want = torch.load(path)
    same = {name: all(torch.equal(a, b) for a, b in zip(outs[name],
                                                         want[name]))
            for name in outs}
    print(json.dumps({"bit_equal": same}), flush=True)
    return 0 if all(same.values()) else 1


_LAP = [time.perf_counter()]


def _lap(label: str) -> None:
    """Prints the host seconds since the last lap (the run's phase times,
    against its time limit)."""
    now = time.perf_counter()
    print(f"[{label}: {now - _LAP[0]:.1f} s]", flush=True)
    _LAP[0] = now


def learner_times(dev) -> dict:
    """B3 (batch 256 x K 16, the fast preset's 8192 x K 8) and B9 (131,072
    rows) at float32 and every mode of PRECISION_MODES, and B5 and B7 at
    float32, at their defaults' inputs, through whichever package sits
    beside the script: ms per phase (CUDA events). Copy the script into an
    unpacked parent and run it there and here in turns (parent, change,
    change, parent) to time a change against the parent on one card."""
    from cartpoleplusplus_tpu_torch.agents.common import lr_schedule
    from cartpoleplusplus_tpu_torch.agents.naf import NAFConfig
    from cartpoleplusplus_tpu_torch.ops import learner_kernel as lk

    hidden, out = (256, 256), {}
    kw3 = dict(actor_lr=1e-4, critic_lr=1e-3, gamma=0.99, tau=0.01)
    for batch, k, reps in ((B3_BATCH, B3_K, 10),
                           (B3_FAST_BATCH, B3_FAST_K, 3)):
        g, b = _b3_inputs(dev, hidden, batch, k, seed=21)
        for p in (None,) + PRECISION_MODES:
            out[f"B3 {batch} x K {k} {p or 'float32'}"] = _time_ms(
                lambda: lk.ddpg_update_phase(g, b, B3_T0, hidden,
                                             mm_precision=p, **kw3), reps)
    g, w = _b9_inputs(dev, LRPG_HIDDEN, seed=29)
    for p in (None,) + PRECISION_MODES:
        out[f"B9 {p or 'float32'}"] = _time_ms(
            lambda: lk.lrpg_update_phase(g, w, B3_T0, LRPG_HIDDEN,
                                         mm_precision=p, lr=3e-4,
                                         entropy_coef=0.1), 10)
    g, b = _b5_inputs(dev, hidden, B5_BATCH, B5_K, seed=21)
    out["B5 float32"] = _time_ms(lambda: lk.dqn_update_phase(
        g, b, B3_T0, hidden, lr=5e-5, gamma=0.99, tau=0.01), 10)
    cfg = NAFConfig()
    g, b = _b7_inputs(dev, hidden, B7_BATCH, B7_K, seed=33)
    out["B7 float32"] = _time_ms(lambda: lk.naf_update_phase(
        g, b, B3_T0, hidden, lr=cfg.lr, gamma=cfg.gamma, tau=cfg.tau,
        max_grad_norm=cfg.max_grad_norm, lr_schedule=lr_schedule(cfg)), 10)
    return out


def _warm_card(dev, seconds: float):
    """A few seconds of matrix products: timed from a cold card, B4 read
    0.52 ms against 0.34-0.41 warm (PERF.md)."""
    import torch

    warm = torch.randn((8192, 8192), device=dev)
    t_warm = time.perf_counter()
    while time.perf_counter() - t_warm < seconds:
        warm @ warm
    torch.cuda.synchronize()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from cartpoleplusplus_tpu_torch.ops import _native

    dev = torch.device("cuda", 0)
    if sys.argv[1:] == ["--b1-times"]:
        _warm_card(dev, 2.0)
        print(json.dumps({"b1_ms": b1_times(dev), "card": _card()}),
              flush=True)
        return 0
    if sys.argv[1:] == ["--presample-times"]:
        print(json.dumps({"presample_ms": presample_times(dev),
                          "card": _card()}), flush=True)
        return 0
    if sys.argv[1:] == ["--learner-times"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        _native.load_library()
        _warm_card(dev, 2.0)
        print(json.dumps({"learner_times_ms": learner_times(dev),
                          "card": _card()}), flush=True)
        return 0
    if sys.argv[1:] == ["--suite-learners"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(_card(), flush=True)
        _native.load_library()
        print(json.dumps({"suite_learners": phase_suite_learners(dev)}),
              flush=True)
        return 0
    if sys.argv[1:2] == ["--learner-bits"] and len(sys.argv) == 3:
        _native.load_library()
        _warm_card(dev, 2.0)
        return learner_bits(dev, sys.argv[2])
    if sys.argv[1:2] == ["--dist-rank"]:
        return _dist_worker(sys.argv[2], int(sys.argv[3]))
    if sys.argv[1:] == ["--dist-only"]:
        print(_card(), flush=True)
        _native.load_library()
        dist = phase_distribution(dev)
        print(json.dumps({"dist": dist}), flush=True)
        return 0
    if sys.argv[1:] == ["--bf16-only"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(_card(), flush=True)
        _native.load_library()
        print(json.dumps({"bf16": phase_bfloat16_agents(dev)}), flush=True)
        return 0
    if sys.argv[1:] == ["--precision-only"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(_card(), flush=True)
        _native.load_library()
        ffma_load = _ffma_build()
        _warm_card(dev, 2.0)
        print(json.dumps({"precision": phase_learner_precision(
            dev, ffma_load)}), flush=True)
        return 0
    if sys.argv[1:] == ["--plant-faults"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(_card(), flush=True)
        _native.load_library()
        print(json.dumps({"planted": phase_planted_faults(dev)}), flush=True)
        return 0
    if sys.argv[1:] == ["--b1-probe"]:
        probe = b1_probe(dev)
        print(json.dumps(probe), flush=True)
        _print_b1_probe(probe, {})
        return 0
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
    ffma_load = _ffma_build()  # phase 32's yardstick, built meanwhile
    _lap("start and build")

    _warm_card(dev, 5.0)
    b1 = phase_b1(dev)
    _lap("phase_b1")
    floor_us = b1["discrete"]["ms"] / B1_STEPS * 1e3  # B1 per env-step
    b2 = phase_b2(dev, floor_us)
    _lap("phase_b2")
    b3 = phase_b3(dev)
    _lap("phase_b3")
    main_launches = phase_main_path()
    _lap("phase_main_path")
    b1_launches = phase_physics_rollout(dev)
    _lap("phase_physics_rollout")
    phase_step_split(dev)
    _lap("phase_step_split")
    b4 = phase_b4(dev, floor_us)
    _lap("phase_b4")
    b5 = phase_b5(dev)
    _lap("phase_b5")
    dqn_launches = phase_dqn_main_path()
    _lap("phase_dqn_main_path")
    phase_dqn_step_split(dev)
    _lap("phase_dqn_step_split")
    split = phase_stage_split(dev)
    _lap("phase_stage_split")
    for label, most in SPLIT_BARRIERS.items():
        assert split[label]["barriers_per_update"] <= most, (label,
                                                             split[label])
    b8 = phase_b8(dev, floor_us)
    _lap("phase_b8")
    b9 = phase_b9(dev)
    _lap("phase_b9")
    lrpg_launches = phase_lrpg_main_path()
    _lap("phase_lrpg_main_path")
    phase_lrpg_step_split(dev)
    _lap("phase_lrpg_step_split")
    b6 = phase_b6(dev, floor_us)
    _lap("phase_b6")
    b7 = phase_b7(dev)
    _lap("phase_b7")
    naf_launches = phase_naf_main_path()
    _lap("phase_naf_main_path")
    phase_naf_step_split(dev)
    _lap("phase_naf_step_split")
    p_pix, poses, b10 = phase_b10(dev)
    _lap("phase_b10")
    b11 = phase_b11(dev, p_pix, poses)
    _lap("phase_b11")
    del poses
    pixel_launches, cull_launches = phase_pixel_main_path()
    _lap("phase_pixel_main_path")
    phase_pixel_step_split(dev)
    _lap("phase_pixel_step_split")
    phase_presets(dev)
    _lap("phase_presets")
    phase_suite_learners(dev)
    _lap("phase_suite_learners")
    phase_pixel_agents_main_path()
    _lap("phase_pixel_agents_main_path")
    phase_pixel_agents_step_split(dev)
    _lap("phase_pixel_agents_step_split")
    phase_sampling(dev)
    _lap("phase_sampling")
    phase_render_bfloat16(dev)
    _lap("phase_render_bfloat16")
    dist = phase_distribution(dev)["per_rank"]
    _lap("phase_distribution")
    bf16 = phase_bfloat16_agents(dev)["launches"]
    _lap("phase_bfloat16_agents")
    phase_tools(dev)
    _lap("phase_tools")
    precision = phase_learner_precision(dev, ffma_load)
    _lap("phase_learner_precision")

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
    # Per-rank launches on the sharded paths of phase 29, launches on
    # phase 30's bfloat16 paths and on phase 32's runs at
    # learner_precision="bfloat16", and phase 32's ms at each product mode.
    for entry in kernels:
        key = entry["name"].split()[0]
        entry["dist_launches_per_rank"] = {
            tag: n[key] for tag, n in dist.items() if n.get(key)}
        entry["bf16_launches"] = {
            tag: n[key] for tag, n in bf16.items() if n.get(key)}
        entry["precision_launches"] = {
            tag: n[key] for tag, n in precision["launches"].items()
            if n.get(key)}
        if key in precision:
            entry["precision_ms"] = {
                mode: statistics.mean(ts)
                for mode, ts in precision[key]["ms"].items()}
            entry["precision_bound_ms"] = {
                mode: b["bound_ms"]
                for mode, b in precision[key]["bounds"].items()}
            entry["precision_chain_ms"] = {
                mode: b["chain_ms"]
                for mode, b in precision[key]["bounds"].items()}
            entry["precision_ffma_ms"] = {
                mode: statistics.mean(ts)
                for mode, ts in precision[key].get("ffma_ms", {}).items()}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
