"""Build and load the hand-written CUDA kernels (csrc/*.cu).

nvcc compiles every csrc/*.cu into an object, one nvcc process per source
and all of them at once, and links the objects into one shared library
with a plain C interface, loaded with ctypes. No PyTorch headers are
involved, so the build takes seconds. The library is built at first use
into `_build/` next to the package sources and rebuilt when a source is
newer. A failed build, a failed load or a failed launch raises: there is
no fallback.

Numerics: `--fmad=false` keeps nvcc from contracting a*b+c into an FMA,
and no fast-math flag is set, so division and sqrt are IEEE (or, in the
env math, exact fast forms with IEEE's bits: csrc/cartpole_env.cuh) and
logf/cosf/sinf/tanhf are the accurate CUDA math library functions. The
kernels then follow the plain torch twins operation by operation, and a
termination threshold does not flip on a contraction. An explicit fmaf()
is still fused: B3, B5, B7 (csrc/row_chain.cuh) and B9
(csrc/lrpg_update.cu) use it in their matrix-product and batch-sum inner
loops only (and fma() on doubles at the F64_F64_F64 product mode); B3 and
B9 at the tensor cores' product modes form their products with mma.sync
instead (csrc/learner_stages.cuh).
"""

from __future__ import annotations

import ctypes
import functools
import glob
import math
import os
import shutil
import subprocess
import time

import numpy as np

from ..physics.params import CartPoleParams

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libcartpole_kernels.so")
BUILD_LOG = os.path.join(BUILD_DIR, "build.log")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None


class EnvConsts(ctypes.Structure):
    """Mirror of `struct EnvConsts` in csrc/cartpole_env.cuh (same field
    order). Each float is the float32 rounding of the Python-float
    subexpression that the torch and JAX code fold before touching a
    tensor, so the kernels see the same constants; `s2_clamp` and the
    float64 reciprocals serve the exact fast forms of the env math."""

    _fields_ = [(n, ctypes.c_float) for n in (
        "dt", "vel_max", "s_norm_max", "w_min2", "s2_clamp",
        "mt", "jc", "kg", "mgl", "mt_g", "inv_den",
        "cart_rest_z", "contact_stiffness", "contact_damping",
        "ground_friction", "friction_vel_eps", "linear_damping",
        "angular_damping", "half_length", "pivot_height", "action_force",
        "two_pi", "reset_mag_lo", "reset_mag_span", "initial_push_force",
        "tau", "reset_dv_coef", "reset_dsd_coef", "reset_det", "z0",
        "push_prob", "push_force", "tilt_s2_limit", "pos_limit",
        "pos_limit2")] + [(n, ctypes.c_int) for n in (
        "steps_per_repeat", "action_repeats", "max_episode_steps",
        "discrete_actions", "reward_shaped", "has_friction",
        "has_linear_damping", "has_angular_damping", "has_push")] + [
        (n, ctypes.c_double) for n in ("inv_mt", "inv_reset_det")]


# Bytes of shared memory one H100 block may use (kMaxSmem in
# csrc/lrpg_update.cu and csrc/q_tile.cuh; B9's planner reads it here).
MAX_SMEM = 232_448


class QDims(ctypes.Structure):
    """Mirror of `struct QDims` in csrc/q_tile.cuh (B2, B4, B6, B8): the
    torso's depth, the obs width, max(obs_dim, hidden...) and the floats of the
    padded torso weights (`ops.q_rollout.pack_tile_net`)."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "num_layers", "obs_dim", "width", "wfloats")]


class NetLayout(ctypes.Structure):
    """Mirror of `struct NetLayout` in csrc/learner_stages.cuh: one
    network's parameter offsets in its group buffer. `lay` points into the
    device table of ops/learner_kernel.py::_learner_table (per torso layer
    the offsets of W, b, LayerNorm scale and bias); wh, bh: the head's;
    size: the group's floats."""

    _fields_ = [("lay", ctypes.c_void_p)] + [
        (n, ctypes.c_int) for n in ("wh", "bh", "size")]


class Torso(ctypes.Structure):
    """Mirror of `struct Torso` in csrc/learner_stages.cuh: the device
    table's widths and their prefix sums, and the depth."""

    _fields_ = [("tab", ctypes.c_void_p), ("num_layers", ctypes.c_int)]


class LearnerDims(ctypes.Structure):
    """Mirror of `struct LearnerDims` in csrc/ddpg_update.cu (B3); spill 1
    puts every row tile's buffers in the workspace at any width; mm, the
    products' mode (ops/learner_kernel.py::mm_mode), picks the kernel's
    instance (as in DqnDims, NafDims and PgDims); instance, when not null,
    a device int the instance writes its id to (as in PgDims); route, the
    wide items' route (ops/learner_kernel.py::ddpg_plan: 0 by the rule
    over the device's SMs; 1 none; 2 every stage)."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "obs_dim", "batch", "k_updates", "merged")] + [
        ("torso", Torso), ("actor", NetLayout), ("critic", NetLayout),
        ("spill", ctypes.c_int), ("mm", ctypes.c_int),
        ("instance", ctypes.c_void_p), ("route", ctypes.c_int)]


class DqnDims(ctypes.Structure):
    """Mirror of `struct DqnDims` in csrc/dqn_update.cu (B5); spill 1
    puts every row tile's buffers in the workspace at any width; route
    as in LearnerDims."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "obs_dim", "batch", "k_updates", "double_dqn")] + [
        ("torso", Torso), ("q", NetLayout), ("spill", ctypes.c_int),
        ("mm", ctypes.c_int), ("route", ctypes.c_int)]


class NafDims(ctypes.Structure):
    """Mirror of `struct NafDims` in csrc/naf_update.cu (B7); spill 1
    puts every row tile's buffers in the workspace at any width; route
    as in LearnerDims."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "obs_dim", "batch", "k_updates")] + [
        ("max_norm", ctypes.c_float), ("torso", Torso), ("q", NetLayout),
        ("spill", ctypes.c_int), ("mm", ctypes.c_int),
        ("route", ctypes.c_int)]


class PgDims(ctypes.Structure):
    """Mirror of `struct PgDims` in csrc/lrpg_update.cu (B9); the launcher
    fills sum_h, hmax and wt from the host's copy of the widths."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "obs_dim", "n_rows", "spill", "sum_h", "hmax", "wt")] + [
        ("torso", Torso), ("net", NetLayout), ("mm", ctypes.c_int),
        ("instance", ctypes.c_void_p)]


class PgConsts(ctypes.Structure):
    """Mirror of `struct PgConsts` in csrc/lrpg_update.cu: B9's float32
    constants, folded on the host (ops/learner_kernel.py::
    lrpg_update_phase)."""

    _fields_ = [(n, ctypes.c_float) for n in (
        "inv_n", "coef", "lr", "b1", "omb1", "b2", "omb2", "eps", "bc1",
        "bc2", "ln_eps")]


class LearnerConsts(ctypes.Structure):
    """Mirror of `struct LearnerConsts` in csrc/learner_stages.cuh: the
    learner's float32 constants, folded on the host
    (ops/learner_kernel.py::_learner_consts)."""

    _fields_ = [(n, ctypes.c_float) for n in (
        "gamma", "tau", "inv_batch", "two_inv_batch", "neg_inv_batch",
        "b1", "omb1", "b2", "omb2", "eps", "log_b1", "log_b2", "ln_eps",
        "actor_lr", "critic_lr", "sched_steps", "actor_lr_delta",
        "critic_lr_delta")] + [("sched", ctypes.c_int)]


@functools.lru_cache(maxsize=64)
def s2_clamp(p: CartPoleParams) -> float:
    """The largest float32 s2 = sx^2 + sy^2 whose float32 square root is
    at most float32(s_norm_max). Up to it the substep's chart clamp
    min(1, s_norm_max / max(|s|, 1e-9)) is exactly 1, so the kernels skip
    the clamp there (csrc/cartpole_env.cuh). Cached: the search takes tens
    of microseconds, as long as a short launch."""
    snm, inf = np.float32(p.s_norm_max), np.float32(np.inf)
    x = np.float32(snm * snm)
    for _ in range(8):   # start below: the root halves the relative gap
        x = np.nextafter(x, np.float32(0.0))
    while x < inf and np.sqrt(np.nextafter(x, inf)) <= snm:
        x = np.nextafter(x, inf)
    return float(x)


def env_consts(p: CartPoleParams) -> EnvConsts:
    """The folded constants of physics/dynamics.py and env/compute.py.
    Raises for a w_min below 1e-15, whose square leaves the range where
    the kernels' fast square root is exact (csrc/cartpole_env.cuh)."""
    if not p.w_min * p.w_min >= 1e-30:
        raise ValueError(f"the CUDA kernels take w_min >= 1e-15, not "
                         f"{p.w_min}")
    mt, jc, kg, l = p.total_mass, p.coupling, p.pole_gen_inertia, p.half_length
    c = EnvConsts(
        dt=p.dt, vel_max=p.vel_max, s_norm_max=p.s_norm_max,
        w_min2=p.w_min * p.w_min, s2_clamp=s2_clamp(p),
        mt=mt, jc=jc, kg=kg, mgl=p.pole_mass * p.gravity * p.half_length,
        mt_g=mt * p.gravity, inv_den=1.0 / p.schur_denom,
        cart_rest_z=p.cart_rest_z, contact_stiffness=p.contact_stiffness,
        contact_damping=p.contact_damping,
        ground_friction=p.ground_friction,
        friction_vel_eps=p.friction_vel_eps,
        linear_damping=p.linear_damping, angular_damping=p.angular_damping,
        half_length=l, pivot_height=p.pivot_height,
        action_force=p.action_force,
        two_pi=2.0 * math.pi,                # uniform(0, 2 pi) span
        reset_mag_lo=0.2, reset_mag_span=1.0 - 0.2,
        initial_push_force=p.initial_push_force,
        tau=p.initial_push_duration,
        reset_dv_coef=kg - jc * l, reset_dsd_coef=mt * l - jc,
        reset_det=mt * kg - jc * jc,
        z0=p.cart_rest_z - p.rest_penetration,
        push_prob=p.push_prob_per_repeat, push_force=p.push_force,
        tilt_s2_limit=p.tilt_s2_limit, pos_limit=p.pos_limit,
        pos_limit2=p.pos_limit * p.pos_limit,
        steps_per_repeat=p.steps_per_repeat,
        action_repeats=p.action_repeats,
        max_episode_steps=p.max_episode_steps,
        discrete_actions=int(p.discrete_actions),
        reward_shaped=int(p.reward_shaped),
        has_friction=int(p.ground_friction != 0.0),
        has_linear_damping=int(p.linear_damping != 0.0),
        has_angular_damping=int(p.angular_damping != 0.0),
        has_push=int(p.push_prob_per_repeat > 0.0))
    # Reciprocals of the float32 constants, for the exact divides by them.
    c.inv_mt, c.inv_reset_det = 1.0 / c.mt, 1.0 / c.reset_det
    return c


def _sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    deps = _sources() + glob.glob(os.path.join(CSRC, "*.cuh"))
    return max(os.path.getmtime(f) for f in deps) > os.path.getmtime(LIB_PATH)


def build() -> float:
    """Compile csrc/*.cu into LIB_PATH; returns the build seconds. The
    compiler's output (ptxas register and shared-memory report) goes to
    BUILD_LOG."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = os.path.join(BUILD_DIR,
                           os.path.basename(src)[:-3] + f".{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    tmp = f"{LIB_PATH}.{tag}"
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", tmp, *(obj for _, obj, _ in jobs)]
    log, failed = [], []
    try:
        for cmd, _, proc in jobs:
            out = proc.communicate(timeout=600)[0]
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(out)
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True,
                                  timeout=600)
            log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(proc.stderr)
    finally:
        for _, obj, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(obj):
                os.remove(obj)
        with open(BUILD_LOG, "w") as f:
            f.write("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0


def load_library() -> ctypes.CDLL:
    """The kernel library, built first if missing or stale. Its counters:
    `build_s`, the seconds of the staleness check and the build; `load_s`,
    of the load and the entry points' signatures (0.0 until the library is
    loaded); `builds`, the builds this process ran."""
    global _lib
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    if _stale():
        build()
        load_library.builds += 1
    t1 = time.perf_counter()
    load_library.build_s += t1 - t0
    lib = ctypes.CDLL(LIB_PATH)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cp_error_string.argtypes = [ci]
    lib.cp_error_string.restype = ctypes.c_char_p
    lib.cp_fused_rollout_workspace.argtypes = [ci]
    lib.cp_fused_rollout_workspace.restype = ci
    lib.cp_fused_rollout.argtypes = [vp, ci, ci] + [vp] * 15 + [vp]
    lib.cp_fused_rollout.restype = ci
    lib.cp_policy_rollout.argtypes = ([vp] * 5 + [cf, cf, ci, ci, ci]
                                      + [vp] * 21 + [vp])
    lib.cp_policy_rollout.restype = ci
    lib.cp_naf_rollout.argtypes = [vp] * 5 + [cf, ci, ci, ci] + [vp] * 19 + [
        vp]
    lib.cp_naf_rollout.restype = ci
    lib.cp_ddpg_workspace_floats.argtypes = [vp, vp]
    lib.cp_ddpg_workspace_floats.restype = ctypes.c_longlong
    lib.cp_ddpg_update_phase.argtypes = [vp] * 3 + [vp] * 8 + [vp] * 5 + [
        vp, vp, vp, ci, vp, vp]
    lib.cp_ddpg_update_phase.restype = ci
    lib.cp_q_workspace_floats.argtypes = [vp, ci]
    lib.cp_q_workspace_floats.restype = ctypes.c_longlong
    lib.cp_q_rollout.argtypes = [vp] * 5 + [cf, ci, ci, ci] + [vp] * 19 + [
        vp]
    lib.cp_q_rollout.restype = ci
    lib.cp_dqn_workspace_floats.argtypes = [vp, vp]
    lib.cp_dqn_workspace_floats.restype = ctypes.c_longlong
    lib.cp_dqn_update_phase.argtypes = [vp] * 3 + [vp] * 4 + [vp] * 5 + [
        vp, vp, ci, vp, vp]
    lib.cp_dqn_update_phase.restype = ci
    lib.cp_naf_workspace_floats.argtypes = [vp, vp]
    lib.cp_naf_workspace_floats.restype = ctypes.c_longlong
    lib.cp_naf_update_phase.argtypes = [vp] * 3 + [vp] * 4 + [vp] * 5 + [
        vp, vp, ci, vp, vp]
    lib.cp_naf_update_phase.restype = ci
    lib.cp_pg_rollout.argtypes = [vp] * 5 + [ci, ci, ci] + [vp] * 19 + [vp]
    lib.cp_pg_rollout.restype = ci
    lib.cp_lrpg_workspace_floats.argtypes = [vp, vp]
    lib.cp_lrpg_workspace_floats.restype = ctypes.c_longlong
    lib.cp_lrpg_update_phase.argtypes = [vp] * 12
    lib.cp_lrpg_update_phase.restype = ci
    lib.cp_render.argtypes = [vp, ci, ci, vp, vp, vp, vp, vp]
    lib.cp_render.restype = ci
    lib.cp_mm_probe.argtypes = [ci, vp, vp, vp, ci, ci, ci, vp]
    lib.cp_mm_probe.restype = ci
    lib.cp_mm_split.argtypes = [ci, vp, vp, ci, vp]
    lib.cp_mm_split.restype = ci
    lib.cp_mma_probe.argtypes = [ci, vp, vp, vp, ci, ci, ci, vp]
    lib.cp_mma_probe.restype = ci
    lib.cp_mma_split.argtypes = [ci, vp, vp, ci, vp]
    lib.cp_mma_split.restype = ci
    load_library.load_s += time.perf_counter() - t1
    _lib = lib
    return lib


load_library.build_s = 0.0
load_library.load_s = 0.0
load_library.builds = 0


def struct_ptr(struct: ctypes.Structure) -> ctypes.c_void_p:
    """Host pointer to a ctypes structure, as the launchers take it (they
    copy the structure into the kernel's by-value parameter)."""
    return ctypes.cast(ctypes.pointer(struct), ctypes.c_void_p)


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if rc != 0:
        msg = lib.cp_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
