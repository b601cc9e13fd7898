"""Build and load the hand-written CUDA kernels (csrc/*.cu).

nvcc compiles every csrc/*.cu into one shared library with a plain C
interface, loaded with ctypes. No PyTorch headers are involved, so the
build takes seconds. The library is built at first use into `_build/`
next to the package sources and rebuilt when a source is newer. A failed
build, a failed load or a failed launch raises: there is no fallback.

Numerics: `--fmad=false` keeps nvcc from contracting a*b+c into an FMA,
and no fast-math flag is set, so division and sqrt are IEEE and
logf/cosf/sinf/tanhf are the accurate CUDA math library functions. The
kernels then follow the plain torch twins operation by operation, and a
termination threshold does not flip on a contraction.
"""

from __future__ import annotations

import ctypes
import glob
import math
import os
import shutil
import subprocess
import time

from ..physics.params import CartPoleParams

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libcartpole_kernels.so")
BUILD_LOG = os.path.join(BUILD_DIR, "build.log")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lib = None


class EnvConsts(ctypes.Structure):
    """Mirror of `struct EnvConsts` in csrc/cartpole_env.cuh (same field
    order). Each float is the float32 rounding of the Python-float
    subexpression that the torch and JAX code fold before touching a
    tensor, so the kernels see the same constants."""

    _fields_ = [(n, ctypes.c_float) for n in (
        "dt", "vel_max", "s_norm_max", "w_min2",
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
        "has_linear_damping", "has_angular_damping", "has_push")]


MAX_LAYERS = 4  # kMaxLayers in csrc/policy_rollout.cu


class ActorDims(ctypes.Structure):
    """Mirror of `struct ActorDims` in csrc/policy_rollout.cu."""

    _fields_ = [("num_layers", ctypes.c_int), ("obs_dim", ctypes.c_int),
                ("width", ctypes.c_int),
                ("hidden", ctypes.c_int * MAX_LAYERS)]


def env_consts(p: CartPoleParams) -> EnvConsts:
    """The folded constants of physics/dynamics.py and env/compute.py."""
    mt, jc, kg, l = p.total_mass, p.coupling, p.pole_gen_inertia, p.half_length
    return EnvConsts(
        dt=p.dt, vel_max=p.vel_max, s_norm_max=p.s_norm_max,
        w_min2=p.w_min * p.w_min,
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
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    with open(BUILD_LOG, "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0


def load_library() -> ctypes.CDLL:
    """The kernel library, built first if missing or stale."""
    global _lib
    if _lib is not None:
        return _lib
    if _stale():
        build()
    lib = ctypes.CDLL(LIB_PATH)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cp_error_string.argtypes = [ci]
    lib.cp_error_string.restype = ctypes.c_char_p
    lib.cp_fused_rollout_blocks.argtypes = [ci]
    lib.cp_fused_rollout_blocks.restype = ci
    lib.cp_fused_rollout.argtypes = [vp, ci, ci] + [vp] * 15 + [vp]
    lib.cp_fused_rollout.restype = ci
    lib.cp_policy_rollout.argtypes = ([vp, vp, vp, cf, cf, ci, ci, ci]
                                      + [vp] * 21 + [vp])
    lib.cp_policy_rollout.restype = ci
    _lib = lib
    return lib


def struct_ptr(struct: ctypes.Structure) -> ctypes.c_void_p:
    """Host pointer to a ctypes structure, as the launchers take it (they
    copy the structure into the kernel's by-value parameter)."""
    return ctypes.cast(ctypes.pointer(struct), ctypes.c_void_p)


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if rc != 0:
        msg = lib.cp_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
