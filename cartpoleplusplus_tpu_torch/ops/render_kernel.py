"""Kernels B10 and B11, the per-pixel raycast renderer: the wrappers that
launch csrc/render.cu, and the dispatch the env renders through.

Replaces cartpoleplusplus_tpu/ops/render_kernel.py::_render_cam_kernel
(B10) and ::_render_cam_cull_kernel (B11). Both versions take the R repeat
snapshots of an env-step stacked as N = R x B virtual envs and return

    frames (N, H, W, C * num_cameras) float32 in [0, 1]

with the cameras stacked on channels — the contract of
env/pixels.py::render_all_cameras, which is their plain twin (with
`cull=True` for B11). B11 is reached as in the reference, through
CARTPOLE_RENDER_CULL=1, and is off by default.

The kernels take any width, height, batch and camera count, so there is
no coverage test and no fallback: where the reference asks `renderable`
and `obs_renderable` (its (8, 128) tiling rules), a CUDA tensor always
launches the kernel, and a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from ..env import pixels as px
from ..physics import CartPoleParams, PhysState
from . import _native


class RenderConsts(ctypes.Structure):
    """Mirror of `struct RenderConsts` in csrc/render.cu (same field
    order): env/pixels.py::SceneConsts and the frame geometry."""

    _fields_ = [(n, ctypes.c_float) for n in (
        "ll", "l2", "inv_ll", "rr", "rr_l2", "pivot_height", "lx", "ly",
        "lz", "big", "a2_guard", "n_eps")] + [
        ("cart", ctypes.c_float * 3), ("pole", ctypes.c_float * 3)] + [
        (n, ctypes.c_float) for n in (
            "cart_radius", "pole_radius", "band_eps", "height")] + [
        (n, ctypes.c_int) for n in ("width", "npx", "ncam", "nch", "nrows")]


def render_consts(p: CartPoleParams, cfg: px.RenderConfig) -> RenderConsts:
    """The kernels' constants, the same float32 values the twin uses."""
    k = px.SceneConsts(p, cfg)
    gray = cfg.grayscale
    nch = cfg.channels_per_camera
    c = RenderConsts(
        ll=k.ll, l2=k.l2, inv_ll=k.inv_ll, rr=k.rr, rr_l2=k.rr_l2,
        pivot_height=k.pivot_height, lx=k.light[0], ly=k.light[1],
        lz=k.light[2], big=k.big, a2_guard=np.float32(1e-9),
        n_eps=np.float32(1e-12), cart_radius=k.cart_radius,
        pole_radius=k.r, band_eps=k.band_eps, height=k.height,
        width=cfg.width, npx=cfg.width * cfg.height,
        ncam=len(cfg.cameras), nch=nch, nrows=6 + 1 + nch + 6)
    cart = (k.cart_gray,) * 3 if gray else k.cart_rgb
    pole = (k.pole_gray,) * 3 if gray else k.pole_rgb
    for i in range(3):
        c.cart[i], c.pole[i] = cart[i], pole[i]
    return c


@functools.lru_cache(maxsize=None)
def _camera_tables(cfg: px.RenderConfig, device: torch.device):
    """(rows (ncam, nrows, npx), cams (ncam, 10)) float32 on `device`: per
    camera its ray and static rows (env/pixels.py::camera_rows) and its
    eye, forward and up vectors and tan_u (for B11's band)."""
    rows, cams = [], []
    for cam in cfg.cameras:
        eye, r = px.camera_rows(cam, cfg, cfg.grayscale, device)
        rows.append(r)
        eye_b, fwd, _right, up, _tan_r, tan_u = px.camera_basis_np(
            cam, cfg.width, cfg.height)
        cams.append(list(eye_b) + list(fwd) + list(up) + [tan_u])
    return (torch.stack(rows).contiguous(),
            torch.tensor(np.asarray(cams, np.float32), device=device))


def _launch(p: CartPoleParams, cfg: px.RenderConfig, phys: PhysState,
            cull: bool) -> torch.Tensor:
    dev = phys.pos.device
    if dev.type != "cuda":
        raise ValueError(f"the render kernels run on cuda, not {dev}")
    n = phys.pos.shape[0]
    cols = torch.cat(px.env_columns(p, phys), dim=1).contiguous()
    rows, cams = _camera_tables(cfg, dev)
    nch = cfg.channels_per_camera * len(cfg.cameras)
    out = torch.empty((n, cfg.height, cfg.width, nch), dtype=torch.float32,
                      device=dev)
    lib = _native.load_library()
    consts = render_consts(p, cfg)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cp_render(_native.struct_ptr(consts), n, int(cull),
                           cols.data_ptr(), rows.data_ptr(),
                           cams.data_ptr(), out.data_ptr(), stream)
    _native.check(lib, rc, "render_culled" if cull else "render_frames")
    return out


def render_frames(p: CartPoleParams, cfg: px.RenderConfig,
                  phys: PhysState) -> torch.Tensor:
    """B10: every camera's frame of the N stacked snapshots, (N, H, W,
    C * num_cameras). A CUDA state launches the kernel on the current
    stream; a CPU state runs the plain twin (render_all_cameras)."""
    if phys.pos.device.type == "cpu":
        return px.render_all_cameras(p, phys, cfg)
    out = _launch(p, cfg, phys, cull=False)
    render_frames.launches += 1
    return out


def render_culled(p: CartPoleParams, cfg: px.RenderConfig,
                  phys: PhysState) -> torch.Tensor:
    """B11: render_frames with row-band culling, the same frames. A CPU
    state runs the culled twin (render_all_cameras(cull=True))."""
    if phys.pos.device.type == "cpu":
        return px.render_all_cameras(p, phys, cfg, cull=True)
    out = _launch(p, cfg, phys, cull=True)
    render_culled.launches += 1
    return out


render_frames.launches = 0
render_culled.launches = 0


def render(p: CartPoleParams, cfg: px.RenderConfig,
           phys: PhysState) -> torch.Tensor:
    """The env's renderer: B11 under CARTPOLE_RENDER_CULL=1 (the
    reference's opt-in), else B10."""
    # On a CUDA state B10 and B11 compute in float32 whatever
    # `cfg.dtype` says, as the reference's render kernel does
    # (ops/render_kernel.py:183-188 there): a "bfloat16" config gives the
    # float32 config's frames bit for bit. Only the plain twins, on a CPU
    # state, take the bfloat16 inputs (env/pixels.py::render).
    if os.environ.get("CARTPOLE_RENDER_CULL", "0") == "1":
        return render_culled(p, cfg, phys)
    return render_frames(p, cfg, phys)
