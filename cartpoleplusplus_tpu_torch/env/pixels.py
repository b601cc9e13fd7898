"""Batched rendering of the scene for pixel observations
(cartpoleplusplus_tpu/env/pixels.py in torch).

The scene is three analytic primitives (ground plane, cart box, pole
capsule), so a frame is a per-pixel ray cast: camera rays are constants of
the fixed cameras, and per env only two ray-body intersections and a
Lambert shade remain. Everything that depends on the rays alone (ground
hit, background, the cart's slab half-widths and face-normal light terms)
is precomputed per camera by the numpy helpers below, copied verbatim from
the reference so that their float32/float64 promotions give the same bits.

`shade_components` is the plain twin of kernels B10 and B11
(csrc/render.cu): the reference's operations in the reference's order,
elementwise over env columns (B, 1) against pixel rows (1, H*W).
`row_band` is the twin of B11's conservative screen-row bounds.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..physics import CartPoleParams, PhysState, pole_w

_BIG = 1e9


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """A fixed pinhole camera looking at `target` from `eye`."""

    eye: tuple = (0.0, -2.4, 1.3)
    target: tuple = (0.0, 0.0, 0.6)
    up: tuple = (0.0, 0.0, 1.0)
    fov_deg: float = 45.0


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render settings for the pixel-observation variant.

    Two default cameras at 90 degrees (front and side) mirror the
    reference's use of a second camera to disambiguate the y axis.
    """

    width: int = 48
    height: int = 48
    cameras: tuple = (
        CameraConfig(eye=(0.0, -2.4, 1.3)),
        CameraConfig(eye=(-2.4, 0.0, 1.3)),
    )
    grayscale: bool = False
    # Visual sizes (match the physics footprint; purely cosmetic beyond it).
    cart_half_extents: tuple = (0.25, 0.25, 0.1)
    pole_radius: float = 0.06
    # Ray-cast compute dtype. The port renders in float32 only; the
    # reference's "bfloat16" is rejected by CartPole3D.
    dtype: str = "float32"
    # uint8 observations: the env quantizes rendered frames to 0..255 at
    # obs-assembly time; the pixel encoders scale uint8 input by 1/255.
    obs_uint8: bool = False
    # Frame-difference observations: stack [latest frame, 0.5 * gain *
    # (f_r - f_{r-1}) + 0.5 for each consecutive pair] instead of the R raw
    # frames (same channel count, the motion made explicit).
    frame_diff: bool = False
    # Contrast gain on the diff planes (encode = clip(0.5 + 0.5*gain*d)).
    frame_diff_gain: float = 1.0

    @property
    def channels_per_camera(self) -> int:
        return 1 if self.grayscale else 3


# Scene constants, as the reference defines them.
_LIGHT = (0.4, -0.3, 0.85)
_CART_COL = (0.85, 0.25, 0.2)
_POLE_COL = (0.2, 0.45, 0.9)
_SKY_COL = (0.7, 0.8, 0.95)


def _light_np():
    import numpy as np

    l = np.asarray(_LIGHT, np.float32)
    return tuple(np.float32(v) for v in (l / np.sqrt((l * l).sum())))


def camera_basis_np(cam: CameraConfig, width: int, height: int):
    """Orthonormal camera basis + tangent scales as np.float32 scalars:
    (eye(3), fwd(3), right(3), up(3), tan_r, tan_u) with the SAME
    conventions as ray_constants_np: d = fwd + xs*tan_r*right +
    ys*tan_u*up, xs in [-1,1] across width, ys = 1-(row+0.5)/H*2.
    Used by the render kernel's conservative screen-row body bounds."""
    import math as m

    import numpy as np

    eye = np.asarray(cam.eye, np.float32)
    fwd = np.asarray(cam.target, np.float32) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(cam.up, np.float32))
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    tan_r = np.float32(m.tan(m.radians(cam.fov_deg) / 2.0))
    tan_u = np.float32(tan_r * height / width)
    return (tuple(np.float32(v) for v in eye),
            tuple(np.float32(v) for v in fwd),
            tuple(np.float32(v) for v in right),
            tuple(np.float32(v) for v in up),
            tan_r, tan_u)


def ray_constants_np(cam: CameraConfig, width: int, height: int):
    """Numpy mirror of camera_rays, flattened: ((ex, ey, ez),
    (dx, dy, dz), (inv_dx, inv_dy, inv_dz)) with d*/inv_* of shape
    (1, H*W) f32. Static per camera — kernel operands, not traced."""
    import math as m

    import numpy as np

    eye = np.asarray(cam.eye, np.float32)
    fwd = np.asarray(cam.target, np.float32) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(cam.up, np.float32))
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    tan = m.tan(m.radians(cam.fov_deg) / 2.0)
    xs = (np.arange(width, dtype=np.float32) + 0.5) / width * 2.0 - 1.0
    ys = 1.0 - (np.arange(height, dtype=np.float32) + 0.5) / height * 2.0
    d = (fwd[None, None]
         + xs[None, :, None] * (tan * right)[None, None]
         + ys[:, None, None] * (tan * height / width * up)[None, None])
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    d = d.reshape(-1, 3).astype(np.float32)
    guard = np.where(np.abs(d) < 1e-9, 1e-9, d)
    inv = (1.0 / guard).astype(np.float32)
    return (tuple(np.float32(v) for v in eye),
            tuple(d[None, :, i] for i in range(3)),
            tuple(inv[None, :, i] for i in range(3)))


def static_rows_np(cam: CameraConfig, cfg: RenderConfig, gray: bool):
    """Every state-independent per-pixel quantity, hoisted to trace time.

    The ground plane, the sky, the camera rays and the light are all
    static, so everything that depends only on them is a pure function
    of the pixel index — precomputed here (numpy, f32 throughout) and
    fed to the shade as constant (1, H*W) rows instead of being
    recomputed per env per frame on the VPU. Rows, in order:

      t_g            ground hit distance (_BIG at miss) — deletes the
                     plane test + checkerboard floor/mod chain;
      bg (1 or 3)    background composite: checkerboard shade where the
                     ground is hit, sky color where not (1 luminance
                     row when `gray`, else 3 RGB rows) — deletes the
                     final sky select;
      ha_x/y/z       cart_half_extent * |1/d| per axis — the slab
                     min/max over the ± faces collapses to q ∓ ha
                     (sign-folded slab test);
      nl_x/y/z       -sign(d)·light per axis — the cart face-normal
                     Lambert dot, already resolved per pixel.

    Returns (rows, n_bg) with rows a flat tuple of (1, H*W) f32 arrays.
    """
    import numpy as np

    f = np.float32
    eye, (dx, dy, dz), (idx_, idy_, idz_) = ray_constants_np(
        cam, cfg.width, cfg.height)
    ex, ey, ez = eye
    lx, ly, lz = _light_np()
    t = f(-1.0) * ez * idz_
    hit = (dz < f(-1e-6)) & (t > f(0.0))
    t_g = np.where(hit, t, f(_BIG)).astype(np.float32)
    checker = np.mod(np.floor(ex + t_g * dx) + np.floor(ey + t_g * dy),
                     f(2.0))
    shade_up = f(0.45 + 0.55 * max(float(lz), 0.0))
    g_lum = ((f(0.35) + f(0.25) * checker) * shade_up).astype(np.float32)
    if gray:
        sky = f(sum(_SKY_COL) / 3.0)
        bg = (np.where(hit, g_lum, sky).astype(np.float32),)
    else:
        bg = tuple(np.where(hit, g_lum, f(c)).astype(np.float32)
                   for c in _SKY_COL)
    hx, hy, hz = (f(v) for v in cfg.cart_half_extents)
    ha = (np.abs(idx_) * hx, np.abs(idy_) * hy, np.abs(idz_) * hz)
    nl = (-np.sign(dx) * lx, -np.sign(dy) * ly, -np.sign(dz) * lz)
    rows = (t_g,) + bg + tuple(a.astype(np.float32) for a in ha + nl)
    return rows, len(bg)


class SceneConsts:
    """The float32 scalars of `shade_components` and `row_band`, folded on
    the host as the reference folds them (numpy float32 arithmetic, or a
    Python double rounded once where the reference writes f(expression)).
    Kernels B10 and B11 take the same values (ops/render_kernel.py)."""

    def __init__(self, p: CartPoleParams, cfg: RenderConfig):
        f = np.float32
        self.light = _light_np()
        self.big = f(_BIG)
        self.ll = f(p.pole_length)
        self.l2 = f(p.pole_length * p.pole_length)
        self.inv_ll = f(1.0 / p.pole_length)
        self.r = f(cfg.pole_radius)
        self.rr = self.r * self.r
        self.rr_l2 = self.r * self.r * self.l2
        self.pivot_height = f(p.pivot_height)
        self.cart_gray = f(sum(_CART_COL) / 3.0)
        self.pole_gray = f(sum(_POLE_COL) / 3.0)
        self.cart_rgb = tuple(f(v) for v in _CART_COL)
        self.pole_rgb = tuple(f(v) for v in _POLE_COL)
        # row_band: the cart's circumscribed sphere, the pole's end spheres
        self.cart_radius = f(float(np.linalg.norm(np.asarray(
            cfg.cart_half_extents, np.float32))))
        self.band_eps = f(0.2)
        self.height = f(cfg.height)


def shade_components(p: CartPoleParams, cfg: RenderConfig, eye,
                     dx, dy, dz, idx_, idy_, idz_, static,
                     cx, cy, cz, ux, uy, uz, gray: bool = False):
    """The full per-pixel raycast + Lambert shade, all-elementwise: the
    plain twin of kernel B10.

    Ray components (dx, dy, dz), their reciprocals and the `static` rows
    (static_rows_np) are (1, H*W) tensors; the env components cx..uz are
    (B, 1) columns (pole axis (ux, uy, uz) = (sx, sy, w)). Every operation
    is the reference's, in its order, on float32 tensors with float32
    constants. Returns (r, g, b) in [0, 1], or a single luminance plane
    when `gray`."""
    k = SceneConsts(p, cfg)
    fl = float  # float32 constants, exactly representable as Python floats
    ex, ey, ez = (fl(v) for v in eye)
    lx, ly, lz = (fl(v) for v in k.light)
    big = fl(k.big)
    n_bg = 1 if gray else 3
    t_g = static[0]
    bg = static[1:1 + n_bg]
    hax, hay, haz, nlx, nly, nlz = static[1 + n_bg:]

    # --- cart: sign-folded slab test, face-normal Lambert.
    qx = (cx - ex) * idx_
    qy = (cy - ey) * idy_
    qz = (cz - ez) * idz_
    tnx = qx - hax
    txx = qx + hax
    tny = qy - hay
    txy = qy + hay
    tnz = qz - haz
    txz = qz + haz
    t_near = torch.maximum(tnx, torch.maximum(tny, tnz))
    t_far = torch.minimum(txx, torch.minimum(txy, txz))
    hit = (t_near <= t_far) & (t_far > 0.0)
    t_c = torch.where(hit, torch.where(t_near > 0.0, t_near, t_far), big)
    nl_c = torch.where(tnx == t_near, nlx, torch.where(tny == t_near, nly,
                                                       nlz))
    shade_c = 0.45 + 0.55 * torch.clamp(nl_c, min=0.0)

    # --- pole: capsule pivot -> tip (|u| = 1, so |b-a|^2 = L^2 static).
    ll, l2, inv_ll = fl(k.ll), fl(k.l2), fl(k.inv_ll)
    ax = cx
    ay = cy
    az = cz + fl(k.pivot_height)
    oax = ex - ax
    oay = ey - ay
    oaz = ez - az
    uxl = ll * ux
    uyl = ll * uy
    uzl = ll * uz
    bard = uxl * dx + uyl * dy + uzl * dz
    baoa = uxl * oax + uyl * oay + uzl * oaz
    rdoa = dx * oax + dy * oay + dz * oaz
    oaoa = oax * oax + oay * oay + oaz * oaz
    a2 = l2 - bard * bard
    b2 = l2 * rdoa - baoa * bard
    c2 = l2 * oaoa - baoa * baoa - fl(k.rr_l2)
    h = b2 * b2 - a2 * c2
    sq = torch.sqrt(torch.clamp(h, min=0.0))
    a2g = torch.where(torch.abs(a2) < 1e-9, fl(np.float32(1e-9)), a2)
    t_cyl = (-1.0 * b2 - sq) / a2g
    y = baoa + t_cyl * bard
    cyl_ok = (h > 0.0) & (y > 0.0) & (y < l2) & (t_cyl > 0.0)
    t_p = torch.where(cyl_ok, t_cyl, big)
    for sx_, sy_, sz_ in ((oax, oay, oaz),
                          (oax - uxl, oay - uyl, oaz - uzl)):
        bq = dx * sx_ + dy * sy_ + dz * sz_
        cq = sx_ * sx_ + sy_ * sy_ + sz_ * sz_ - fl(k.rr)
        hq = bq * bq - cq
        ts = -1.0 * bq - torch.sqrt(torch.clamp(hq, min=0.0))
        t_p = torch.minimum(t_p, torch.where((hq > 0.0) & (ts > 0.0), ts,
                                             big))
    px_ = oax + t_p * dx
    py_ = oay + t_p * dy
    pz_ = oaz + t_p * dz
    h_along = torch.clamp((px_ * ux + py_ * uy + pz_ * uz) * inv_ll, 0.0,
                          1.0)
    nx_ = px_ - h_along * uxl
    ny_ = py_ - h_along * uyl
    nz_ = pz_ - h_along * uzl
    nl_p = ((nx_ * lx + ny_ * ly + nz_ * lz)
            * torch.rsqrt(nx_ * nx_ + ny_ * ny_ + nz_ * nz_
                          + fl(np.float32(1e-12))))
    shade_p = 0.45 + 0.55 * torch.clamp(nl_p, min=0.0)

    # --- composite: closest-so-far over the precomputed background.
    if gray:
        (lum0,) = bg
        closer = t_c < t_g
        lum = torch.where(closer, fl(k.cart_gray) * shade_c, lum0)
        t_hit = torch.minimum(t_c, t_g)
        closer = t_p < t_hit
        lum = torch.where(closer, fl(k.pole_gray) * shade_p, lum)
        return (torch.clamp(lum, 0.0, 1.0),)
    out = []
    t_hit = torch.minimum(t_c, t_g)
    for cc, pc, bgc in zip(k.cart_rgb, k.pole_rgb, bg):
        v = torch.where(t_c < t_g, fl(cc) * shade_c, bgc)
        v = torch.where(t_p < t_hit, fl(pc) * shade_p, v)
        out.append(torch.clamp(v, 0.0, 1.0))
    return tuple(out)


def row_band(p: CartPoleParams, cfg: RenderConfig, basis,
             cx, cy, cz, sx, sy, w):
    """Conservative screen-row interval containing every body pixel, per
    env: (row_lo, row_hi), each shaped like the env columns — the twin of
    B11's band and of the reference's `_row_band`
    (ops/render_kernel.py:52), which takes the min and max over an env
    block of the same per-env values.

    The cart is bounded by its circumscribed sphere and the pole capsule
    by its two end spheres; for a sphere of radius R at camera depth a and
    vertical offset c every point lies within R (1 + |c|/a) / ((a - R)
    tan_u) of ys(C), and a sphere within 0.2 of the camera plane takes
    the full frame. +-1.5 rows of margin absorb the pixel-centre offset
    and float32 rounding."""
    k = SceneConsts(p, cfg)
    fl = float
    (ex, ey, ez), (fx, fy, fz), _right, (ux_, uy_, uz_), _tr, tu = (
        tuple(fl(v) for v in part) if isinstance(part, tuple) else fl(part)
        for part in basis)
    eps = fl(k.band_eps)

    def sphere_band(px_, py_, pz_, rr):
        vx = px_ - ex
        vy = py_ - ey
        vz = pz_ - ez
        a = vx * fx + vy * fy + vz * fz
        c = vx * ux_ + vy * uy_ + vz * uz_
        safe = (a - rr) > eps
        ag = torch.clamp(a - rr, min=eps)
        am = torch.clamp(a, min=eps)
        ys_c = c / (am * tu)
        dy = rr * (1.0 + torch.abs(c) / am) / (ag * tu)
        lo = torch.where(safe, ys_c - dy, -4.0)
        hi = torch.where(safe, ys_c + dy, 4.0)
        return lo, hi

    rc, rp, ll = fl(k.cart_radius), fl(k.r), fl(k.ll)
    az = cz + fl(k.pivot_height)
    b1 = sphere_band(cx, cy, cz, rc)
    b2 = sphere_band(cx, cy, az, rp)
    b3 = sphere_band(cx + ll * sx, cy + ll * sy, az + ll * w, rp)
    ys_lo = torch.minimum(torch.minimum(b1[0], b2[0]), b3[0])
    ys_hi = torch.maximum(torch.maximum(b1[1], b2[1]), b3[1])
    # row = (1 - ys) * H/2 - 0.5: larger ys is higher on screen.
    hh = fl(k.height)
    row_lo = (1.0 - ys_hi) * hh * 0.5 - 0.5
    row_hi = (1.0 - ys_lo) * hh * 0.5 - 0.5
    return row_lo - 1.5, row_hi + 1.5


@functools.lru_cache(maxsize=None)
def camera_rows(cam: CameraConfig, cfg: RenderConfig, gray: bool,
                device: torch.device):
    """(eye, rows): the camera's eye (np.float32 x3) and its 6 ray rows
    followed by the static rows, as one (n_rows, H*W) float32 tensor on
    `device` (made once per camera, config and device)."""
    eye, dcomp, icomp = ray_constants_np(cam, cfg.width, cfg.height)
    static, _ = static_rows_np(cam, cfg, gray)
    rows = np.concatenate(dcomp + icomp + tuple(static), axis=0)
    return eye, torch.from_numpy(rows.astype(np.float32)).to(device)


def env_columns(p: CartPoleParams, phys: PhysState):
    """The six (B, 1) env columns a frame depends on: cart position (x, y,
    z) and the pole axis (sx, sy, w)."""
    sx, sy = phys.s[..., 0], phys.s[..., 1]
    w = pole_w(p, sx, sy)
    return [c.to(torch.float32)[:, None] for c in (
        phys.pos[..., 0], phys.pos[..., 1], phys.pos[..., 2], sx, sy, w)]


def render(p: CartPoleParams, phys: PhysState, cfg: RenderConfig,
           cam: CameraConfig, gray: bool = False,
           cull: bool = False) -> torch.Tensor:
    """One camera view of every env: (B, H, W, 3) float32 in [0, 1]
    ((B, H, W, 1) luminance when `gray`). With `cull`, pixels outside each
    env's `row_band` take the background row instead of the shade: the
    twin of B11, equal to the full shade wherever the band is sound."""
    eye, rows = camera_rows(cam, cfg, gray, phys.pos.device)
    rays = list(rows[:6, None])
    static = tuple(rows[6:, None])
    b = phys.pos.shape[0]
    cols = env_columns(p, phys)
    chans = shade_components(p, cfg, eye, *rays, static, *cols, gray=gray)
    if cull:
        lo, hi = row_band(p, cfg, camera_basis_np(cam, cfg.width,
                                                  cfg.height), *cols)
        pix_row = (torch.arange(cfg.width * cfg.height, device=lo.device)
                   // cfg.width).to(torch.float32)[None, :]
        out = (pix_row < lo) | (pix_row > hi)
        chans = tuple(torch.where(out, bgc, ch)
                      for ch, bgc in zip(chans, static[1:1 + len(chans)]))
    img = torch.stack(chans, dim=-1).reshape(b, cfg.height, cfg.width,
                                             len(chans))
    return img


def render_all_cameras(p: CartPoleParams, phys: PhysState,
                       cfg: RenderConfig, cull: bool = False) -> torch.Tensor:
    """(B, H, W, C*num_cameras) — cameras stacked on channels (C = 3 RGB,
    or 1 when cfg.grayscale)."""
    views = [render(p, phys, cfg, cam, gray=cfg.grayscale, cull=cull)
             for cam in cfg.cameras]
    return torch.cat(views, dim=-1)


def pixel_obs_shape(p: CartPoleParams, cfg: RenderConfig) -> tuple:
    """(H, W, C): repeats and cameras stack on channels."""
    c = cfg.channels_per_camera * len(cfg.cameras) * p.action_repeats
    return (cfg.height, cfg.width, c)
