"""The port's renderer (env/pixels.py, the plain twin of kernels B10 and
B11, and the ops/render_kernel.py wrappers on CPU tensors) against the JAX
reference on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu.env import pixels as jpx
from cartpoleplusplus_tpu.ops import render_kernel as jrk
from cartpoleplusplus_tpu.physics import CartPoleParams as JParams
from cartpoleplusplus_tpu.physics import rest_state as jrest_state
from cartpoleplusplus_tpu_torch.env import pixels as tpx
from cartpoleplusplus_tpu_torch.ops import render_kernel as trk
from cartpoleplusplus_tpu_torch.physics import CartPoleParams, PhysState


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(2)


def _poses(b, seed, adversarial=True):
    """(pos (b, 3), s (b, 2)) float32: positions uniform in +-2.2 and tilts
    up to |s| = 0.995 (tests/test_pixels.py's adversarial poses), or the
    reference parity test's gentle row of poses."""
    if not adversarial:
        pos = np.zeros((b, 3), np.float32)
        pos[:, 0] = np.linspace(-1.0, 1.0, b)
        pos[:, 2] = 0.0978
        s = np.zeros((b, 2), np.float32)
        s[:, 0] = np.linspace(-0.25, 0.25, b)
        return pos, s
    rng = np.random.RandomState(seed)
    pos = np.stack([rng.uniform(-2.2, 2.2, b), rng.uniform(-2.2, 2.2, b),
                    np.full(b, 0.0978)], -1).astype(np.float32)
    s = rng.uniform(-0.99, 0.99, (b, 2)).astype(np.float32)
    nrm = np.sqrt((s ** 2).sum(-1, keepdims=True))
    s = np.where(nrm > 0.995, s * 0.995 / nrm, s).astype(np.float32)
    return pos, s


def _phys(pos, s):
    """The same poses as a JAX and a port PhysState."""
    jp = jrest_state(JParams(), batch_shape=(pos.shape[0],))
    jp = jp._replace(pos=jnp.asarray(pos), s=jnp.asarray(s))
    tp = PhysState(*(torch.from_numpy(np.array(x)) for x in jp))
    return jp, tp


def _cfgs(n, gray):
    return (jpx.RenderConfig(width=n, height=n, grayscale=gray),
            tpx.RenderConfig(width=n, height=n, grayscale=gray))


@pytest.mark.parametrize("size", [(16, 16), (48, 48), (40, 24)])
def test_numpy_helpers_bitwise_equal(size):
    """The copied numpy helpers give the reference's bits."""
    w, h = size
    assert tpx._light_np() == jpx._light_np()
    for cam in jpx.RenderConfig().cameras:
        tcam = tpx.CameraConfig(**vars(cam))
        for a, b in zip(jax.tree.leaves(tpx.camera_basis_np(tcam, w, h)),
                        jax.tree.leaves(jpx.camera_basis_np(cam, w, h))):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
        for a, b in zip(jax.tree.leaves(tpx.ray_constants_np(tcam, w, h)),
                        jax.tree.leaves(jpx.ray_constants_np(cam, w, h))):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
        for gray in (False, True):
            jc = jpx.RenderConfig(width=w, height=h, grayscale=gray)
            tc = tpx.RenderConfig(width=w, height=h, grayscale=gray)
            (jrows, jn), (trows, tn) = (jpx.static_rows_np(cam, jc, gray),
                                        tpx.static_rows_np(tcam, tc, gray))
            assert jn == tn and len(jrows) == len(trows) == 7 + jn
            for a, b in zip(trows, jrows):
                assert a.dtype == b.dtype == np.float32
                assert a.tobytes() == b.tobytes()
    assert tpx.pixel_obs_shape(CartPoleParams(), tpx.RenderConfig(
        grayscale=True)) == jpx.pixel_obs_shape(JParams(), jpx.RenderConfig(
            grayscale=True)) == (48, 48, 6)


@pytest.mark.parametrize("gray", [True, False])
@pytest.mark.parametrize("n", [16, 32])
def test_twin_matches_jax_op_by_op(n, gray):
    """render_all_cameras on adversarial poses against the reference's
    render_all_cameras evaluated op by op (jax.disable_jit: the same
    operations in the same order, no fusion), rtol 1e-5 / atol 1e-5."""
    pos, s = _poses(8, seed=n + gray)
    jphys, tphys = _phys(pos, s)
    jc, tc = _cfgs(n, gray)
    with jax.disable_jit():
        ref = np.asarray(jpx.render_all_cameras(JParams(), jphys, jc))
    got = tpx.render_all_cameras(CartPoleParams(), tphys, tc).numpy()
    assert got.shape == ref.shape == (8, n, n, 2 if gray else 6)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert np.abs(np.diff(got, axis=0)).max() > 0.05  # bodies in view


@pytest.mark.parametrize("gray", [True, False])
@pytest.mark.parametrize("n", [16, 32])
def test_twin_matches_jax_xla_and_pallas_interpret(n, gray):
    """The twin against the reference's jit-compiled XLA path and its
    Pallas kernel B10 in interpret mode, on the reference parity test's
    poses and on adversarial ones. XLA's fused evaluation rounds otherwise
    than the op-by-op one, which moves near-silhouette pixels (the pole's
    discriminant cancels there): every pixel within 1e-3, and all but 0.5%
    of them within 1e-5 (rtol 1e-5 / atol 1e-5 holds against the op-by-op
    reference, test_twin_matches_jax_op_by_op)."""
    jc, tc = _cfgs(n, gray)
    xla = jax.jit(lambda ph: jpx.render_all_cameras(JParams(), ph, jc))
    pallas = jax.jit(jrk.pallas_render_all(JParams(), jc, 8, interpret=True))
    for adversarial in (False, True):
        pos, s = _poses(8, seed=3 * n + gray, adversarial=adversarial)
        jphys, tphys = _phys(pos, s)
        got = tpx.render_all_cameras(CartPoleParams(), tphys, tc).numpy()
        for ref in (np.asarray(xla(jphys)), np.asarray(pallas(jphys))):
            assert got.shape == ref.shape
            err = np.abs(got - ref)
            assert err.max() <= 1e-3, err.max()
            assert (err > 1e-5).mean() <= 5e-3, (err > 1e-5).mean()


@pytest.mark.parametrize("cam", [0, 1])
def test_row_band_matches_jax(cam):
    """The per-env band twin against the reference's _row_band, which
    takes the min and max over an env block: per env and over the
    block."""
    pos, s = _poses(16, seed=7 + cam)
    jphys, tphys = _phys(pos, s)
    jc, tc = _cfgs(48, True)
    basis = jpx.camera_basis_np(jc.cameras[cam], 48, 48)
    tcols = tpx.env_columns(CartPoleParams(), tphys)
    lo, hi = tpx.row_band(CartPoleParams(), tc, basis, *tcols)
    jcols = [jnp.asarray(c.numpy()) for c in tcols]
    for i in range(16):
        jlo, jhi = jrk._row_band(JParams(), jc, basis,
                                 *[c[i:i + 1] for c in jcols])
        np.testing.assert_allclose([float(lo[i, 0]), float(hi[i, 0])],
                                   [float(jlo), float(jhi)], rtol=1e-6,
                                   atol=1e-5)
    jlo, jhi = jrk._row_band(JParams(), jc, basis, *jcols)
    np.testing.assert_allclose([float(lo.min()), float(hi.max())],
                               [float(jlo), float(jhi)], rtol=1e-6, atol=1e-5)


def test_culled_twin_matches_full_shade():
    """tests/test_pixels.py::test_render_cull_matches_full_shade for the
    twins: the row-band-culled render equals the full shade within 1e-6 on
    adversarial poses, while culling a real share of the pixels."""
    p = CartPoleParams()
    pos, s = _poses(24, seed=1)
    _, tphys = _phys(pos, s)
    cfg = tpx.RenderConfig(width=48, height=48, grayscale=True)
    culled = tpx.render_all_cameras(p, tphys, cfg, cull=True).numpy()
    full = tpx.render_all_cameras(p, tphys, cfg).numpy()
    np.testing.assert_allclose(culled, full, atol=1e-6)
    assert np.abs(np.diff(full, axis=0)).max() > 0.05
    lo, hi = tpx.row_band(p, cfg, tpx.camera_basis_np(cfg.cameras[0], 48, 48),
                          *tpx.env_columns(p, tphys))
    rows = torch.arange(48.0)[None, :]
    assert float(((rows < lo) | (rows > hi)).float().mean()) > 0.3


def test_wrappers_run_the_twins_on_cpu(monkeypatch):
    """render_frames (B10) and render_culled (B11) run the plain twins on
    CPU tensors without counting a launch; `render` picks B11 only under
    CARTPOLE_RENDER_CULL=1; the launch path refuses CPU tensors."""
    p = CartPoleParams()
    pos, s = _poses(6, seed=2)
    _, tphys = _phys(pos, s)
    cfg = tpx.RenderConfig(width=16, height=16, grayscale=True)
    full = tpx.render_all_cameras(p, tphys, cfg)
    n10, n11 = trk.render_frames.launches, trk.render_culled.launches
    assert torch.equal(trk.render_frames(p, cfg, tphys), full)
    assert torch.equal(trk.render_culled(p, cfg, tphys),
                       tpx.render_all_cameras(p, tphys, cfg, cull=True))
    calls = []
    monkeypatch.setattr(trk, "render_culled",
                        lambda *a: calls.append("B11") or full)
    monkeypatch.setattr(trk, "render_frames",
                        lambda *a: calls.append("B10") or full)
    monkeypatch.delenv("CARTPOLE_RENDER_CULL", raising=False)
    trk.render(p, cfg, tphys)
    monkeypatch.setenv("CARTPOLE_RENDER_CULL", "1")
    trk.render(p, cfg, tphys)
    assert calls == ["B10", "B11"]
    monkeypatch.undo()
    assert (trk.render_frames.launches, trk.render_culled.launches) == (n10,
                                                                        n11)
    with pytest.raises(ValueError, match="cuda"):
        trk._launch(p, cfg, tphys, cull=False)


@pytest.mark.parametrize("gray", [True, False])
def test_kernel_constants_are_the_twins(gray):
    """The constants B10/B11 take (RenderConsts) are the float32 values the
    twin folds (SceneConsts), and the camera tables hold each camera's
    rows in the twin's order."""
    p, cfg = CartPoleParams(), tpx.RenderConfig(width=16, height=8,
                                                grayscale=gray)
    c, k = trk.render_consts(p, cfg), tpx.SceneConsts(p, cfg)
    for name in ("ll", "l2", "inv_ll", "rr", "rr_l2", "pivot_height", "big",
                 "cart_radius", "band_eps", "height"):
        assert np.float32(getattr(c, name)) == getattr(k, name), name
    assert (c.width, c.npx, c.ncam, c.nch) == (16, 128, 2, 1 if gray else 3)
    assert c.nrows == 6 + 1 + c.nch + 6
    rows, cams = trk._camera_tables(cfg, torch.device("cpu"))
    assert rows.shape == (2, c.nrows, 128) and cams.shape == (2, 10)
    for i, cam in enumerate(cfg.cameras):
        _, r = tpx.camera_rows(cam, cfg, gray, torch.device("cpu"))
        assert torch.equal(rows[i], r)
        assert cams[i, :3].tolist() == [float(np.float32(v)) for v in cam.eye]
