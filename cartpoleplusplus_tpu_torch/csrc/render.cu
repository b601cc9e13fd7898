// Kernels B10 and B11: the per-pixel raycast renderer of the pixel
// observations, on Hopper. B11 is B10 with row-band culling; one kernel
// body, the culling a compile-time mode.
//
// Replaces cartpoleplusplus_tpu/ops/render_kernel.py::_render_cam_kernel
// (B10, reached through pallas_render, pallas_render_all and
// pallas_render_frames) and ::_render_cam_cull_kernel (B11, with _row_band,
// under CARTPOLE_RENDER_CULL=1). Per (env, pixel, camera): the ray against
// the cart box (sign-folded slab test, face-normal Lambert) and the pole
// capsule (cylinder and two end spheres, Lambert on the surface normal),
// composited over the precomputed ground/sky background, clipped to
// [0, 1]; one luminance plane per camera in grayscale, three otherwise.
// The plain twin is env/pixels.py::shade_components (and ::row_band for
// B11): this kernel follows it operation by operation (built with
// --fmad=false; sqrtf and the divides are IEEE; 1/sqrt is rsqrtf, the
// function torch.rsqrt runs on a CUDA device).
//
// Bound on the H100: ~130 float operations per pixel and camera against 4
// or 12 bytes of output, so operations bound it (at 2048 envs x 3 repeat
// snapshots x 2 cameras x 48 x 48, 3.7 GFLOP against 113 MB written in
// grayscale). Design (simple and exact first): one thread per (env,
// pixel); the thread loops over the cameras and writes the pixel's
// channels of every camera side by side, so a warp's stores are one
// contiguous run of the channels-last frame (N, H*W, cameras*channels) —
// the layout the env stacks. The env's 6 columns are the same address for
// the whole block (a broadcast load); the per-camera ray and static rows
// (14 or 16 rows of H*W floats, 129-147 KB per camera at 48 x 48) stay in
// L1/L2. One launch renders all R repeat snapshots of an env-step, stacked
// as N = R x B virtual envs, and every camera.
//
// B11: a block's first threads compute its env's conservative screen-row
// band per camera into shared memory (the reference computes it per block
// of 8 envs, the union of the same per-env bands), and every thread writes
// the background rows for a pixel whose row lies outside it, in place of
// the shade. The band provably holds every
// body pixel, and outside it the shade composite is the background
// exactly, so B11 equals B10 bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

// Mirror of ops/render_kernel.py::RenderConsts: env/pixels.py::SceneConsts
// folded on the host. Outside the anonymous namespace: cp_render takes it,
// and a parameter of an internal type gives the entry internal linkage.
struct RenderConsts {
  float ll, l2, inv_ll, rr, rr_l2, pivot_height;
  float lx, ly, lz, big, a2_guard, n_eps;
  float cart[3], pole[3];  // grayscale: [0] holds the channel mean
  float cart_radius, pole_radius, band_eps, height;
  int width, npx, ncam, nch, nrows;
};

namespace {

constexpr int kThreads = 256;
constexpr int kCamFloats = 10;  // eye (3), forward (3), up (3), tan_u
constexpr int kMaxCams = 8;     // cameras B11 keeps a band for

// env/pixels.py::row_band's sphere_band: the screen-ys interval of a sphere.
__device__ __forceinline__ void sphere_band(const RenderConsts& c,
                                            const float* E, float px,
                                            float py, float pz, float rr,
                                            float& lo, float& hi) {
  const float vx = px - E[0];
  const float vy = py - E[1];
  const float vz = pz - E[2];
  const float a = vx * E[3] + vy * E[4] + vz * E[5];
  const float cc = vx * E[6] + vy * E[7] + vz * E[8];
  const bool safe = (a - rr) > c.band_eps;
  const float ag = fmaxf(a - rr, c.band_eps);
  const float am = fmaxf(a, c.band_eps);
  const float tu = E[9];
  const float ys_c = cc / (am * tu);
  const float dy = rr * (1.0f + fabsf(cc) / am) / (ag * tu);
  lo = safe ? ys_c - dy : -4.0f;
  hi = safe ? ys_c + dy : 4.0f;
}

// env/pixels.py::row_band: (row_lo, row_hi) of the env under camera E.
__device__ __forceinline__ void row_band(const RenderConsts& c, const float* E,
                                         float cx, float cy, float cz,
                                         float sx, float sy, float w,
                                         float& row_lo, float& row_hi) {
  const float az = cz + c.pivot_height;
  float lo1, hi1, lo2, hi2, lo3, hi3;
  sphere_band(c, E, cx, cy, cz, c.cart_radius, lo1, hi1);
  sphere_band(c, E, cx, cy, az, c.pole_radius, lo2, hi2);
  sphere_band(c, E, cx + c.ll * sx, cy + c.ll * sy, az + c.ll * w,
              c.pole_radius, lo3, hi3);
  const float ys_lo = fminf(fminf(lo1, lo2), lo3);
  const float ys_hi = fmaxf(fmaxf(hi1, hi2), hi3);
  row_lo = (1.0f - ys_hi) * c.height * 0.5f - 0.5f - 1.5f;
  row_hi = (1.0f - ys_lo) * c.height * 0.5f - 0.5f + 1.5f;
}

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

// env/pixels.py::shade_components for one pixel of one camera: rows R
// (stride npx) hold dx dy dz, 1/dx 1/dy 1/dz, t_g, the background (nch
// rows), the slab half-widths and the face-normal light terms.
__device__ __forceinline__ void shade(const RenderConsts& c, const float* E,
                                      const float* __restrict__ R, int npx,
                                      float cx, float cy, float cz, float ux,
                                      float uy, float uz, float* v) {
  const float ex = E[0], ey = E[1], ez = E[2];
  const float dx = R[0], dy = R[npx], dz = R[2 * npx];
  const float idx = R[3 * npx], idy = R[4 * npx], idz = R[5 * npx];
  const float t_g = R[6 * npx];
  const float* const S = R + (7 + c.nch) * npx;  // after the background
  const float hax = S[0], hay = S[npx], haz = S[2 * npx];
  const float nlx = S[3 * npx], nly = S[4 * npx], nlz = S[5 * npx];

  // --- cart
  const float qx = (cx - ex) * idx;
  const float qy = (cy - ey) * idy;
  const float qz = (cz - ez) * idz;
  const float tnx = qx - hax, txx = qx + hax;
  const float tny = qy - hay, txy = qy + hay;
  const float tnz = qz - haz, txz = qz + haz;
  const float t_near = fmaxf(tnx, fmaxf(tny, tnz));
  const float t_far = fminf(txx, fminf(txy, txz));
  const bool hit = (t_near <= t_far) && (t_far > 0.0f);
  const float t_c = hit ? (t_near > 0.0f ? t_near : t_far) : c.big;
  const float nl_c = (tnx == t_near) ? nlx : ((tny == t_near) ? nly : nlz);
  const float shade_c = 0.45f + 0.55f * fmaxf(nl_c, 0.0f);

  // --- pole: capsule pivot -> tip
  const float az = cz + c.pivot_height;
  const float oax = ex - cx, oay = ey - cy, oaz = ez - az;
  const float uxl = c.ll * ux, uyl = c.ll * uy, uzl = c.ll * uz;
  const float bard = uxl * dx + uyl * dy + uzl * dz;
  const float baoa = uxl * oax + uyl * oay + uzl * oaz;
  const float rdoa = dx * oax + dy * oay + dz * oaz;
  const float oaoa = oax * oax + oay * oay + oaz * oaz;
  const float a2 = c.l2 - bard * bard;
  const float b2 = c.l2 * rdoa - baoa * bard;
  const float c2 = c.l2 * oaoa - baoa * baoa - c.rr_l2;
  const float h = b2 * b2 - a2 * c2;
  const float sq = sqrtf(fmaxf(h, 0.0f));
  const float a2g = fabsf(a2) < c.a2_guard ? c.a2_guard : a2;
  const float t_cyl = (-1.0f * b2 - sq) / a2g;
  const float y = baoa + t_cyl * bard;
  const bool cyl_ok = (h > 0.0f) && (y > 0.0f) && (y < c.l2) &&
                      (t_cyl > 0.0f);
  float t_p = cyl_ok ? t_cyl : c.big;
#pragma unroll
  for (int cap = 0; cap < 2; ++cap) {
    const float sx = cap ? oax - uxl : oax;
    const float sy = cap ? oay - uyl : oay;
    const float sz = cap ? oaz - uzl : oaz;
    const float bq = dx * sx + dy * sy + dz * sz;
    const float cq = sx * sx + sy * sy + sz * sz - c.rr;
    const float hq = bq * bq - cq;
    const float ts = -1.0f * bq - sqrtf(fmaxf(hq, 0.0f));
    t_p = fminf(t_p, (hq > 0.0f && ts > 0.0f) ? ts : c.big);
  }
  const float px = oax + t_p * dx;
  const float py = oay + t_p * dy;
  const float pz = oaz + t_p * dz;
  const float h_along = clip01((px * ux + py * uy + pz * uz) * c.inv_ll);
  const float nx = px - h_along * uxl;
  const float ny = py - h_along * uyl;
  const float nz = pz - h_along * uzl;
  const float nl_p = (nx * c.lx + ny * c.ly + nz * c.lz) *
                     rsqrtf(nx * nx + ny * ny + nz * nz + c.n_eps);
  const float shade_p = 0.45f + 0.55f * fmaxf(nl_p, 0.0f);

  // --- composite over the background
  const bool cart_closer = t_c < t_g;
  const bool pole_closer = t_p < fminf(t_c, t_g);
  for (int ch = 0; ch < c.nch; ++ch) {
    float lum = cart_closer ? c.cart[ch] * shade_c : R[(7 + ch) * npx];
    lum = pole_closer ? c.pole[ch] * shade_p : lum;
    v[ch] = clip01(lum);
  }
}

template <bool kCull>
__global__ void __launch_bounds__(kThreads) render_kernel(
    const RenderConsts c, const int chunks, const float* __restrict__ cols,
    const float* __restrict__ rows, const float* __restrict__ cams,
    float* __restrict__ out) {
  const int64_t n = blockIdx.x / chunks;
  const int pix = (blockIdx.x % chunks) * kThreads + threadIdx.x;
  const float* const col = cols + 6 * n;
  const float cx = col[0], cy = col[1], cz = col[2];
  const float sx = col[3], sy = col[4], w = col[5];
  // B11: a block holds one env, so its first ncam threads compute the
  // env's band under each camera once for the whole block.
  __shared__ float band[2 * kMaxCams];
  if (kCull) {
    if (threadIdx.x < c.ncam) {
      row_band(c, cams + threadIdx.x * kCamFloats, cx, cy, cz, sx, sy, w,
               band[2 * threadIdx.x], band[2 * threadIdx.x + 1]);
    }
    __syncthreads();
  }
  if (pix >= c.npx) return;
  float* const o = out + (n * c.npx + pix) * (c.ncam * c.nch);
  for (int cam = 0; cam < c.ncam; ++cam) {
    const float* const E = cams + cam * kCamFloats;
    const float* const R =
        rows + static_cast<int64_t>(cam) * c.nrows * c.npx + pix;
    float v[3];
    bool inside = true;
    if (kCull) {
      const float row = static_cast<float>(pix / c.width);
      inside = !(row < band[2 * cam] || row > band[2 * cam + 1]);
    }
    if (inside) {
      shade(c, E, R, c.npx, cx, cy, cz, sx, sy, w, v);
    } else {
      for (int ch = 0; ch < c.nch; ++ch) v[ch] = R[(7 + ch) * c.npx];
    }
    for (int ch = 0; ch < c.nch; ++ch) o[cam * c.nch + ch] = v[ch];
  }
}

}  // namespace

extern "C" {

// N virtual envs (the R repeat snapshots of an env-step stacked env-major):
// cols (N, 6) = (x, y, z, sx, sy, w); rows (ncam, nrows, npx) = per camera
// the 6 ray rows and the static rows of env/pixels.py::static_rows_np; cams
// (ncam, 10) = eye, forward, up, tan_u; out (N, npx, ncam * nch) float32.
// cull != 0 launches B11, else B10.
int cp_render(const RenderConsts* consts, int N, int cull, const float* cols,
              const float* rows, const float* cams, float* out,
              void* stream) {
  const RenderConsts c = *consts;
  if (N <= 0 || c.npx <= 0 || c.ncam <= 0 || c.ncam > kMaxCams ||
      c.nch < 1 || c.nch > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (c.npx + kThreads - 1) / kThreads;
  const int64_t blocks = static_cast<int64_t>(N) * chunks;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cull) {
    render_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        c, chunks, cols, rows, cams, out);
  } else {
    render_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        c, chunks, cols, rows, cams, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
