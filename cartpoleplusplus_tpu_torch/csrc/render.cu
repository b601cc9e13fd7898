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
// grayscale). Design "env-looped": a block takes 256 pixels x E envs (E =
// kEnvs = 8; 16 was no faster in gray and slower in RGB on the H100,
// PERF.md). Per camera, a
// thread loads its pixel's 14 (gray) or 16 (RGB) camera rows (the rays,
// t_g, the background, the slab half-widths and light terms; the same for
// every env) into registers once, then shades each of the block's envs
// from them, the envs' 6 columns in shared memory. The design it replaced
// (one thread per (env, pixel)) read those rows from L2 again for
// every env, ~1.8 GB per env-step at the pixels preset; this one reads
// them E times less. Each thread writes its pixel's channels of every
// camera side by side, so for each env a warp's stores are one contiguous
// run of the channels-last frame (N, H*W, cameras*channels), the layout
// the env stacks. One launch renders all R repeat snapshots of an
// env-step, stacked as N = R x B virtual envs, and every camera; a ragged
// last block of envs is masked.
//
// B11: the block's first threads compute each of its envs' conservative
// screen-row band per camera into shared memory (the reference computes
// it per block of 8 envs, the union of the same per-env bands), and a
// pixel whose row lies outside an env's band takes the background rows in
// place of the shade. The band provably holds every body pixel, and
// outside it the shade composite is the background exactly, so B11
// equals B10 bit for bit.
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
constexpr int kEnvs = 8;        // envs a block renders

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

// One pixel's camera rows R (stride npx): dx dy dz, 1/dx 1/dy 1/dz, t_g,
// the background (nch rows), the slab half-widths and the face-normal
// light terms. The same for every env.
struct PixRows {
  float dx, dy, dz, idx, idy, idz, t_g, bg[3], hax, hay, haz, nlx, nly, nlz;
};

__device__ __forceinline__ void load_rows(const RenderConsts& c,
                                          const float* __restrict__ R,
                                          int npx, PixRows& r) {
  r.dx = R[0];
  r.dy = R[npx];
  r.dz = R[2 * npx];
  r.idx = R[3 * npx];
  r.idy = R[4 * npx];
  r.idz = R[5 * npx];
  r.t_g = R[6 * npx];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) r.bg[ch] = ch < c.nch ? R[(7 + ch) * npx] : 0.0f;
  const float* const S = R + (7 + c.nch) * npx;  // after the background
  r.hax = S[0];
  r.hay = S[npx];
  r.haz = S[2 * npx];
  r.nlx = S[3 * npx];
  r.nly = S[4 * npx];
  r.nlz = S[5 * npx];
}

// env/pixels.py::shade_components for one pixel of one camera whose eye
// is (ex, ey, ez), from the pixel's rows, for the env at cart (cx, cy, cz)
// with pole axis (ux, uy, uz).
__device__ __forceinline__ void shade(const RenderConsts& c, float ex,
                                      float ey, float ez, const PixRows& r,
                                      float cx, float cy, float cz, float ux,
                                      float uy, float uz, float* v) {
  const float dx = r.dx, dy = r.dy, dz = r.dz;

  // --- cart
  const float qx = (cx - ex) * r.idx;
  const float qy = (cy - ey) * r.idy;
  const float qz = (cz - ez) * r.idz;
  const float tnx = qx - r.hax, txx = qx + r.hax;
  const float tny = qy - r.hay, txy = qy + r.hay;
  const float tnz = qz - r.haz, txz = qz + r.haz;
  const float t_near = fmaxf(tnx, fmaxf(tny, tnz));
  const float t_far = fminf(txx, fminf(txy, txz));
  const bool hit = (t_near <= t_far) && (t_far > 0.0f);
  const float t_c = hit ? (t_near > 0.0f ? t_near : t_far) : c.big;
  const float nl_c = (tnx == t_near) ? r.nlx : ((tny == t_near) ? r.nly : r.nlz);
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
  const bool cart_closer = t_c < r.t_g;
  const bool pole_closer = t_p < fminf(t_c, r.t_g);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    if (ch < c.nch) {
      float lum = cart_closer ? c.cart[ch] * shade_c : r.bg[ch];
      lum = pole_closer ? c.pole[ch] * shade_p : lum;
      v[ch] = clip01(lum);
    }
  }
}

// A block takes kThreads pixels x kEnvs envs. Each thread loads its pixel's rows of one camera once into registers and
// shades every env of the block from them; the envs' columns (and, for
// B11, their bands under every camera) sit in shared memory. A ragged
// last env block is masked.
template <bool kCull>
__global__ void __launch_bounds__(kThreads) render_env_kernel(
    const RenderConsts c, const int chunks, const int N,
    const float* __restrict__ cols, const float* __restrict__ rows,
    const float* __restrict__ cams, float* __restrict__ out) {
  const int n0i = static_cast<int>(blockIdx.x / chunks) * kEnvs;
  const int64_t n0 = n0i;
  const int pix = (blockIdx.x % chunks) * kThreads + threadIdx.x;
  const int ne = min(kEnvs, N - n0i);
  __shared__ float col_s[6 * kEnvs];
  __shared__ float band[2 * kMaxCams * kEnvs];
  if (threadIdx.x < 6 * ne) col_s[threadIdx.x] = cols[6 * n0 + threadIdx.x];
  __syncthreads();
  if (kCull) {
    for (int i = threadIdx.x; i < ne * c.ncam; i += kThreads) {
      const int e = i / c.ncam, cam = i - e * c.ncam;
      const float* col = col_s + 6 * e;
      float* b = band + 2 * (e * kMaxCams + cam);
      row_band(c, cams + cam * kCamFloats, col[0], col[1], col[2], col[3],
               col[4], col[5], b[0], b[1]);
    }
    __syncthreads();
  }
  if (pix >= c.npx) return;
  const int stride = c.ncam * c.nch;
  const float prow = static_cast<float>(pix / c.width);
  for (int cam = 0; cam < c.ncam; ++cam) {
    const float* const E = cams + cam * kCamFloats;
    const float ex = E[0], ey = E[1], ez = E[2];
    PixRows r;
    load_rows(c, rows + static_cast<int64_t>(cam) * c.nrows * c.npx + pix,
              c.npx, r);
    float* o = out + (n0 * c.npx + pix) * stride + cam * c.nch;
    for (int e = 0; e < ne; ++e, o += static_cast<int64_t>(c.npx) * stride) {
      const float* col = col_s + 6 * e;
      float v[3];
      bool inside = true;
      if (kCull) {
        const float* b = band + 2 * (e * kMaxCams + cam);
        inside = !(prow < b[0] || prow > b[1]);
      }
      if (inside) {
        shade(c, ex, ey, ez, r, col[0], col[1], col[2], col[3], col[4],
              col[5], v);
      } else {
        for (int ch = 0; ch < c.nch; ++ch) v[ch] = r.bg[ch];
      }
      for (int ch = 0; ch < c.nch; ++ch) o[ch] = v[ch];
    }
  }
}

template <bool kCull>
cudaError_t launch_env(const RenderConsts& c, int N, int chunks,
                       const float* cols, const float* rows,
                       const float* cams, float* out, cudaStream_t st) {
  const int64_t blocks =
      static_cast<int64_t>((N + kEnvs - 1) / kEnvs) * chunks;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  render_env_kernel<kCull><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      c, chunks, N, cols, rows, cams, out);
  return cudaGetLastError();
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      cull ? launch_env<true>(c, N, chunks, cols, rows, cams, out, st)
           : launch_env<false>(c, N, chunks, cols, rows, cams, out, st));
}

}  // extern "C"
