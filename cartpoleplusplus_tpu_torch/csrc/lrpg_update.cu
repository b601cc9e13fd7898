// Kernel B9: one Adam step of the LRPG softmax policy gradient over the
// whole rollout window, on Hopper.
//
// Replaces cartpoleplusplus_tpu/ops/learner_kernel.py::_lrpg_update_kernel
// (the Pallas TPU kernel, made by lrpg_update_phase). For every row of the
// window (obs (N, F), action (N,) int32, advantage (N,)): the PolicyMLP
// forward (L x [Dense + LayerNorm + relu], a 5-wide linear head), the
// softmax, the closed-form gradient of -logp[a] adv - c H at the logits,
//   dlogits = (adv (p - onehot_a) + c p (logp + H)) / N,
// and its backward through the head and the LayerNorm/relu layers. Every
// gradient is summed over the N rows, one Adam step is applied to params,
// m and v in place, and loss = sum(-logp[a] adv - c H) / N. The plain twin
// is ops/learner_kernel.py::lrpg_update_phase_math.
//
// Bound on the H100: float32 arithmetic, ~37 kFLOP of matrix products per
// row at hidden (64, 64) (forward, weight gradients, the backward of the
// head and of layer 1), ~4.9 GFLOP over the default 131,072-row window,
// ~73 us at 67 TFLOP/s; the window is ~23 MB (~7 us at 3.35 TB/s).
//
// Design. Pass 1: each of at most kPgMaxBlocks blocks takes a fixed slice
// of rows and walks it in tiles of kPgRows = 64 rows. Activations are
// feature-major (element (f, r) at f * kPgLd + r), so that a thread reads
// 4 neighbouring rows of a feature as one 16-byte load. Every product is
// register-tiled: a thread owns 4 rows x 4 output columns of a layer (or,
// for a weight gradient, 4 output rows x 4 inputs summed over the tile's
// rows) and loads its operands once per k. On the shared-memory route the
// torso and head weights are copied once per block, transposed to (in,
// out) with the output columns padded to 4, and stay resident with the
// block's gradient accumulators (one float per parameter and the loss) for
// the block's whole slice; the next tile's obs rows stream in by cp.async
// while the current one is computed; the accumulators go to the block's
// partial row once, at the end. At hidden (64, 64) that is 168 KB. A
// network for which that does not fit takes the workspace route: the same
// code with the weights read from the group buffer, and the activations
// and accumulators in the block's slice of the workspace, so B9 takes any
// depth >= 1 and any width, as the reference's kernel. Both routes run the
// same arithmetic in the same order and give the same bits. Pass 2: one
// thread per parameter element sums the blocks' rows in block order and
// applies Adam. Every sum runs in a fixed order, there are no float
// atomics, and the block count is fixed by N and the widths alone (at most
// kPgMaxBlocks, and a workspace of at most kPgWorkFloats floats), so two
// runs give the same bits on any card. The widths and the parameter
// offsets are the learners' device table (ops/learner_kernel.py::
// _learner_table); only its LayerNorm constants and helpers are shared with
// B3/B5/B7 (learner_stages.cuh).
#include "learner_stages.cuh"

// Mirror of ops/_native.py::PgDims.
struct PgDims {
  int obs_dim, n_rows;
  int spill;   // 1: the workspace route
  int sum_h, hmax, wt;  // the widths' sum and max, the floats of the
                        // transposed weights: set by the launcher
  Torso torso;
  NetLayout net;
};

// Mirror of ops/_native.py::PgConsts: the float32 constants, folded on the
// host (bc1, bc2: the Adam bias corrections of this step's count).
struct PgConsts {
  float inv_n, coef, lr, b1, omb1, b2, omb2, eps, bc1, bc2, ln_eps;
};

namespace {

constexpr int kPgActions = 5;               // ops/learner_kernel.py::NUM_ACTIONS
constexpr int kPgHeadLd = 8;                // the head's padded width
constexpr int kPgMaxBlocks = 128;           // pass-1 blocks at most
// Floats of workspace at most (about blocks x (P + 1 + tile)): wide
// networks take fewer blocks (ops/learner_kernel.py::PG_WORK_FLOATS).
constexpr long long kPgWorkFloats = 1LL << 27;
constexpr int kPgRows = 64;                 // rows of a tile
constexpr int kPgLd = kPgRows + 4;          // feature stride of a tile
// The shared memory one H100 block may use (ops/_native.py::MAX_SMEM).
constexpr int kMaxSmem = 232448;
static_assert(kThreads == 4 * kPgRows, "4 threads per row");

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// A tile's feature-major buffers ((features, kPgLd) each): the obs rows
// (two on the shared-memory route, the next tile's streaming in), every
// layer's pre-LayerNorm z at kPgLd * (H_0 + ... + H_{l-1}), one layer's
// relu output, the upstream gradient (then dy) and dz, the logits (then d
// loss / d logits); per layer the rows' LayerNorm mean and 1 / sqrt(var +
// eps); the rows' loss terms.
struct PgTile {
  float* x0[2];
  float *z, *a, *dh, *dz, *lg, *mu, *inv, *loss;
};

__host__ __device__ __forceinline__ float* take(float* base, long long& off,
                                                long long n) {
  float* p = base != nullptr ? base + off : nullptr;
  off += n;
  return p;
}

// Carves a tile from `base` (or only counts floats when it is null), with
// n_obs obs buffers; the host and the kernel share this one definition of
// the layout, and ops/learner_kernel.py::pg_tile_floats repeats its count.
__host__ __device__ long long carve_tile(const PgDims& d, float* base,
                                         PgTile* t, int n_obs) {
  long long off = 0;
  const long long ld = kPgLd;
  t->x0[0] = take(base, off, d.obs_dim * ld);
  t->x0[1] = n_obs == 2 ? take(base, off, d.obs_dim * ld) : t->x0[0];
  t->z = take(base, off, d.sum_h * ld);
  t->a = take(base, off, d.hmax * ld);
  t->dh = take(base, off, d.hmax * ld);
  t->dz = take(base, off, d.hmax * ld);
  t->lg = take(base, off, kPgActions * ld);
  t->mu = take(base, off, static_cast<long long>(d.torso.L) * kPgRows);
  t->inv = take(base, off, static_cast<long long>(d.torso.L) * kPgRows);
  t->loss = take(base, off, kPgRows);
  return off;
}

// Floats of the shared-memory route's block: the transposed weights, the
// accumulators (P + 1, padded to 4) and a tile with two obs buffers.
__host__ __device__ long long smem_floats(const PgDims& d) {
  PgTile t;
  return d.wt + pad4(d.net.size + 1) + carve_tile(d, nullptr, &t, 2);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A product's matrix M (K x n) as one 16-byte row piece per load: row-major
// with ld a multiple of 4 and zeros past n (the transposed weights in
// shared memory).
struct MatRows {
  const float* p;
  int ld;
  __device__ __forceinline__ float4 at4(int k, int c) const {
    return *reinterpret_cast<const float4*>(p + k * ld + c);
  }
};

// M(k, c) = p[k sk + c sc] for c < n, else 0, one float per load: a torch
// (out, in) weight read as its transpose (sk 1, sc in) or as itself (sk
// in, sc 1), in device or shared memory.
struct MatStrided {
  const float* p;
  int sk, sc, n;
  __device__ __forceinline__ float4 at4(int k, int c) const {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = c + j < n ? p[static_cast<long>(k) * sk +
                           static_cast<long>(c + j) * sc] : 0.0f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

// Y(c, r) = sum_k X(k, r) M(k, c) (+ bias[c]) for c < n and the tile's
// rows, k in order. A unit is RB rows x 4 columns: unit u takes row group
// u % (kPgRows / RB), so a warp's lanes spread over rows and share M.
template <int RB, class Mat>
__device__ __forceinline__ void prod_rows(const float* X, int K,
                                          const Mat& M, int n,
                                          const float* __restrict__ bias,
                                          float* Y) {
  constexpr int kGroups = kPgRows / RB;
  const int units = kGroups * ((n + 3) / 4);
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const int eg = u % kGroups, c0 = (u / kGroups) * 4;
    const float* xp = X + eg * RB;
    float acc[RB][4];
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      float x[RB];
      if constexpr (RB == 4) {
        const float4 v = *reinterpret_cast<const float4*>(xp + k * kPgLd);
        x[0] = v.x;
        x[1] = v.y;
        x[2] = v.z;
        x[3] = v.w;
      } else {
        x[0] = xp[k * kPgLd];
      }
      const float4 w4 = M.at4(k, c0);
      const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], w[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j;
      if (c >= n) break;
      float* yp = Y + c * kPgLd + eg * RB;
      const float b = bias != nullptr ? __ldg(bias + c) : 0.0f;
      float v[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i)
        v[i] = bias != nullptr ? acc[i][j] + b : acc[i][j];
      if constexpr (RB == 4)
        *reinterpret_cast<float4*>(yp) = make_float4(v[0], v[1], v[2], v[3]);
      else
        yp[0] = v[0];
    }
  }
}

// dst[j in + k] += sum_r G(j, r) X(k, r) over the tile's rows in order, j
// < out, k < in: a weight gradient into its accumulators. A unit is JB
// output rows x 4 inputs k, kg + nkg i (strided, so that a warp's lanes
// read neighbouring features of X); lanes spread over the inputs.
template <int JB>
__device__ __forceinline__ void prod_grad(const float* G, int out,
                                          const float* X, int in,
                                          float* dst) {
  const int nkg = (in + 3) / 4, njg = (out + JB - 1) / JB;
  for (int u = threadIdx.x; u < nkg * njg; u += kThreads) {
    const int kg = u % nkg, j0 = (u / nkg) * JB;
    const float* gp[JB];
    const float* xp[4];
    float acc[JB][4];
#pragma unroll
    for (int a = 0; a < JB; ++a) {
      const int j = j0 + a;
      gp[a] = G + min(j, out - 1) * kPgLd;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = kg + nkg * i;
        acc[a][i] = j < out && k < in ? dst[j * in + k] : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) xp[i] = X + min(kg + nkg * i, in - 1) * kPgLd;
#pragma unroll 4
    for (int r = 0; r < kPgRows; r += 4) {
      float g[JB][4], x[4][4];
#pragma unroll
      for (int a = 0; a < JB; ++a) {
        const float4 v = *reinterpret_cast<const float4*>(gp[a] + r);
        g[a][0] = v.x;
        g[a][1] = v.y;
        g[a][2] = v.z;
        g[a][3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(xp[i] + r);
        x[i][0] = v.x;
        x[i][1] = v.y;
        x[i][2] = v.z;
        x[i][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int a = 0; a < JB; ++a)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[a][i] = fmaf(g[a][q], x[i][q], acc[a][i]);
    }
#pragma unroll
    for (int a = 0; a < JB; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = j0 + a, k = kg + nkg * i;
        if (j < out && k < in) dst[j * in + k] = acc[a][i];
      }
  }
}

// The sum of v over the 4 threads of a row (lanes 4 r .. 4 r + 3): the same
// bits in all four.
__device__ __forceinline__ float row_sum4(float v) {
  v = v + __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// dst[j] += sum_r G(j, r): a bias gradient. Thread 4 j + q sums rows q
// kPgRows / 4 .. in order, the four quarters added by row_sum4.
__device__ __forceinline__ void grad_bias(const float* G, int out,
                                          float* dst) {
  constexpr int kQ = kPgRows / 4;
  for (int base = 0; base < out; base += kThreads / 4) {
    const int j = base + (threadIdx.x >> 2), q = threadIdx.x & 3;
    const float* gp = G + min(j, out - 1) * kPgLd + q * kQ;
    float s = 0.0f;
#pragma unroll 4
    for (int r = 0; r < kQ; ++r) s = s + gp[r];
    s = row_sum4(s);
    if (j < out && q == 0) dst[j] = dst[j] + s;
  }
}

// LayerNorm (one-pass variance, as the twin) and relu of the tile's h
// features of z into a; the rows' statistics into mu and inv. Thread 4 r +
// q takes features q, q + 4, ... of row r.
__device__ __forceinline__ void ln_relu_fwd(const float* z, int h,
                                            const float* __restrict__ s,
                                            const float* __restrict__ tb,
                                            float eps, float* a, float* mu,
                                            float* inv) {
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll 4
  for (int f = q; f < h; f += 4) {
    const float v = z[f * kPgLd + r];
    s1 = s1 + v;
    s2 = s2 + v * v;
  }
  s1 = row_sum4(s1);
  s2 = row_sum4(s2);
  const float m = s1 / static_cast<float>(h);
  const float var = s2 / static_cast<float>(h) - m * m;
  const float iv = 1.0f / sqrtf(var + eps);
  if (q == 0) {
    mu[r] = m;
    inv[r] = iv;
  }
#pragma unroll 4
  for (int f = q; f < h; f += 4) {
    const float xh = (z[f * kPgLd + r] - m) * iv;
    const float y = xh * __ldg(s + f) + __ldg(tb + f);
    a[f * kPgLd + r] = fmaxf(y, 0.0f);
  }
}

// a = relu(LayerNorm(z)) again from the saved statistics (the same bits as
// ln_relu_fwd wrote), for a weight gradient's layer input.
__device__ __forceinline__ void relu_again(const float* z, int h,
                                           const float* __restrict__ s,
                                           const float* __restrict__ tb,
                                           const float* mu, const float* inv,
                                           float* a) {
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
  const float m = mu[r], iv = inv[r];
#pragma unroll 4
  for (int f = q; f < h; f += 4) {
    const float xh = (z[f * kPgLd + r] - m) * iv;
    const float y = xh * __ldg(s + f) + __ldg(tb + f);
    a[f * kPgLd + r] = fmaxf(y, 0.0f);
  }
}

// The backward of relu, the affine and the LayerNorm for upstream dh at z:
// dz, and dh overwritten with dy (the relu-masked upstream gradient).
__device__ __forceinline__ void ln_relu_bwd(const float* z, int h,
                                            const float* __restrict__ s,
                                            const float* __restrict__ tb,
                                            const float* mu, const float* inv,
                                            float* dh, float* dz) {
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
  const float m = mu[r], iv = inv[r];
  float a1 = 0.0f, a2 = 0.0f;
#pragma unroll 4
  for (int f = q; f < h; f += 4) {
    const float xh = (z[f * kPgLd + r] - m) * iv;
    const float y = xh * __ldg(s + f) + __ldg(tb + f);
    const float dy = y > 0.0f ? dh[f * kPgLd + r] : 0.0f;
    const float dxh = dy * __ldg(s + f);
    a1 = a1 + dxh;
    a2 = a2 + dxh * xh;
  }
  a1 = row_sum4(a1);
  a2 = row_sum4(a2);
  const float m1 = a1 / static_cast<float>(h);
  const float m2 = a2 / static_cast<float>(h);
#pragma unroll 4
  for (int f = q; f < h; f += 4) {
    const float xh = (z[f * kPgLd + r] - m) * iv;
    const float y = xh * __ldg(s + f) + __ldg(tb + f);
    const float dy = y > 0.0f ? dh[f * kPgLd + r] : 0.0f;
    const float dxh = dy * __ldg(s + f);
    dz[f * kPgLd + r] = iv * (dxh - m1 - xh * m2);
    dh[f * kPgLd + r] = dy;
  }
}

// The LayerNorm scale and bias gradients: ds[j] += sum_r dy xh, dt[j] +=
// sum_r dy, four threads a feature as in grad_bias.
__device__ __forceinline__ void ln_param_grads(const float* z, int h,
                                               const float* mu,
                                               const float* inv,
                                               const float* dy, float* ds,
                                               float* dt) {
  constexpr int kQ = kPgRows / 4;
  for (int base = 0; base < h; base += kThreads / 4) {
    const int j = base + (threadIdx.x >> 2), q = threadIdx.x & 3;
    const int jj = min(j, h - 1), r0 = q * kQ;
    float a = 0.0f, b = 0.0f;
#pragma unroll 4
    for (int r = r0; r < r0 + kQ; ++r) {
      const float g = dy[jj * kPgLd + r];
      const float xh = (z[jj * kPgLd + r] - mu[r]) * inv[r];
      a = a + g * xh;
      b = b + g;
    }
    a = row_sum4(a);
    b = row_sum4(b);
    if (j < h && q == 0) {
      ds[j] = ds[j] + a;
      dt[j] = dt[j] + b;
    }
  }
}

// The obs rows [row0, row0 + 64) of the window into x0, feature-major (rows
// past `end` as zeros): by cp.async (kAsync, committed as one group) or by
// plain loads.
template <bool kAsync>
__device__ __forceinline__ void load_obs(float* x0,
                                         const float* __restrict__ obs,
                                         int row0, int end, int F) {
  const int nr = min(kPgRows, end - row0);
  const float* src = obs + static_cast<size_t>(row0) * F;
  for (int i = threadIdx.x; i < kPgRows * F; i += kThreads) {
    const int r = i / F, f = i - r * F;
    float* dst = x0 + f * kPgLd + r;
    if (r >= nr)
      *dst = 0.0f;
    else if constexpr (kAsync)
      cp_async4(dst, src + i);
    else
      *dst = __ldg(src + i);
  }
  if constexpr (kAsync) cp_async_commit();
}

// Pass 1: block b sums the gradient and the loss terms of rows [b rpb,
// min(N, (b + 1) rpb)) into ws[b (P + 1) ...], P = d.net.size, the loss
// sum last; rpb is a multiple of kPgRows. kSpill: the workspace route (the
// tile is block b's slice of `tiles`, tile_floats each, and the
// accumulators are the partial row itself).
template <bool kSpill>
__global__ void __launch_bounds__(kThreads, 1) lrpg_grad_kernel(
    const PgDims d, const PgConsts c, const float* __restrict__ prm,
    const float* __restrict__ obs, const int* __restrict__ act,
    const float* __restrict__ adv, float* ws, const int rpb, float* tiles,
    const long long tile_floats) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int F = d.obs_dim, nl = d.torso.L, N = d.n_rows, P = d.net.size;
  const Torso& T = d.torso;
  const NetLayout& L = d.net;
  const int hl = T.h(nl - 1);
  float* const part = ws + static_cast<size_t>(blockIdx.x) * (P + 1);
  PgTile t;
  float* g;   // the accumulators
  if constexpr (kSpill) {
    carve_tile(d, tiles + static_cast<size_t>(blockIdx.x) * tile_floats, &t,
               1);
    g = part;
  } else {
    g = smem + d.wt;
    carve_tile(d, g + pad4(P + 1), &t, 2);
  }
  const int row_begin = blockIdx.x * rpb;
  const int row_end = min(N, row_begin + rpb);
  CP_MARK_START();
  if constexpr (!kSpill) load_obs<true>(t.x0[0], obs, row_begin, row_end, F);
  for (int i = tid; i <= P; i += kThreads) g[i] = 0.0f;
  // The transposed weights: layer l's (K_l, pad4(H_l)) block, then the
  // head's (H_{L-1}, 8); zeros first, then the weights over them.
  if constexpr (!kSpill) {
    for (int i = tid; i < d.wt; i += kThreads) smem[i] = 0.0f;
    __syncthreads();
    int off = 0;
    for (int l = 0; l <= nl; ++l) {
      const bool head = l == nl;
      const int K = head ? hl : (l == 0 ? F : T.h(l - 1));
      const int n = head ? kPgActions : T.h(l);
      const int np = head ? kPgHeadLd : pad4(n);
      const float* W = prm + (head ? L.wh : L.w(l));
      for (int i = tid; i < n * K; i += kThreads) {
        const int cc = i / K, k = i - cc * K;
        smem[off + k * np + cc] = __ldg(W + i);
      }
      off += K * np;
    }
  }

  int buf = 0;
  for (int row0 = row_begin; row0 < row_end; row0 += kPgRows, buf ^= 1) {
    const int nr = min(kPgRows, row_end - row0);
    float* x0;
    if constexpr (kSpill) {
      x0 = t.x0[0];
      __syncthreads();  // the last tile is done with x0
      load_obs<false>(x0, obs, row0, row_end, F);
    } else {
      x0 = t.x0[buf];
      cp_async_wait_all();
    }
    __syncthreads();
    CP_MARK(3);  // the tile's obs rows are in
    if constexpr (!kSpill) {
      if (row0 + kPgRows < row_end)
        load_obs<true>(t.x0[buf ^ 1], obs, row0 + kPgRows, row_end, F);
    }

    // ---- forward: torso, then the head's logits ----
    int woff = 0;
    for (int l = 0; l < nl; ++l) {
      const float* in = l == 0 ? x0 : t.a;
      const int K = l == 0 ? F : T.h(l - 1);
      const int h = T.h(l);
      float* const zl = t.z + kPgLd * T.at(l);
      if constexpr (kSpill)
        prod_rows<4>(in, K, MatStrided{prm + L.w(l), 1, K, h}, h,
                     prm + L.b(l), zl);
      else
        prod_rows<4>(in, K, MatRows{smem + woff, pad4(h)}, h, prm + L.b(l),
                     zl);
      woff += K * pad4(h);
      __syncthreads();
      ln_relu_fwd(zl, h, prm + L.s(l), prm + L.t(l), c.ln_eps, t.a,
                  t.mu + kPgRows * l, t.inv + kPgRows * l);
      __syncthreads();
    }
    CP_MARK(4);  // the torso's forward
    if constexpr (kSpill)
      prod_rows<1>(t.a, hl, MatStrided{prm + L.wh, 1, hl, kPgActions},
                   kPgActions, prm + L.bh, t.lg);
    else
      prod_rows<1>(t.a, hl, MatRows{smem + woff, kPgHeadLd}, kPgActions,
                   prm + L.bh, t.lg);
    __syncthreads();
    CP_MARK(5);  // the head's logits

    // ---- softmax epilogue, one row a thread ----
    if (tid < kPgRows) {
      const int r = tid;
      float row_loss = 0.0f;
      if (r < nr) {
        const size_t n = static_cast<size_t>(row0) + r;
        float lg[kPgActions];
        for (int a = 0; a < kPgActions; ++a) lg[a] = t.lg[a * kPgLd + r];
        float zm = lg[0];
        for (int a = 1; a < kPgActions; ++a) zm = fmaxf(zm, lg[a]);
        float ex[kPgActions], z = 0.0f;
        for (int a = 0; a < kPgActions; ++a) {
          ex[a] = expf(lg[a] - zm);
          z = z + ex[a];
        }
        const float lz = logf(z);
        float p[kPgActions], logp[kPgActions], ent = 0.0f;
        for (int a = 0; a < kPgActions; ++a) {
          p[a] = ex[a] / z;
          logp[a] = (lg[a] - zm) - lz;
          ent = ent + p[a] * logp[a];
        }
        ent = -ent;
        const int ar = __ldg(act + n);
        const float ad = __ldg(adv + n);
        float lp_a = 0.0f;
        for (int a = 0; a < kPgActions; ++a) {
          const float oh = a == ar ? 1.0f : 0.0f;
          if (a == ar) lp_a = logp[a];
          t.lg[a * kPgLd + r] =
              c.inv_n * (ad * (p[a] - oh) + c.coef * p[a] * (logp[a] + ent));
        }
        row_loss = -lp_a * ad - c.coef * ent;
      } else {
        for (int a = 0; a < kPgActions; ++a) t.lg[a * kPgLd + r] = 0.0f;
      }
      t.loss[r] = row_loss;
    }
    __syncthreads();
    CP_MARK(6);  // the softmax epilogue

    // ---- backward: the head, then each LayerNorm/relu layer ----
    if (tid < 32) {  // the tile's loss terms: lane i takes rows i, i + 32
      const float s = warp_sum(t.loss[tid] + t.loss[tid + 32]);
      if (tid == 0) g[P] = g[P] + s;
    }
    prod_grad<1>(t.lg, kPgActions, t.a, hl, g + L.wh);
    grad_bias(t.lg, kPgActions, g + L.bh);
    if constexpr (kSpill)
      prod_rows<4>(t.lg, kPgActions, MatStrided{prm + L.wh, hl, 1, hl}, hl,
                   nullptr, t.dh);
    else
      prod_rows<4>(t.lg, kPgActions,
                   MatStrided{smem + woff, 1, kPgHeadLd, hl}, hl, nullptr,
                   t.dh);
    __syncthreads();
    CP_MARK(7);  // the head's gradients and dh
    for (int l = nl - 1; l >= 0; --l) {
      const int h = T.h(l);
      const int K = l == 0 ? F : T.h(l - 1);
      woff -= K * pad4(h);
      const float* const zl = t.z + kPgLd * T.at(l);
      const float* const mul = t.mu + kPgRows * l;
      const float* const invl = t.inv + kPgRows * l;
      ln_relu_bwd(zl, h, prm + L.s(l), prm + L.t(l), mul, invl, t.dh, t.dz);
      if (l > 0)  // the layer's input, relu(LN(z_{l-1})), for its dW
        relu_again(t.z + kPgLd * T.at(l - 1), K, prm + L.s(l - 1),
                   prm + L.t(l - 1), t.mu + kPgRows * (l - 1),
                   t.inv + kPgRows * (l - 1), t.a);
      __syncthreads();
      CP_MARK(8);  // the LayerNorm/relu backward
      const float* in = l == 0 ? x0 : t.a;
      ln_param_grads(zl, h, mul, invl, t.dh, g + L.s(l), g + L.t(l));
      if (h >= 16)
        prod_grad<4>(t.dz, h, in, K, g + L.w(l));
      else
        prod_grad<1>(t.dz, h, in, K, g + L.w(l));
      grad_bias(t.dz, h, g + L.b(l));
      __syncthreads();
      CP_MARK(9);  // the layer's weight, bias and LayerNorm gradients
      if (l > 0) {
        if constexpr (kSpill)
          prod_rows<4>(t.dz, h, MatStrided{prm + L.w(l), K, 1, K}, K,
                       nullptr, t.dh);
        else
          prod_rows<4>(t.dz, h, MatStrided{smem + woff, 1, pad4(h), K}, K,
                       nullptr, t.dh);
        __syncthreads();
        CP_MARK(10);  // dh = dz W
      }
    }
  }
  if constexpr (!kSpill) {
    cp_async_wait_all();
    __syncthreads();
    for (int i = tid; i <= P; i += kThreads) part[i] = g[i];
  }
}

// Pass 2: element i < P sums the blocks' partials in block order and takes
// one Adam step; element P is the loss.
__global__ void __launch_bounds__(kThreads) lrpg_adam_kernel(
    const PgConsts c, const int P, const int blocks,
    const float* __restrict__ ws, float* __restrict__ p,
    float* __restrict__ m, float* __restrict__ v, float* __restrict__ loss) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i > P) return;
  float g = 0.0f;
#pragma unroll 16
  for (int b = 0; b < blocks; ++b)
    g = g + ws[static_cast<size_t>(b) * (P + 1) + i];
  if (i == P) {
    *loss = c.inv_n * g;
    return;
  }
  const float mm = c.b1 * m[i] + c.omb1 * g;
  const float vv = c.b2 * v[i] + c.omb2 * (g * g);
  p[i] = p[i] - c.lr * (mm / c.bc1) / (sqrtf(vv / c.bc2) + c.eps);
  m[i] = mm;
  v[i] = vv;
}

// *d = *dims with the sums of the host's copy of the widths filled in;
// false for dims the kernel does not take (no layer, a width below 1).
bool with_sums(const PgDims* dims, const int* widths, PgDims* d) {
  *d = *dims;
  long long sum;
  int hmax;
  if (d->obs_dim < 1 || d->n_rows < 1 || d->net.size < 1 ||
      (d->spill != 0 && d->spill != 1) || d->torso.tab == nullptr ||
      d->net.lay == nullptr ||
      !widths_ok(widths, d->torso.L, 1, &sum, &hmax, 0))
    return false;
  long long wt = 0;
  for (int l = 0; l < d->torso.L; ++l)
    wt += static_cast<long long>(l == 0 ? d->obs_dim : widths[l - 1]) *
          pad4(widths[l]);
  wt += static_cast<long long>(widths[d->torso.L - 1]) * kPgHeadLd;
  if (wt > (1LL << 30)) return false;
  d->sum_h = static_cast<int>(sum);
  d->hmax = hmax;
  d->wt = static_cast<int>(wt);
  return true;
}

// Whether the route d.spill names takes these dims: the workspace route
// always, the shared-memory route when its block fits.
bool route_ok(const PgDims& d) {
  return d.spill || smem_floats(d) * static_cast<long long>(sizeof(float)) <=
                        kMaxSmem;
}

// Floats of one workspace-route tile, rounded up to 128-byte pieces.
long long spill_tile_floats(const PgDims& d) {
  PgTile t;
  return (carve_tile(d, nullptr, &t, 1) + 31) / 32 * 32;
}

// Floats of the blocks' partial rows, rounded up to 128-byte pieces (the
// workspace route's tiles follow).
long long partial_floats(const PgDims& d, int blocks) {
  return (static_cast<long long>(blocks) * (d.net.size + 1) + 31) / 32 * 32;
}

// Rows per pass-1 block (a multiple of kPgRows) and the block count: at
// most kPgMaxBlocks and at most kPgWorkFloats / (P + 1 + tile), fixed by N
// and the widths alone.
void plan(const PgDims& d, int* rpb, int* blocks) {
  const long long per =
      d.net.size + 1 + (d.spill ? spill_tile_floats(d) : 0);
  long long cap = kPgWorkFloats / per;
  cap = cap < 1 ? 1 : (cap > kPgMaxBlocks ? kPgMaxBlocks : cap);
  const int tiles = (d.n_rows + kPgRows - 1) / kPgRows;
  *rpb = (tiles + static_cast<int>(cap) - 1) / static_cast<int>(cap) *
         kPgRows;
  *blocks = (d.n_rows + *rpb - 1) / *rpb;
}

}  // namespace

extern "C" {

// Floats of workspace cp_lrpg_update_phase needs for these dims (0 when
// the dims are outside what the kernel takes on the route dims->spill
// names): the blocks' partial rows, then on the workspace route each
// block's tile. widths: the host's copy of the torso's widths
// (dims->torso.L ints).
long long cp_lrpg_workspace_floats(const PgDims* dims, const int* widths) {
  PgDims d;
  if (!with_sums(dims, widths, &d) || !route_ok(d)) return 0;
  int rpb, blocks;
  plan(d, &rpb, &blocks);
  return partial_floats(d, blocks) +
         (d.spill ? blocks * spill_tile_floats(d) : 0);
}

// One LRPG update on `stream`, as two launches (pass 1, pass 2). widths:
// as above; dims->torso.tab and dims->net.lay: the device table
// (ops/learner_kernel.py::_learner_table). p, m, v: the 3 group buffers
// (updated in place); obs (N, F), act (N,) int32, adv (N,); loss (): the
// window's loss; workspace: cp_lrpg_workspace_floats floats. Returns a
// cudaError_t.
int cp_lrpg_update_phase(const PgDims* dims, const int* widths,
                         const PgConsts* consts, float* p, float* m, float* v,
                         const float* obs, const int* act, const float* adv,
                         float* loss, float* workspace, void* stream) {
  PgDims d;
  if (!with_sums(dims, widths, &d) || !route_ok(d))
    return static_cast<int>(cudaErrorInvalidValue);
  const PgConsts c = *consts;
  int rpb, blocks;
  plan(d, &rpb, &blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int P = d.net.size;
  float* tiles = workspace + partial_floats(d, blocks);
  cudaError_t err;
  if (d.spill) {
    lrpg_grad_kernel<true><<<blocks, kThreads, 0, s>>>(
        d, c, p, obs, act, adv, workspace, rpb, tiles, spill_tile_floats(d));
  } else {
    const int smem = static_cast<int>(smem_floats(d) * sizeof(float));
    err = cudaFuncSetAttribute(lrpg_grad_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    lrpg_grad_kernel<false><<<blocks, kThreads, smem, s>>>(
        d, c, p, obs, act, adv, workspace, rpb, tiles, 0);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lrpg_adam_kernel<<<(P + kThreads) / kThreads, kThreads, 0, s>>>(
      c, P, blocks, workspace, p, m, v, loss);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
