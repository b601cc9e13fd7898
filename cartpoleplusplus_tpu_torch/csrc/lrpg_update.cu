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
// Design: the Pallas kernel's grid over row blocks, made parallel. Pass 1:
// each of up to kPgMaxBlocks blocks takes a fixed slice of rows and walks
// it in sub-tiles of R rows, with the products computed thread by thread
// through (128 x 32) weight tiles staged in shared memory; each gradient
// element is one thread's sum over the sub-tile, added into the block's
// own row of the workspace. The sub-tile's activations (obs rows, every
// layer's pre-LN and relu rows, the gradient rows) live in shared memory
// when a tile of 32, 16 or 8 rows fits there (R the largest that fits: two
// layers run 32 rows up to width 272, 16 up to 552 and 8 up to 1114; four
// layers 32 up to 162, 16 up to 331 and 8 up to 668). A wider network
// takes the workspace route: the same 8-row sub-tile, carved from the
// block's own slice of the global workspace (only the weight tile stays in
// shared memory), so B9 takes every width the reference's kernel takes.
// The two routes run the same arithmetic in the same order, so at 8 rows
// they give the same bits. Pass 2: one thread per parameter element sums
// the blocks' rows in block order and applies Adam. No float atomics and a
// block count fixed by N and the widths alone (at most kPgMaxBlocks, and
// at most kPgPartialFloats floats of partial rows), so two runs give the
// same bits on any card. Any depth >= 1, as the reference's kernel takes:
// the widths and the parameter offsets are a device table
// (ops/learner_kernel.py::_learner_table), the sub-tile's per-layer rows
// regions indexed by the widths' prefix sums. The stage engine of B3/B5
// (learner_stages.cuh)
// sums each element in one thread over the whole batch, which at N =
// 131,072 would be ~7.5k serial 131k-long chains; only its LayerNorm
// statistics and constants are shared.
#include "learner_stages.cuh"

// Mirror of ops/_native.py::PgDims.
struct PgDims {
  int obs_dim, n_rows;
  int spill;   // 1: the sub-tile lives in the workspace, not shared memory
  int sum_h, hmax;  // the widths' sum and max: set by the launcher
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
constexpr int kPgMaxBlocks = 256;           // pass-1 blocks at most
// Floats of pass-1 partial rows at most (blocks x (P + 1)): wide networks
// take fewer blocks (ops/learner_kernel.py::PG_PARTIAL_FLOATS).
constexpr long long kPgPartialFloats = 1LL << 27;
constexpr int kPgSpillRows = kWarps;        // the workspace route's R
constexpr int kPgKc = 128;                  // weight-tile rows (inputs)
constexpr int kWsLd = kTC + 1;              // weight-tile row stride
// The shared memory one H100 block may use (ops/_native.py::MAX_SMEM).
constexpr int kMaxSmem = 232448;

// The sub-tile's buffers in shared memory, each row-major with its own
// width as the row stride; R is the sub-tile's row count. Layer l's rows
// of z and a sit at R * (H_0 + ... + H_{l-1}) in their regions, its
// LayerNorm statistics at R * l.
struct PgTile {
  float* x;                   // (R, F) the obs rows
  float* z;                   // (R, H_l) pre-LayerNorm, per layer
  float* a;                   // (R, H_l) relu outputs, per layer
  float* mu;                  // (R,) LayerNorm means, per layer
  float* inv;                 // (R,) LayerNorm 1 / sqrt(var + eps), per layer
  float* lg;                  // (R, 5) logits, then d loss / d logits
  float* dh;                  // (R, Hmax) upstream gradient, then dy
  float* dz;                  // (R, Hmax)
  float* loss;                // (R,) per-row loss terms
  float* wt;                  // (min(Kmax, 128), 33) one weight tile
};

// Carves the tile of `rows` rows from `base` (or only counts floats when it
// is null), the weight tile last unless `with_wt` is false; the host and
// the kernel share this one definition of the layout, and
// ops/learner_kernel.py::pg_tile_floats repeats its count.
__host__ __device__ __forceinline__ float* take(float* base, int& off,
                                                int n) {
  float* p = base != nullptr ? base + off : nullptr;
  off += n;
  return p;
}

__host__ __device__ int carve_tile(const PgDims& d, int rows, float* base,
                                   PgTile* t, bool with_wt = true) {
  int off = 0;
  const int hmax = d.hmax;
  t->x = take(base, off, rows * d.obs_dim);
  t->z = take(base, off, rows * d.sum_h);
  t->a = take(base, off, rows * d.sum_h);
  t->mu = take(base, off, rows * d.torso.L);
  t->inv = take(base, off, rows * d.torso.L);
  const int kmax = d.obs_dim > hmax ? d.obs_dim : hmax;
  t->lg = take(base, off, rows * kPgActions);
  t->dh = take(base, off, rows * hmax);
  t->dz = take(base, off, rows * hmax);
  t->loss = take(base, off, rows);
  t->wt = with_wt ? take(base, off, (kmax < kPgKc ? kmax : kPgKc) * kWsLd)
                  : nullptr;
  return off;
}

// Y[r][c] = sum_{i<K} X[r][i] Wt(i, c) (+ bias[c]) for the R rows and c <
// n_out; X is (R, K), Y (R, n_out). Forward, Wt(i, c) = W[c K + i] (a
// torch (out, in) weight); backward (dh = dz W), Wt(i, c) = W[i n_out + c].
// Warp w computes rows R/8 w .. R/8 (w + 1) - 1, lane j column c0 + j of a
// 32-column tile, summing i in order through 128-input weight tiles.
template <int R>
__device__ void tile_product(const float* X, int K,
                             const float* __restrict__ W, bool bwd,
                             int n_out, const float* __restrict__ bias,
                             float* Y, float* wt) {
  constexpr int kRpw = R / kWarps;          // sub-tile rows per warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* xr = X + warp * kRpw * K;
  for (int c0 = 0; c0 < n_out; c0 += kTC) {
    float acc[kRpw];
#pragma unroll
    for (int q = 0; q < kRpw; ++q) acc[q] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += kPgKc) {
      const int kc = min(kPgKc, K - k0);
      for (int idx = tid; idx < kc * kTC; idx += kThreads) {
        int i, cc;
        if (bwd) {
          i = idx / kTC;
          cc = idx - i * kTC;
        } else {
          cc = idx / kc;
          i = idx - cc * kc;
        }
        const int c = c0 + cc;
        float v = 0.0f;
        if (c < n_out)
          v = bwd ? W[static_cast<size_t>(k0 + i) * n_out + c]
                  : W[static_cast<size_t>(c) * K + k0 + i];
        wt[i * kWsLd + cc] = v;
      }
      __syncthreads();
      for (int i = 0; i < kc; ++i) {
        const float w = wt[i * kWsLd + lane];
#pragma unroll
        for (int q = 0; q < kRpw; ++q)
          acc[q] = fmaf(xr[q * K + k0 + i], w, acc[q]);
      }
      __syncthreads();
    }
    const int c = c0 + lane;
    if (c < n_out) {
#pragma unroll
      for (int q = 0; q < kRpw; ++q) {
        const float v = bias != nullptr ? acc[q] + bias[c] : acc[q];
        Y[(warp * kRpw + q) * n_out + c] = v;
      }
    }
  }
  __syncthreads();
}

// dst[idx] = (first ? 0 : dst[idx]) + v: the block's running sum.
__device__ __forceinline__ void add_partial(float* dst, float v, bool first) {
  *dst = first ? v : *dst + v;
}

// Weight gradient over the sub-tile: dW[j][k] = sum_r G[r][j] X[r][k] for
// G (R, out), X (R, in), into the partial row at `dst`.
template <int R>
__device__ void grad_w(const float* G, int out, const float* X, int in,
                       float* dst, bool first) {
  for (int idx = threadIdx.x; idx < out * in; idx += kThreads) {
    const int j = idx / in, k = idx - j * in;
    float s = 0.0f;
    for (int r = 0; r < R; ++r) s = fmaf(G[r * out + j], X[r * in + k], s);
    add_partial(dst + idx, s, first);
  }
}

// Bias gradient over the sub-tile: db[j] = sum_r G[r][j].
template <int R>
__device__ void grad_b(const float* G, int out, float* dst, bool first) {
  for (int j = threadIdx.x; j < out; j += kThreads) {
    float s = 0.0f;
    for (int r = 0; r < R; ++r) s = s + G[r * out + j];
    add_partial(dst + j, s, first);
  }
}

// Pass 1: block b sums the gradient and the loss terms of rows [b rpb,
// min(N, (b + 1) rpb)) into ws[b (P + 1) ...], P = d.net.size, the loss
// sum last; rpb is a multiple of R. With d.spill the sub-tile is block b's
// slice of `tiles` (tile_floats each) and only the weight tile is in
// shared memory.
template <int R>
__global__ void __launch_bounds__(kThreads) lrpg_grad_kernel(
    const PgDims d, const PgConsts c, const float* __restrict__ prm,
    const float* __restrict__ obs, const int* __restrict__ act,
    const float* __restrict__ adv, float* __restrict__ ws, const int rpb,
    float* __restrict__ tiles, const int tile_floats) {
  extern __shared__ float smem[];
  PgTile t;
  if (d.spill) {
    carve_tile(d, R, tiles + static_cast<size_t>(blockIdx.x) * tile_floats,
               &t, false);
    t.wt = smem;
  } else {
    carve_tile(d, R, smem, &t);
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int F = d.obs_dim, nl = d.torso.L, N = d.n_rows;
  const Torso& T = d.torso;
  const NetLayout& L = d.net;
  // Layer l's rows of the sub-tile's z and a, and its statistics.
  auto tz = [&](int l) { return t.z + R * T.at(l); };
  auto ta = [&](int l) { return t.a + R * T.at(l); };
  auto tmu = [&](int l) { return t.mu + R * l; };
  auto tinv = [&](int l) { return t.inv + R * l; };
  float* const part = ws + static_cast<size_t>(blockIdx.x) * (L.size + 1);
  const int row_begin = blockIdx.x * rpb;
  const int row_end = min(N, row_begin + rpb);

  for (int row0 = row_begin; row0 < row_end; row0 += R) {
    const bool first = row0 == row_begin;
    const int nr = min(R, row_end - row0);
    for (int idx = tid; idx < R * F; idx += kThreads) {
      const int r = idx / F;
      t.x[idx] = r < nr ? obs[static_cast<size_t>(row0) * F + idx] : 0.0f;
    }
    __syncthreads();

    // ---- forward: torso, then the head's logits ----
    for (int l = 0; l < nl; ++l) {
      const float* in = l == 0 ? t.x : ta(l - 1);
      const int kin = l == 0 ? F : T.h(l - 1);
      const int h = T.h(l);
      float* const zl = tz(l);
      float* const al = ta(l);
      tile_product<R>(in, kin, prm + L.w(l), false, h, prm + L.b(l), zl,
                      t.wt);
      const float* s = prm + L.s(l);
      const float* tb = prm + L.t(l);
      for (int r = warp; r < R; r += kWarps) {
        const float* zr = zl + r * h;
        float mu, inv;
        ln_stats(zr, h, c.ln_eps, lane, mu, inv);
        if (lane == 0) {
          tmu(l)[r] = mu;
          tinv(l)[r] = inv;
        }
        for (int j = lane; j < h; j += 32) {
          const float xh = (zr[j] - mu) * inv;
          const float y = xh * s[j] + tb[j];
          al[r * h + j] = fmaxf(y, 0.0f);
        }
      }
      __syncthreads();
    }
    const int hl = T.h(nl - 1);
    tile_product<R>(ta(nl - 1), hl, prm + L.wh, false, kPgActions,
                    prm + L.bh, t.lg, t.wt);

    // ---- softmax epilogue, one row per lane of warp 0 ----
    if (warp == 0) {
      const int r = lane;
      float* lg = t.lg + r * kPgActions;
      float row_loss = 0.0f;
      if (r < nr) {
        const size_t n = static_cast<size_t>(row0) + r;
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
        const int ar = act[n];
        const float ad = adv[n];
        float lp_a = 0.0f;
        for (int a = 0; a < kPgActions; ++a) {
          const float oh = a == ar ? 1.0f : 0.0f;
          if (a == ar) lp_a = logp[a];
          lg[a] = c.inv_n * (ad * (p[a] - oh) + c.coef * p[a] * (logp[a] + ent));
        }
        row_loss = -lp_a * ad - c.coef * ent;
      } else if (r < R) {
        for (int a = 0; a < kPgActions; ++a) lg[a] = 0.0f;
      }
      if (r < R) t.loss[r] = row_loss;
      __syncwarp();
      if (lane == 0) {
        float s = 0.0f;
        for (int i = 0; i < R; ++i) s = s + t.loss[i];
        add_partial(part + L.size, s, first);
      }
    }
    __syncthreads();

    // ---- backward: the head, then each LayerNorm/relu layer ----
    grad_w<R>(t.lg, kPgActions, ta(nl - 1), hl, part + L.wh, first);
    grad_b<R>(t.lg, kPgActions, part + L.bh, first);
    tile_product<R>(t.lg, kPgActions, prm + L.wh, true, hl, nullptr, t.dh,
                    t.wt);
    for (int l = nl - 1; l >= 0; --l) {
      const int h = T.h(l);
      const float* s = prm + L.s(l);
      const float* tb = prm + L.t(l);
      const float* const zl = tz(l);
      const float* const mul = tmu(l);
      const float* const invl = tinv(l);
      for (int r = warp; r < R; r += kWarps) {
        const float* zr = zl + r * h;
        float* dhr = t.dh + r * h;
        const float mu = mul[r], inv = invl[r];
        float a1 = 0.0f, a2 = 0.0f;
        for (int j = lane; j < h; j += 32) {
          const float xh = (zr[j] - mu) * inv;
          const float y = xh * s[j] + tb[j];
          const float dy = y > 0.0f ? dhr[j] : 0.0f;
          const float dxh = dy * s[j];
          a1 = a1 + dxh;
          a2 = a2 + dxh * xh;
        }
        a1 = warp_sum(a1);
        a2 = warp_sum(a2);
        const float m1 = a1 / static_cast<float>(h);
        const float m2 = a2 / static_cast<float>(h);
        for (int j = lane; j < h; j += 32) {
          const float xh = (zr[j] - mu) * inv;
          const float y = xh * s[j] + tb[j];
          const float dy = y > 0.0f ? dhr[j] : 0.0f;
          const float dxh = dy * s[j];
          t.dz[r * h + j] = inv * (dxh - m1 - xh * m2);
          dhr[j] = dy;
        }
      }
      __syncthreads();
      const float* in = l == 0 ? t.x : ta(l - 1);
      const int kin = l == 0 ? F : T.h(l - 1);
      grad_w<R>(t.dz, h, in, kin, part + L.w(l), first);
      grad_b<R>(t.dz, h, part + L.b(l), first);
      for (int j = tid; j < h; j += kThreads) {  // LayerNorm scale and bias
        float ds = 0.0f, dt = 0.0f;
        for (int r = 0; r < R; ++r) {
          const float dy = t.dh[r * h + j];
          const float xh = (zl[r * h + j] - mul[r]) * invl[r];
          ds = ds + dy * xh;
          dt = dt + dy;
        }
        add_partial(part + L.s(l) + j, ds, first);
        add_partial(part + L.t(l) + j, dt, first);
      }
      __syncthreads();
      if (l > 0)
        tile_product<R>(t.dz, h, prm + L.w(l), true, kin, nullptr, t.dh,
                        t.wt);
    }
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

// The shared-memory sub-tile's row count for these dims: the largest of
// 32, 16 and 8 whose tile fits in shared memory, 0 when none fits
// (ops/learner_kernel.py::pg_tile_rows is its twin).
int smem_tile_rows(const PgDims& d) {
  PgTile t;
  for (int rows = 32; rows >= kWarps; rows /= 2)
    if (static_cast<size_t>(carve_tile(d, rows, nullptr, &t)) * sizeof(float)
        <= kMaxSmem)
      return rows;
  return 0;
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
  d->sum_h = static_cast<int>(sum);
  d->hmax = hmax;
  return true;
}

// The sub-tile's row count on the route d.spill names, or 0 where the
// shared-memory route has no tile that fits.
int tile_rows(const PgDims& d) {
  return d.spill ? kPgSpillRows : smem_tile_rows(d);
}

// Floats of one workspace-route sub-tile (the weight tile excluded),
// rounded up to 128-byte pieces.
long long spill_tile_floats(const PgDims& d) {
  PgTile t;
  return (carve_tile(d, kPgSpillRows, nullptr, &t, false) + 31) / 32 * 32;
}

// Rows per pass-1 block (a multiple of `rows`) and the block count: at most
// kPgMaxBlocks and at most kPgPartialFloats / (P + 1), fixed by N and the
// widths alone.
void plan(const PgDims& d, int rows, int* rpb, int* blocks) {
  long long cap = kPgPartialFloats / (d.net.size + 1);
  cap = cap < 1 ? 1 : (cap > kPgMaxBlocks ? kPgMaxBlocks : cap);
  const int tiles = (d.n_rows + rows - 1) / rows;
  *rpb = (tiles + static_cast<int>(cap) - 1) / static_cast<int>(cap) * rows;
  *blocks = (d.n_rows + *rpb - 1) / *rpb;
}

// Pass 1 at R rows per sub-tile: lifts the shared-memory limit to what the
// route needs and launches.
template <int R>
cudaError_t launch_grad(const PgDims& d, const PgConsts& c, const float* p,
                        const float* obs, const int* act, const float* adv,
                        float* ws, int rpb, int blocks, cudaStream_t s) {
  PgTile t;
  const int all = carve_tile(d, R, nullptr, &t);
  const int tile = carve_tile(d, R, nullptr, &t, false);
  const size_t smem = sizeof(float) * (d.spill ? all - tile : all);
  const long long tf = d.spill ? spill_tile_floats(d) : 0;
  float* tiles = ws + static_cast<size_t>(blocks) * (d.net.size + 1);
  const cudaError_t err = cudaFuncSetAttribute(
      lrpg_grad_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lrpg_grad_kernel<R><<<blocks, kThreads, smem, s>>>(
      d, c, p, obs, act, adv, ws, rpb, tiles, static_cast<int>(tf));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of workspace cp_lrpg_update_phase needs for these dims (0 when
// the dims are outside what the kernel takes): the blocks' partial rows,
// then on the workspace route each block's sub-tile. widths: the host's
// copy of the torso's widths (dims->torso.L ints).
long long cp_lrpg_workspace_floats(const PgDims* dims, const int* widths) {
  PgDims d;
  if (!with_sums(dims, widths, &d)) return 0;
  const int rows = tile_rows(d);
  if (rows == 0) return 0;
  int rpb, blocks;
  plan(d, rows, &rpb, &blocks);
  return static_cast<long long>(blocks) *
         (d.net.size + 1 + (d.spill ? spill_tile_floats(d) : 0));
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
  if (!with_sums(dims, widths, &d))
    return static_cast<int>(cudaErrorInvalidValue);
  const PgConsts c = *consts;
  const int rows = tile_rows(d);
  if (rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  int rpb, blocks;
  plan(d, rows, &rpb, &blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rows == 32)
    err = launch_grad<32>(d, c, p, obs, act, adv, workspace, rpb, blocks, s);
  else if (rows == 16)
    err = launch_grad<16>(d, c, p, obs, act, adv, workspace, rpb, blocks, s);
  else
    err = launch_grad<8>(d, c, p, obs, act, adv, workspace, rpb, blocks, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = d.net.size;
  lrpg_adam_kernel<<<(P + kThreads) / kThreads, kThreads, 0, s>>>(
      c, P, blocks, workspace, p, m, v, loss);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
