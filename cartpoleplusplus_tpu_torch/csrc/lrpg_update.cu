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
// B3/B5/B7 (learner_stages.cuh). Pass 1 is instantiated per products' mode
// (dims.mm, learner_stages.cuh's modes: each operand rounded, split or
// widened in registers as it enters the chain); the X3, X6, F64 and F16
// instances are built in lrpg_update_x3x6.cu and lrpg_update_f64f16.cu,
// this source with CP_MM_PRESET_UNIT defined, beside this one. A weight
// gradient is one dot over the whole window, so its result is formed in
// pass 2: at kMmF64 the accumulators and the partial rows are doubles, a
// weight gradient summed in double and rounded once (the bias, LayerNorm
// and loss sums, which are no dots, stay float32 sums at every mode, held
// in those doubles: sum_into); at kMmF16 the weight gradients' float32
// sums are rounded to float16 there. Pass 2 makes no product.
//
// At the tensor cores' modes (bfloat16, TF32, F16, X3, X6: mm_tc) pass 1
// forms every product with mma.sync (learner_stages.cuh's fragment
// helpers) in place of the register-tiled fmaf chains: the tile's 64 rows
// on the mma's M dimension (4 tiles of 16), the output features on N, the
// inputs (or, for a weight gradient, the rows) on K, the sums chained
// through the tensor core; mma_rows and mma_grad. On the shared-memory
// route the weights are rounded or split
// once per block into packed bfloat16, float16 or TF32 copies there
// (PackedW: one copy per matrix, read directly for the forward and as its
// transpose for dh = dz W), in place of the float32 copy; on the workspace
// route each fragment's weights are read from the group buffer and
// converted as they load. The activations and gradients, float32 in the
// tile, are converted as their fragments load. Bound at these modes: the
// products' ~4.9 GFLOP take ~5 us at bfloat16's 989 TFLOP/s, so the
// window's bytes (~7 us) and the float32 rest (LayerNorm, softmax, the
// bias and LayerNorm sums) set the bound.
#include "learner_stages.cuh"

// Mirror of ops/_native.py::PgDims.
struct PgDims {
  int obs_dim, n_rows;
  int spill;   // 1: the workspace route
  int sum_h, hmax, wt;  // the widths' sum and max, the floats of the
                        // transposed weights: set by the launcher
  Torso torso;
  NetLayout net;
  int mm;      // the products' mode (learner_stages.cuh's kMm*)
  int* instance;  // when not null: pass 1's instance id (kMmInstance)
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
__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

// 32-bit words of a row of a packed weight copy at tensor-core mode m, for
// K inputs: pad16(K) bfloat16 or float16 values two a word (TF32: one),
// and 4 words more, so that the 8 rows and 4 lanes of a fragment's load
// fall in 32 different banks.
__host__ __device__ inline int mma_row_words(int m, int K) {
  return m == kMmTf32 ? pad16(K) + 4 : pad16(K) / 2 + 4;
}
// Words of one packed matrix of n outputs and K inputs, all its parts.
__host__ __device__ inline long long mma_matrix_words(int m, int n, int K) {
  return static_cast<long long>(mm_parts(m)) * pad16(n) *
         mma_row_words(m, K);
}

// Floats of one accumulator of mode m: a double's two at kMmF64.
__host__ __device__ inline int acc_floats(int m) {
  return m == kMmF64 ? 2 : 1;
}

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
// accumulators (P + 1, padded to 4; doubles at kMmF64) and a tile with two
// obs buffers.
__host__ __device__ long long smem_floats(const PgDims& d) {
  PgTile t;
  return d.wt + acc_floats(d.mm) * pad4(d.net.size + 1) +
         carve_tile(d, nullptr, &t, 2);
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
// rows, k in order, both operands as mode MM takes them and the sum as it
// goes on (mm_out) before the bias. A unit is RB rows
// x 4 columns: unit u takes row group u % (kPgRows / RB), so a warp's
// lanes spread over rows and share M.
template <int MM, int RB, class Mat>
__device__ __forceinline__ void prod_rows(const float* X, int K,
                                          const Mat& M, int n,
                                          const float* __restrict__ bias,
                                          float* Y) {
  constexpr int kGroups = kPgRows / RB;
  const int units = kGroups * ((n + 3) / 4);
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const int eg = u % kGroups, c0 = (u / kGroups) * 4;
    const float* xp = X + eg * RB;
    mm_acc_t<MM> acc[RB][4];
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
      mm_in_t<MM> xm[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) xm[i] = mm_in<MM>(x[i]);
      const float4 w4 = M.at4(k, c0);
      const mm_in_t<MM> w[4] = {mm_in<MM>(w4.x), mm_in<MM>(w4.y),
                                mm_in<MM>(w4.z), mm_in<MM>(w4.w)};
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = mm_fma<MM>(xm[i], w[j], acc[i][j]);
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
        v[i] = bias != nullptr ? mm_out<MM>(acc[i][j]) + b
                               : mm_out<MM>(acc[i][j]);
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
// read neighbouring features of X); lanes spread over the inputs. Both
// operands as mode M takes them, the accumulators of its chain's type.
template <int M, int JB>
__device__ __forceinline__ void prod_grad(const float* G, int out,
                                          const float* X, int in,
                                          mm_acc_t<M>* dst) {
  const int nkg = (in + 3) / 4, njg = (out + JB - 1) / JB;
  for (int u = threadIdx.x; u < nkg * njg; u += kThreads) {
    const int kg = u % nkg, j0 = (u / nkg) * JB;
    const float* gp[JB];
    const float* xp[4];
    mm_acc_t<M> acc[JB][4];
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
      mm_in_t<M> g[JB][4], x[4][4];
#pragma unroll
      for (int a = 0; a < JB; ++a) {
        const float4 v = *reinterpret_cast<const float4*>(gp[a] + r);
        g[a][0] = mm_in<M>(v.x);
        g[a][1] = mm_in<M>(v.y);
        g[a][2] = mm_in<M>(v.z);
        g[a][3] = mm_in<M>(v.w);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(xp[i] + r);
        x[i][0] = mm_in<M>(v.x);
        x[i][1] = mm_in<M>(v.y);
        x[i][2] = mm_in<M>(v.z);
        x[i][3] = mm_in<M>(v.w);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int a = 0; a < JB; ++a)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[a][i] = mm_fma<M>(g[a][q], x[i][q], acc[a][i]);
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

// A packed weight copy (the shared-memory route at a tensor-core mode) as
// the source of a product's B: W (n outputs x K inputs, torch's layout)
// part by part, planes of `plane` words, rows of sw words. kT false: B(k,
// c) = W[c][k] (the forward, a pair of inputs one word); kT: B(j, i) =
// W[j][i] (dh = dz W, a pair of outputs two 16-bit loads).
template <int M, bool kT>
struct PackedW {
  const unsigned* p;
  int sw, plane;
  __device__ __forceinline__ void two(int n, int k, unsigned& lo,
                                      unsigned& hi) const {
    lo = p[kT ? k * sw + n : n * sw + k];
    hi = p[kT ? (k + 1) * sw + n : n * sw + k + 1];
  }
  __device__ __forceinline__ void pair(int n, int k,
                                       unsigned (&o)[kMmaParts<M>]) const {
#pragma unroll
    for (int i = 0; i < kMmaParts<M>; ++i) {
      const unsigned* q = p + i * plane;
      if constexpr (kT) {
        const unsigned short* h = reinterpret_cast<const unsigned short*>(q);
        o[i] = static_cast<unsigned>(h[2 * k * sw + n]) |
               static_cast<unsigned>(h[2 * (k + 1) * sw + n]) << 16;
      } else {
        o[i] = q[n * sw + k / 2];
      }
    }
  }
};

// Y(c, r) = sum_k X(k, r) B(k, c) (+ bias[c]) for c < n and the tile's
// rows on the tensor cores (prod_rows' function at a tensor-core mode): X
// feature-major, zero past K; B from `w` (zeros past K and n); each
// k-block's product added into the float32 sum by the tensor core
// (kAccChain), then mm_out and the bias. A unit is a 16-row m-tile x kNT
// n-tiles of 8 columns, its A
// fragment loaded once a k-block for all of them; warp w takes units w, w
// + kWarps, ...
template <int M, class WS>
__device__ __forceinline__ void mma_rows(const float* X, int K, const WS& w,
                                         int n,
                                         const float* __restrict__ bias,
                                         float* Y) {
  constexpr int kMT = kPgRows / 16, kNT = 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ntn = (n + 7) / 8, units = kMT * ((ntn + kNT - 1) / kNT);
  const auto xs = mma_floats<M>(
      [=](int r, int k) { return k < K ? X[k * kPgLd + r] : 0.0f; });
  for (int u = threadIdx.x >> 5; u < units; u += kWarps) {
    const int m0 = (u % kMT) * 16, nt0 = (u / kMT) * kNT;
    float acc[kNT][4] = {};
    for (int k0 = 0; k0 < K; k0 += kMmaK<M>) {
      const MmaA<M> a = mma_load_a<M>(xs, m0, k0);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        if (nt0 + j < ntn)
          mma_add<M, false, kAccChain>(
              a, mma_load_b<M>(w, (nt0 + j) * 8, k0), acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = m0 + g + (q >> 1) * 8;
        const int c = (nt0 + j) * 8 + 2 * t + (q & 1);
        if (c < n) {
          const float v = mm_out<M>(acc[j][q]);
          Y[c * kPgLd + r] = bias != nullptr ? v + __ldg(bias + c) : v;
        }
      }
  }
}

// dst[j in + k] += sum_r G(j, r) X(k, r) over the tile's rows, j < out, k <
// in, on the tensor cores (prod_grad's function at a tensor-core mode): a
// unit is one 16 x 8 tile of the gradient, its accumulators read once and
// written once, each k-block of rows added into them by the tensor core
// (kAccChain); warp w takes units w, w + kWarps, ...
template <int M>
__device__ __forceinline__ void mma_grad(const float* G, int out,
                                         const float* X, int in, float* dst) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nt = (in + 7) / 8, units = (out + 15) / 16 * nt;
  // Both operands' pairs lie side by side (rows r, r + 1 of a feature).
  const auto gs = mma_pairs<M>(
      [=](int j, int r) { return j < out ? G[j * kPgLd + r] : 0.0f; },
      [=](int j, int r) {
        return j < out ? *reinterpret_cast<const float2*>(G + j * kPgLd + r)
                       : make_float2(0.0f, 0.0f);
      });
  const auto xs = mma_pairs<M>(
      [=](int k, int r) { return k < in ? X[k * kPgLd + r] : 0.0f; },
      [=](int k, int r) {
        return k < in ? *reinterpret_cast<const float2*>(X + k * kPgLd + r)
                      : make_float2(0.0f, 0.0f);
      });
  for (int u = threadIdx.x >> 5; u < units; u += kWarps) {
    const int m0 = (u / nt) * 16, n0 = (u % nt) * 8;
    float acc[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = m0 + g + (q >> 1) * 8, k = n0 + 2 * t + (q & 1);
      acc[q] = j < out && k < in ? dst[j * in + k] : 0.0f;
    }
#pragma unroll 4
    for (int r0 = 0; r0 < kPgRows; r0 += kMmaK<M>)
      mma_add<M, false, kAccChain>(mma_load_a<M>(gs, m0, r0),
                                   mma_load_b<M>(xs, n0, r0), acc);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = m0 + g + (q >> 1) * 8, k = n0 + 2 * t + (q & 1);
      if (j < out && k < in) dst[j * in + k] = acc[q];
    }
  }
}

// dst += s for a sum that is no dot (a bias, LayerNorm or loss sum): a
// float32 sum at every mode, whatever the accumulator's type (a double at
// kMmF64 holds the float32 value).
template <class A>
__device__ __forceinline__ void sum_into(A& dst, float s) {
  dst = static_cast<A>(static_cast<float>(dst) + s);
}

// The sum of v over the 4 threads of a row (lanes 4 r .. 4 r + 3): the same
// bits in all four.
__device__ __forceinline__ float row_sum4(float v) {
  v = v + __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// dst[j] += sum_r G(j, r): a bias gradient. Thread 4 j + q sums rows q
// kPgRows / 4 .. in order, the four quarters added by row_sum4.
template <class A>
__device__ __forceinline__ void grad_bias(const float* G, int out, A* dst) {
  constexpr int kQ = kPgRows / 4;
  for (int base = 0; base < out; base += kThreads / 4) {
    const int j = base + (threadIdx.x >> 2), q = threadIdx.x & 3;
    const float* gp = G + min(j, out - 1) * kPgLd + q * kQ;
    float s = 0.0f;
#pragma unroll 4
    for (int r = 0; r < kQ; ++r) s = s + gp[r];
    s = row_sum4(s);
    if (j < out && q == 0) sum_into(dst[j], s);
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
template <class A>
__device__ __forceinline__ void ln_param_grads(const float* z, int h,
                                               const float* mu,
                                               const float* inv,
                                               const float* dy, A* ds,
                                               A* dt) {
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
      sum_into(ds[j], a);
      sum_into(dt[j], b);
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

// A forward product's B from W (n outputs x K inputs, torch's layout) in
// device memory, B(k, c) = W[c][k], converted as the fragments load (the
// workspace route at a tensor-core mode).
template <int M>
__device__ __forceinline__ auto w_fwd(const float* __restrict__ W, int n,
                                      int K) {
  return mma_floats<M>([=](int c, int k) {
    return c < n && k < K ? __ldg(W + static_cast<size_t>(c) * K + k) : 0.0f;
  });
}
// dh = dz W's B from W (n x K) in device memory: B(j, i) = W[j][i].
template <int M>
__device__ __forceinline__ auto w_bwd(const float* __restrict__ W, int n,
                                      int K) {
  return mma_floats<M>([=](int i, int j) {
    return i < K && j < n ? __ldg(W + static_cast<size_t>(j) * K + i) : 0.0f;
  });
}
// The packed copy of W (n x K) at word `off` of shared memory.
template <int M, bool kT>
__device__ __forceinline__ PackedW<M, kT> w_packed(const float* smem, int off,
                                                   int n, int K) {
  const int sw = mma_row_words(M, K);
  return PackedW<M, kT>{reinterpret_cast<const unsigned*>(smem) + off, sw,
                        pad16(n) * sw};
}

// Pass 1: block b sums the gradient and the loss terms of rows [b rpb,
// min(N, (b + 1) rpb)) into ws[b (P + 1) ...], P = d.net.size, the loss
// sum last; rpb is a multiple of kPgRows. kSpill: the workspace route (the
// tile is block b's slice of `tiles`, tile_floats each, and the
// accumulators are the partial row itself). M: the products' mode.
template <bool kSpill, int M>
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
  using A = mm_acc_t<M>;
  A* const part = reinterpret_cast<A*>(ws) + static_cast<size_t>(blockIdx.x) *
                                                 (P + 1);
  PgTile t;
  A* g;   // the accumulators
  if constexpr (kSpill) {
    carve_tile(d, tiles + static_cast<size_t>(blockIdx.x) * tile_floats, &t,
               1);
    g = part;
  } else {
    g = reinterpret_cast<A*>(smem + d.wt);
    carve_tile(d, smem + d.wt + acc_floats(M) * pad4(P + 1), &t, 2);
  }
  const int row_begin = blockIdx.x * rpb;
  const int row_end = min(N, row_begin + rpb);
  CP_MARK_START();
  if (blockIdx.x == 0 && tid == 0 && d.instance != nullptr)
    *d.instance = kMmInstance<M, mm_tc<M>>;
  if constexpr (!kSpill) load_obs<true>(t.x0[0], obs, row_begin, row_end, F);
  for (int i = tid; i <= P; i += kThreads) g[i] = 0.0f;
  // The weights' copy: at a tensor-core mode each matrix packed (every
  // layer's W, then the head's: mma_matrix_words each); else transposed,
  // layer l's (K_l, pad4(H_l)) block, then the head's (H_{L-1}, 8), zeros
  // first, then the weights over them.
  if constexpr (!kSpill && mm_tc<M>) {
    unsigned* const pw = reinterpret_cast<unsigned*>(smem);
    int off = 0;
    for (int l = 0; l <= nl; ++l) {
      const bool head = l == nl;
      const int K = head ? hl : (l == 0 ? F : T.h(l - 1));
      const int n = head ? kPgActions : T.h(l);
      const float* W = prm + (head ? L.wh : L.w(l));
      const int sw = mma_row_words(M, K), plane = pad16(n) * sw;
      for (int i = tid; i < plane; i += kThreads) {
        const int cc = i / sw, w = i - cc * sw;
        const float* row = W + static_cast<size_t>(cc) * K;
        if constexpr (M == kMmTf32) {
          pw[off + i] = tf32_bits(cc < n && w < K ? __ldg(row + w) : 0.0f);
        } else {
          const int k = 2 * w;
          unsigned q[kMmaParts<M>];
          mma_pack<M>(cc < n && k < K ? __ldg(row + k) : 0.0f,
                      cc < n && k + 1 < K ? __ldg(row + k + 1) : 0.0f, q);
#pragma unroll
          for (int j = 0; j < kMmaParts<M>; ++j)
            pw[off + j * plane + i] = q[j];
        }
      }
      off += kMmaParts<M> * plane;
    }
  } else if constexpr (!kSpill) {
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

  // Floats (words) of a matrix's copy, n outputs x K inputs.
  auto wsize = [](int n, int K) -> int {
    if constexpr (mm_tc<M>)
      return static_cast<int>(mma_matrix_words(M, n, K));
    else
      return K * pad4(n);
  };
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
      if constexpr (mm_tc<M> && kSpill)
        mma_rows<M>(in, K, w_fwd<M>(prm + L.w(l), h, K), h, prm + L.b(l),
                    zl);
      else if constexpr (mm_tc<M>)
        mma_rows<M>(in, K, w_packed<M, false>(smem, woff, h, K), h,
                    prm + L.b(l), zl);
      else if constexpr (kSpill)
        prod_rows<M, 4>(in, K, MatStrided{prm + L.w(l), 1, K, h}, h,
                        prm + L.b(l), zl);
      else
        prod_rows<M, 4>(in, K, MatRows{smem + woff, pad4(h)}, h,
                        prm + L.b(l), zl);
      woff += wsize(h, K);
      __syncthreads();
      ln_relu_fwd(zl, h, prm + L.s(l), prm + L.t(l), c.ln_eps, t.a,
                  t.mu + kPgRows * l, t.inv + kPgRows * l);
      __syncthreads();
    }
    CP_MARK(4);  // the torso's forward
    if constexpr (mm_tc<M> && kSpill)
      mma_rows<M>(t.a, hl, w_fwd<M>(prm + L.wh, kPgActions, hl), kPgActions,
                  prm + L.bh, t.lg);
    else if constexpr (mm_tc<M>)
      mma_rows<M>(t.a, hl, w_packed<M, false>(smem, woff, kPgActions, hl),
                  kPgActions, prm + L.bh, t.lg);
    else if constexpr (kSpill)
      prod_rows<M, 1>(t.a, hl, MatStrided{prm + L.wh, 1, hl, kPgActions},
                      kPgActions, prm + L.bh, t.lg);
    else
      prod_rows<M, 1>(t.a, hl, MatRows{smem + woff, kPgHeadLd}, kPgActions,
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
      if (tid == 0) sum_into(g[P], s);
    }
    if constexpr (mm_tc<M>)
      mma_grad<M>(t.lg, kPgActions, t.a, hl, g + L.wh);
    else
      prod_grad<M, 1>(t.lg, kPgActions, t.a, hl, g + L.wh);
    grad_bias(t.lg, kPgActions, g + L.bh);
    if constexpr (mm_tc<M> && kSpill)
      mma_rows<M>(t.lg, kPgActions, w_bwd<M>(prm + L.wh, kPgActions, hl), hl,
                  nullptr, t.dh);
    else if constexpr (mm_tc<M>)
      mma_rows<M>(t.lg, kPgActions,
                  w_packed<M, true>(smem, woff, kPgActions, hl), hl, nullptr,
                  t.dh);
    else if constexpr (kSpill)
      prod_rows<M, 4>(t.lg, kPgActions, MatStrided{prm + L.wh, hl, 1, hl},
                      hl, nullptr, t.dh);
    else
      prod_rows<M, 4>(t.lg, kPgActions,
                      MatStrided{smem + woff, 1, kPgHeadLd, hl}, hl, nullptr,
                      t.dh);
    __syncthreads();
    CP_MARK(7);  // the head's gradients and dh
    for (int l = nl - 1; l >= 0; --l) {
      const int h = T.h(l);
      const int K = l == 0 ? F : T.h(l - 1);
      woff -= wsize(h, K);
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
      if constexpr (mm_tc<M>)
        mma_grad<M>(t.dz, h, in, K, g + L.w(l));
      else if (h >= 16)
        prod_grad<M, 4>(t.dz, h, in, K, g + L.w(l));
      else
        prod_grad<M, 1>(t.dz, h, in, K, g + L.w(l));
      grad_bias(t.dz, h, g + L.b(l));
      __syncthreads();
      CP_MARK(9);  // the layer's weight, bias and LayerNorm gradients
      if (l > 0) {
        if constexpr (mm_tc<M> && kSpill)
          mma_rows<M>(t.dz, h, w_bwd<M>(prm + L.w(l), h, K), K, nullptr,
                      t.dh);
        else if constexpr (mm_tc<M>)
          mma_rows<M>(t.dz, h, w_packed<M, true>(smem, woff, h, K), K,
                      nullptr, t.dh);
        else if constexpr (kSpill)
          prod_rows<M, 4>(t.dz, h, MatStrided{prm + L.w(l), K, 1, K}, K,
                          nullptr, t.dh);
        else
          prod_rows<M, 4>(t.dz, h, MatStrided{smem + woff, 1, pad4(h), K},
                          K, nullptr, t.dh);
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

// Whether element i of the group is a weight's (a dot's result over the
// window), not a bias's or a LayerNorm parameter's.
__device__ bool is_weight(int i, const Torso& T, const NetLayout& L, int F) {
  const int hl = T.h(T.L - 1);
  if (i >= L.wh && i < L.wh + kPgActions * hl) return true;
  for (int l = 0; l < T.L; ++l) {
    const int K = l == 0 ? F : T.h(l - 1);
    if (i >= L.w(l) && i < L.w(l) + T.h(l) * K) return true;
  }
  return false;
}

// Pass 2: element i < P sums the blocks' partials in block order and takes
// one Adam step; element P is the loss. M: kMmF32 (the modes whose partials
// are float32 sums that go on as they are), kMmF64 (a weight's double
// partials summed in double and rounded once, every other sum float32) or
// kMmF16 (a weight's sum rounded to float16).
template <int M>
__global__ void __launch_bounds__(kThreads) lrpg_adam_kernel(
    const PgConsts c, const int P, const int blocks,
    const float* __restrict__ wsf, float* __restrict__ p,
    float* __restrict__ m, float* __restrict__ v, float* __restrict__ loss,
    const Torso T, const NetLayout L, const int F) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i > P) return;
  using A = mm_acc_t<M>;
  const A* __restrict__ ws = reinterpret_cast<const A*>(wsf);
  const bool dot =
      (M == kMmF64 || M == kMmF16) && i < P && is_weight(i, T, L, F);
  float g;
  if (M == kMmF64 && dot) {
    A s = 0.0;
#pragma unroll 16
    for (int b = 0; b < blocks; ++b)
      s = s + ws[static_cast<size_t>(b) * (P + 1) + i];
    g = static_cast<float>(s);
  } else {
    float s = 0.0f;
#pragma unroll 16
    for (int b = 0; b < blocks; ++b)
      s = s + static_cast<float>(ws[static_cast<size_t>(b) * (P + 1) + i]);
    g = s;
  }
  if constexpr (M == kMmF16) {
    if (dot) g = mm_out<M>(g);
  }
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
      (d->spill != 0 && d->spill != 1) || !mm_ok(d->mm) ||
      d->torso.tab == nullptr ||
      d->net.lay == nullptr ||
      !widths_ok(widths, d->torso.L, 1, &sum, &hmax, 0))
    return false;
  // The weights' copy on the shared-memory route: packed at a tensor-core
  // mode (mma_matrix_words), else transposed with the outputs padded to 4
  // (the head's to kPgHeadLd).
  long long wt = 0;
  for (int l = 0; l <= d->torso.L; ++l) {
    const bool head = l == d->torso.L;
    const int K = l == 0 ? d->obs_dim : widths[l - 1];
    const int n = head ? kPgActions : widths[l];
    wt += mm_tc_mode(d->mm) ? mma_matrix_words(d->mm, n, K)
                            : static_cast<long long>(K) *
                                  (head ? kPgHeadLd : pad4(n));
  }
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

// Floats of the blocks' partial rows (doubles at kMmF64), rounded up to
// 128-byte pieces (the workspace route's tiles follow).
long long partial_floats(const PgDims& d, int blocks) {
  return (static_cast<long long>(blocks) * (d.net.size + 1) *
              acc_floats(d.mm) +
          31) /
         32 * 32;
}

// Rows per pass-1 block (a multiple of kPgRows) and the block count: at
// most kPgMaxBlocks and at most kPgWorkFloats / (a partial row + tile),
// fixed by N, the widths and the mode's accumulators alone.
void plan(const PgDims& d, int* rpb, int* blocks) {
  const long long per = static_cast<long long>(d.net.size + 1) *
                            acc_floats(d.mm) +
                        (d.spill ? spill_tile_floats(d) : 0);
  long long cap = kPgWorkFloats / per;
  cap = cap < 1 ? 1 : (cap > kPgMaxBlocks ? kPgMaxBlocks : cap);
  const int tiles = (d.n_rows + kPgRows - 1) / kPgRows;
  *rpb = (tiles + static_cast<int>(cap) - 1) / static_cast<int>(cap) *
         kPgRows;
  *blocks = (d.n_rows + *rpb - 1) / *rpb;
}

// Both passes of mode M, pass 1 on the route d.spill names.
template <int M>
cudaError_t run_phase(const PgDims& d, const PgConsts& c, float* p,
                      float* m, float* v, const float* obs, const int* act,
                      const float* adv, float* loss, float* workspace,
                      cudaStream_t s) {
  int rpb, blocks;
  plan(d, &rpb, &blocks);
  float* tiles = workspace + partial_floats(d, blocks);
  if (d.spill) {
    lrpg_grad_kernel<true, M><<<blocks, kThreads, 0, s>>>(
        d, c, p, obs, act, adv, workspace, rpb, tiles, spill_tile_floats(d));
  } else {
    const int smem = static_cast<int>(smem_floats(d) * sizeof(float));
    const cudaError_t err = cudaFuncSetAttribute(
        lrpg_grad_kernel<false, M>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    lrpg_grad_kernel<false, M><<<blocks, kThreads, smem, s>>>(
        d, c, p, obs, act, adv, workspace, rpb, tiles, 0);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kPass2 = M == kMmF64 || M == kMmF16 ? M : kMmF32;
  const int P = d.net.size;
  lrpg_adam_kernel<kPass2><<<(P + kThreads) / kThreads, kThreads, 0, s>>>(
      c, P, blocks, workspace, p, m, v, loss, d.torso, d.net, d.obs_dim);
  return cudaGetLastError();
}

}  // namespace

// Both passes at the X3 and X6 instances (lrpg_update_x3x6.cu) and at the
// F64 and F16 ones (lrpg_update_f64f16.cu), each made in a translation
// unit that includes this source with CP_MM_PRESET_UNIT defined.
cudaError_t cp_lrpg_x3x6_phase(const PgDims& d, const PgConsts& c, float* p,
                               float* m, float* v, const float* obs,
                               const int* act, const float* adv, float* loss,
                               float* workspace, cudaStream_t s);
cudaError_t cp_lrpg_f64f16_phase(const PgDims& d, const PgConsts& c,
                                 float* p, float* m, float* v,
                                 const float* obs, const int* act,
                                 const float* adv, float* loss,
                                 float* workspace, cudaStream_t s);

#if CP_MM_PRESET_UNIT == 1
cudaError_t cp_lrpg_x3x6_phase(const PgDims& d, const PgConsts& c, float* p,
                               float* m, float* v, const float* obs,
                               const int* act, const float* adv, float* loss,
                               float* workspace, cudaStream_t s) {
  if (d.mm == kMmX3)
    return run_phase<kMmX3>(d, c, p, m, v, obs, act, adv, loss, workspace,
                            s);
  return run_phase<kMmX6>(d, c, p, m, v, obs, act, adv, loss, workspace, s);
}
#elif CP_MM_PRESET_UNIT == 2
cudaError_t cp_lrpg_f64f16_phase(const PgDims& d, const PgConsts& c,
                                 float* p, float* m, float* v,
                                 const float* obs, const int* act,
                                 const float* adv, float* loss,
                                 float* workspace, cudaStream_t s) {
  if (d.mm == kMmF64)
    return run_phase<kMmF64>(d, c, p, m, v, obs, act, adv, loss, workspace,
                             s);
  return run_phase<kMmF16>(d, c, p, m, v, obs, act, adv, loss, workspace, s);
}
#else

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
// window's loss; workspace: cp_lrpg_workspace_floats floats; dims->mm
// picks pass 1's instance. Returns a cudaError_t.
int cp_lrpg_update_phase(const PgDims* dims, const int* widths,
                         const PgConsts* consts, float* p, float* m, float* v,
                         const float* obs, const int* act, const float* adv,
                         float* loss, float* workspace, void* stream) {
  PgDims d;
  if (!with_sums(dims, widths, &d) || !route_ok(d))
    return static_cast<int>(cudaErrorInvalidValue);
  const PgConsts c = *consts;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (d.mm == kMmF32)
    err = run_phase<kMmF32>(d, c, p, m, v, obs, act, adv, loss, workspace, s);
#ifndef CP_STAGE_CLOCK  // a stage-clock build times the float32 pass alone
  else if (d.mm == kMmBf16)
    err = run_phase<kMmBf16>(d, c, p, m, v, obs, act, adv, loss, workspace,
                             s);
  else if (d.mm == kMmTf32)
    err = run_phase<kMmTf32>(d, c, p, m, v, obs, act, adv, loss, workspace,
                             s);
  else if (d.mm == kMmX3 || d.mm == kMmX6)
    err = cp_lrpg_x3x6_phase(d, c, p, m, v, obs, act, adv, loss, workspace,
                             s);
  else
    err = cp_lrpg_f64f16_phase(d, c, p, m, v, obs, act, adv, loss,
                               workspace, s);
#endif
  return static_cast<int>(err);
}

}  // extern "C"
#endif  // CP_MM_PRESET_UNIT
