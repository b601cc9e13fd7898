// Kernel B5: the whole K-update double-DQN learner phase, on Hopper.
//
// Replaces cartpoleplusplus_tpu/ops/learner_kernel.py::_dqn_update_kernel
// (the Pallas TPU kernel, made by dqn_update_phase). Per update k, on the
// presampled minibatch k: the target net and (double DQN) the online net
// on s', the online net on s; the first-max argmax of the selector picks
// the bootstrapped action; y = r + gamma (1 - done) Q'(s', a*); the
// Huber-clipped TD gradient clip(Q(s, a) - y, -1, 1) / B flows back
// through the online net; Adam at a constant lr; Polyak on the target. The
// plain twin is ops/learner_kernel.py::dqn_update_phase_math.
//
// Bound on the H100: ~95 MFLOP of matrix products per update at batch 256,
// obs 42, hidden (256, 256) (~2.9 us at 67 TFLOP/s), but the update is a
// chain of dependent steps: on the stage engine (learner_stages.cuh) each
// step was a grid-synced stage, 2L + 4 per update, and the work between
// the barriers, not the barriers, took the time (chip_smoke.py's stage
// split). Here a block takes a whole row-local chain, and the products
// are bound by shared-memory loads (a thread's loads serve kCols columns).
//
// Design: one cooperative persistent launch per phase; per update three
// stages, each a list of independent items dealt to the blocks, with a
// grid barrier after each (3 per update at any depth):
//   * Forward: an item is one pass (online on s, online on s', target on
//     s') over a tile of kRowsF = 8 batch rows, through every layer and
//     the head (96 items at batch 256). Its activations are feature-major
//     in shared memory, the pre-LN rows row-major; each layer's weights
//     stream by cp.async (16-byte pieces where the rows allow) through a
//     ring of kStages chunks of 32 inputs x 256 outputs, kStages - 1 in
//     flight while one is multiplied, a thread owning kColsF columns for
//     the tile's 8 rows. The online net on s keeps its pre-LN rows and
//     layer inputs in the workspace; every pass writes its Q values there.
//   * Backward: an item is a tile of kRowsB = 4 rows (64 items): the TD
//     epilogue, the head backward, and per layer the LayerNorm/relu
//     backward and dh = dz W (the same ring); it writes dz, dy and dy *
//     xhat per layer and the head's upstream gradient and Huber terms.
//   * Gradients: every weight gradient in 32 x 32 tiles, the tile's
//     columns of the batch rows staged in shared memory and each thread
//     summing 2 x 2 elements over the batch in order; the bias and
//     LayerNorm gradients (64 elements an item) and the loss as the stage
//     engine reduces them (grad_item); Adam and Polyak on each element.
// Where an item's buffers do not fit in shared memory beside the ring
// (a layer wider than 1008 at obs 42), they live in the item's slice of
// the workspace: the same code with other pointers. Every product sums its
// inputs in order from zero with fmaf and adds the bias last, every batch
// sum runs in the stage engine's order, and the LayerNorm statistics and
// backward follow its lane order, so B5 gives the stage engine's bits. No
// float atomics: two runs give the same bits. Any depth >= 1 and any
// width, as the reference's kernel takes (the widths and offsets are the
// learners' device table).
#include <cstdint>

#include "learner_stages.cuh"

// Mirror of ops/_native.py::DqnDims.
struct DqnDims {
  int obs_dim, batch, k_updates, double_dqn;
  Torso torso;
  NetLayout q;
  int spill;  // 1: the items' buffers in the workspace at any width
};

namespace {

constexpr int kNumActions = 5;  // ops/learner_kernel.py::NUM_ACTIONS
constexpr int kPasses = 3;      // online on s, online on s', target on s'
constexpr int kRowsF = 8;       // batch rows of a forward item
constexpr int kLdF = kRowsF + 4;  // feature stride of its activations
constexpr int kRowsB = 4;       // batch rows of a backward item
constexpr int kLdB = kRowsB;    // feature stride of its dz
constexpr int kColsF = 2;       // output columns of a forward thread
constexpr int kColsB = 2;       // output columns of a backward thread
constexpr int kWk = 32;         // weight rows (inputs) of a chunk
constexpr int kStages = 4;      // chunks in the ring
constexpr int kPanel = 256;     // output columns of a chunk
constexpr int kWLd = kPanel + 4;  // input stride of a backward chunk
constexpr int kWT = kWk + 4;      // column stride of a forward chunk
constexpr int kWSlot = kPanel * kWT > kWk * kWLd ? kPanel * kWT : kWk * kWLd;
constexpr int kRing = kStages * kWSlot;
constexpr int kQLd = 8;         // stride of a row's Q values
// Shared memory of the ring and of a backward item's d loss / dQ, in
// floats; an item's buffers follow unless they spill. The gradient stage
// reuses it.
constexpr int kFixed = kRing + kRowsB * kQLd;
constexpr int kGT = 32;         // a weight-gradient tile's edge
constexpr int kGB = 256;        // batch rows of it staged at a time
static_assert(2 * kGB * kGT <= kFixed, "the gradient tile in the ring");
static_assert(kThreads % kWk == 0, "whole chunk rows a pass");
static_assert(kPanel == kThreads, "one output column a thread");
static_assert(kRowsB <= kWarps, "one warp a backward row");
// Dynamic shared memory a block may take: ops/_native.py::MAX_SMEM less
// 4 KB of room.
constexpr int kDynSmem = 232448 - 4096;

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// The workspace: per-layer regions of the rows the gradient stage reads
// (layer l's (batch, H_l) rows at layer_rows(region, l), the layer inputs
// l >= 1 at input_rows), the pre-LN z of the online net on s, the three
// passes' Q values and, on the spill route, every item's buffers. Carved
// by carve() on the host.
struct DqnWorkspace {
  float* zS;    // pre-LN z of the online net on s
  float* hin;   // its layer inputs (l >= 1)
  float *dz, *dy, *dyxh;
  float *hlast, *dq, *hub;
  float* qv;    // (3, batch, 5) Q values by pass
  float* tiles;
};

// Where an item's buffers go: a forward item's activations (feature-major,
// kLdF) and pre-LN rows (row-major, ldz), or a backward item's dh rows
// (row-major, ldz) and dz (feature-major, kLdB), in shared memory after
// the fixed part or (spill) in the item's slice of w.tiles, tile_floats
// each.
struct RowPlan {
  int spill, wmax, ldz;
  int region;  // floats of a block's shared region; the table follows
  long long tile_floats;
};

struct DqnBatches {
  const float *obs, *rew, *nobs;
  const int* act;
  const bool* done;
};

// Ints of the device table: the widths and their prefix sums, then the
// net's per-layer offsets.
__host__ __device__ inline int table_ints(const DqnDims& d) {
  return 6 * d.torso.L;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
// 16 bytes, cached in L2 only.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issues chunk q of nq of a product's weights into its ring slot, by
// cp.async, and commits a group (an empty one past the last chunk). Chunk
// q: inputs (q % nch) kWk .. + kWk of the output panel q / nch. kTrans: W
// is a torch (n, K) weight (row stride K), read as its transpose (the
// forward), each column's run of inputs at kWT floats; else a (K, n)
// matrix read as it is (dh = dz W), each input's row of the panel at kWLd
// floats. Whole 16-byte pieces where W's rows allow (`vec`), else floats.
template <bool kTrans>
__device__ __forceinline__ void issue_chunk(float* ring, int q, int nq,
                                            int nch, int n, int K,
                                            const float* W, bool vec) {
  if (q < nq) {
    float* const slot = ring + (q % kStages) * kWSlot;
    const int c0 = (q / nch) * kPanel, k0 = (q % nch) * kWk;
    const int pw = min(kPanel, n - c0), kc = min(kWk, K - k0);
    const int tid = threadIdx.x;
    if constexpr (kTrans) {
      const float* src = W + static_cast<size_t>(c0) * K + k0;
      if (vec && kc % 4 == 0) {
        for (int i = tid; i < pw * (kWk / 4); i += kThreads) {
          const int cc = i / (kWk / 4), g = 4 * (i % (kWk / 4));
          if (g < kc)
            cp_async16(slot + cc * kWT + g, src + static_cast<size_t>(cc) * K +
                                                g);
        }
      } else {
        for (int i = tid; i < pw * kWk; i += kThreads) {
          const int cc = i / kWk, kk = i % kWk;
          if (kk < kc)
            cp_async4(slot + cc * kWT + kk,
                      src + static_cast<size_t>(cc) * K + kk);
        }
      }
    } else {
      const float* src = W + static_cast<size_t>(k0) * n + c0;
      if (vec && pw % 4 == 0) {
        for (int i = tid; i < kc * (kPanel / 4); i += kThreads) {
          const int kk = i / (kPanel / 4), g = 4 * (i % (kPanel / 4));
          if (g < pw)
            cp_async16(slot + kk * kWLd + g,
                       src + static_cast<size_t>(kk) * n + g);
        }
      } else if (tid < pw) {
        for (int kk = 0; kk < kc; ++kk)
          cp_async4(slot + kk * kWLd + tid,
                    src + static_cast<size_t>(kk) * n + tid);
      }
    }
  }
  cp_async_commit();
}

// Whether a product's weight rows take whole 16-byte pieces.
template <bool kTrans>
__device__ __forceinline__ bool ring_vec(int n, int K, const float* W) {
  return (reinterpret_cast<uintptr_t>(W) & 15) == 0 &&
         (kTrans ? K : n) % 4 == 0;
}

// Issues a product's first kStages - 1 chunks into the free ring, so that
// they can fly while the block still works on something else.
template <bool kTrans>
__device__ __forceinline__ void ring_start(float* ring, int n, int K,
                                           const float* W) {
  const int nch = (K + kWk - 1) / kWk;
  const int nq = nch * ((n + kPanel - 1) / kPanel);
  const bool vec = ring_vec<kTrans>(n, K, W);
  for (int q = 0; q < kStages - 1; ++q)
    issue_chunk<kTrans>(ring, q, nq, nch, n, K, W, vec);
}

// Y[r ldy + c] = sum_k X[k LDX + r] M(k, c) (+ bias[c]) for the R rows and
// c < n, k < K in order from zero: M(k, c) = W[c K + k] (kTrans, a torch
// (n, K) weight) or W[k n + c]. Thread t < kPanel / CC owns columns t +
// j kPanel / CC (j < CC) of each 256-column panel for all R rows, so that
// every activation it loads serves CC columns; the weights stream through
// the ring kStages - 1 chunks ahead (the first of them already in flight
// when `started`: ring_start). Ends with a barrier.
template <int R, int LDX, bool kTrans, int CC>
__device__ void rows_product(const float* X, int K, int n, const float* W,
                             const float* bias, float* Y, int ldy,
                             float* ring, bool started = false) {
  static_assert(R % 4 == 0 && LDX % 4 == 0, "16-byte row groups");
  constexpr int kCols = kPanel / CC;  // threads with columns
  const int tid = threadIdx.x;
  const int nch = (K + kWk - 1) / kWk;
  const int nq = nch * ((n + kPanel - 1) / kPanel);
  const bool vec = ring_vec<kTrans>(n, K, W);
  if (!started) ring_start<kTrans>(ring, n, K, W);
  float acc[CC][R];
#pragma unroll
  for (int j = 0; j < CC; ++j)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[j][r] = 0.0f;
  for (int q = 0; q < nq; ++q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk q is in; chunk q - 1's slot is free
    issue_chunk<kTrans>(ring, q + kStages - 1, nq, nch, n, K, W, vec);
    const int c0 = (q / nch) * kPanel, k0 = (q % nch) * kWk;
    if (tid < kCols && c0 + tid < n) {
      const float* wp =
          ring + (q % kStages) * kWSlot + (kTrans ? tid * kWT : tid);
      const float* xp = X + k0 * LDX;
      // Input kk of the chunk, the weights of the thread's columns at it.
      auto step = [&](int kk, const float* w) {
        float x[R];
#pragma unroll
        for (int g = 0; g < R / 4; ++g) {
          const float4 v =
              *reinterpret_cast<const float4*>(xp + kk * LDX + 4 * g);
          x[4 * g] = v.x;
          x[4 * g + 1] = v.y;
          x[4 * g + 2] = v.z;
          x[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < CC; ++j)
#pragma unroll
          for (int r = 0; r < R; ++r) acc[j][r] = fmaf(x[r], w[j], acc[j][r]);
      };
      // Inputs kk .. kk + 3, each column's weights one 16-byte load
      // (kTrans).
      auto step4 = [&](int kk) {
        float w[4][CC];
#pragma unroll
        for (int j = 0; j < CC; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(
              wp + j * kCols * kWT + kk);
          w[0][j] = v.x;
          w[1][j] = v.y;
          w[2][j] = v.z;
          w[3][j] = v.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) step(kk + i, w[i]);
      };
      auto step1 = [&](int kk) {
        float w[CC];
#pragma unroll
        for (int j = 0; j < CC; ++j)
          w[j] = kTrans ? wp[j * kCols * kWT + kk] : wp[kk * kWLd + j * kCols];
        step(kk, w);
      };
      const int kc = min(kWk, K - k0);
      if (kTrans && kc == kWk) {
#pragma unroll
        for (int kk = 0; kk < kWk; kk += 4) step4(kk);
      } else if (kTrans) {
        int kk = 0;
        for (; kk + 4 <= kc; kk += 4) step4(kk);
        for (; kk < kc; ++kk) step1(kk);
      } else if (kc == kWk) {
#pragma unroll
        for (int kk = 0; kk < kWk; ++kk) step1(kk);
      } else {
        for (int kk = 0; kk < kc; ++kk) step1(kk);
      }
      if (k0 + kWk >= K) {  // the panel's last chunk
#pragma unroll
        for (int j = 0; j < CC; ++j) {
          const int c = c0 + tid + j * kCols;
          if (c < n) {
            const float b = bias != nullptr ? bias[c] : 0.0f;
#pragma unroll
            for (int r = 0; r < R; ++r)
              Y[r * ldy + c] = bias != nullptr ? acc[j][r] + b : acc[j][r];
          }
#pragma unroll
          for (int r = 0; r < R; ++r) acc[j][r] = 0.0f;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring and Y are read next
}

// Forward item: pass p over the kRowsF rows from b0 through every layer
// and the head; Q values to w.qv, and for pass 0 the pre-LN rows and the
// layer inputs to the workspace.
__device__ void fwd_item(const DqnDims& d, const LearnerConsts& c,
                         const DqnWorkspace& w, const RowPlan& rp,
                         const Torso& T, const NetLayout& L, const float* net,
                         const DqnBatches& bt, int k, int b0, int p,
                         float* smem, float* bufs) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = d.batch, F = d.obs_dim, nl = T.L, hl = T.h(nl - 1);
  const int ldz = rp.ldz, nr = min(kRowsF, B - b0);
  float* const ring = smem;
  float* const act = bufs;                    // (wmax, kLdF)
  float* const zr = bufs + kLdF * rp.wmax;    // (kRowsF, ldz)
  const size_t kb = static_cast<size_t>(k) * B;
  const float* src = p == 0 ? bt.obs : bt.nobs;

  __syncthreads();  // the last item is done with the buffers
  for (int i = tid; i < kRowsF * F; i += kThreads) {
    const int r = i / F, f = i - r * F;
    act[f * kLdF + r] = r < nr ? __ldg(src + (kb + b0 + r) * F + f) : 0.0f;
  }
  __syncthreads();
  CP_MARK(3);  // the item's inputs
  for (int l = 0; l < nl; ++l) {
    const int K = l == 0 ? F : T.h(l - 1), h = T.h(l);
    rows_product<kRowsF, kLdF, true, kColsF>(act, K, h, net + L.w(l),
                                             net + L.b(l), zr, ldz, ring,
                                             l > 0);
    if (l + 1 < nl)  // the next layer's first chunks fly during the LN
      ring_start<true>(ring, T.h(l + 1), h, net + L.w(l + 1));
    // LayerNorm + relu of each row into act; the online net on s keeps its
    // pre-LN rows and its relu rows (the next layer's input, or the head's)
    const float* s = net + L.s(l);
    const float* tb = net + L.t(l);
    float* const zs = layer_rows(w.zS, T, l, B);
    float* const save =
        l + 1 < nl ? input_rows(w.hin, T, l + 1, 0, B) : w.hlast;
    for (int r = warp; r < kRowsF; r += kWarps) {  // one warp a row
      const float* zrow = zr + r * ldz;
      float mu, inv;
      ln_stats(zrow, h, c.ln_eps, lane, mu, inv);
      const bool keep = p == 0 && r < nr;
      const size_t row = static_cast<size_t>(b0 + r) * h;
      for (int j = lane; j < h; j += 32) {
        const float xh = (zrow[j] - mu) * inv;
        const float y = xh * s[j] + tb[j];
        const float a = fmaxf(y, 0.0f);
        act[j * kLdF + r] = a;
        if (keep) {
          zs[row + j] = zrow[j];
          save[row + j] = a;
        }
      }
    }
    __syncthreads();
  }
  CP_MARK(4);  // the torso

  // The head: Q(r, a), one thread an output, its weights and bias first
  // copied into the ring where they fit.
  const int nwh = kNumActions * hl;
  const bool wh_in = nwh + kNumActions <= kRing;
  if (wh_in) {
    for (int i = tid; i < nwh + kNumActions; i += kThreads)
      ring[i] = net[i < nwh ? L.wh + i : L.bh + i - nwh];
    __syncthreads();
  }
  static_assert(kRowsF * kNumActions <= kThreads, "one thread an output");
  if (tid < kRowsF * kNumActions) {
    const int r = tid / kNumActions, a = tid - r * kNumActions;
    const float* wh = (wh_in ? ring : net + L.wh) + a * hl;
    const float bh = wh_in ? ring[nwh + a] : net[L.bh + a];
    float acc = 0.0f;
#pragma unroll 8
    for (int j = 0; j < hl; ++j) acc = fmaf(act[j * kLdF + r], wh[j], acc);
    if (r < nr)
      w.qv[(static_cast<size_t>(p) * B + b0 + r) * kNumActions + a] =
          acc + bh;
  }
  CP_MARK(5);  // the head
}

// Backward item: the kRowsB rows from b0: the TD epilogue, the head
// backward, and per layer the LayerNorm/relu backward and dh = dz W;
// writes dz, dy, dy * xhat, d loss / dQ and the Huber terms.
__device__ void bwd_item(const DqnDims& d, const LearnerConsts& c,
                         const DqnWorkspace& w, const RowPlan& rp,
                         const Torso& T, const NetLayout& L, const float* Q,
                         const DqnBatches& bt, int k, int b0, float* smem,
                         float* bufs) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = d.batch, nl = T.L, hl = T.h(nl - 1);
  const int ldz = rp.ldz, nr = min(kRowsB, B - b0);
  float* const ring = smem;
  float* const dqs = smem + kRing;          // (kRowsB, kQLd) d loss / dQ
  float* const dh = bufs;                   // (kRowsB, ldz)
  float* const dzs = bufs + kRowsB * ldz;   // (hmax, kLdB)
  const size_t kb = static_cast<size_t>(k) * B;

  __syncthreads();  // the last item is done with the buffers
  // ---- the TD epilogue, one row a thread: the first-max argmax of the
  // selector (the online net on s' under double DQN, else the target;
  // a strict >, jnp.argmax's tie rule), the target y, the Huber-clipped
  // gradient at the taken action and the row's Huber term ----
  if (tid < kRowsB) {
    const int r = tid;
    float* dqr = dqs + r * kQLd;
    if (r < nr) {
      const size_t b = static_cast<size_t>(b0 + r);
      const float* qs = w.qv + b * kNumActions;
      const float* qt = w.qv + (2 * static_cast<size_t>(B) + b) * kNumActions;
      const float* sel =
          d.double_dqn ? w.qv + (static_cast<size_t>(B) + b) * kNumActions
                       : qt;
      int first = 0;
      float best = sel[0];
      for (int a = 1; a < kNumActions; ++a) {
        if (sel[a] > best) {
          best = sel[a];
          first = a;
        }
      }
      const float notdone = 1.0f - (bt.done[kb + b] ? 1.0f : 0.0f);
      const float y = bt.rew[kb + b] + (c.gamma * notdone) * qt[first];
      const int ar = bt.act[kb + b];
      const float td = qs[ar] - y;
      const float g = fminf(fmaxf(td, -1.0f), 1.0f) * c.inv_batch;
      for (int a = 0; a < kNumActions; ++a) {
        dqr[a] = a == ar ? g : 0.0f;
        w.dq[b * kNumActions + a] = dqr[a];
      }
      const float abs_td = fabsf(td);
      w.hub[b] = abs_td <= 1.0f ? 0.5f * td * td : 1.0f * (abs_td - 0.5f);
    } else {
      for (int a = 0; a < kNumActions; ++a) dqr[a] = 0.0f;
    }
  }
  __syncthreads();

  // ---- the head, then each layer ----
  for (int o = tid; o < kRowsB * hl; o += kThreads) {
    const int r = o / hl, cc = o - r * hl;
    float acc = 0.0f;
    for (int a = 0; a < kNumActions; ++a)
      acc = fmaf(dqs[r * kQLd + a], Q[L.wh + a * hl + cc], acc);
    dh[r * ldz + cc] = acc;
  }
  __syncthreads();
  for (int l = nl - 1; l >= 0; --l) {
    const int h = T.h(l);
    const float* s = Q + L.s(l);
    const float* tb = Q + L.t(l);
    if (l > 0)  // dh = dz W's first chunks fly during the LN backward
      ring_start<false>(ring, T.h(l - 1), h, Q + L.w(l));
    if (warp < kRowsB) {  // one warp a row: dz, dy, dy * xhat
      const int r = warp;
      if (r >= nr) {
        for (int j = lane; j < h; j += 32) dzs[j * kLdB + r] = 0.0f;
      } else {
        const size_t row = static_cast<size_t>(b0 + r) * h;
        const float* zrow = layer_rows(w.zS, T, l, B) + row;
        const float* dhr = dh + r * ldz;
        float mu, inv;
        ln_stats(zrow, h, c.ln_eps, lane, mu, inv);
        float a1 = 0.0f, a2 = 0.0f;
        for (int j = lane; j < h; j += 32) {
          const float xh = (zrow[j] - mu) * inv;
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
        float* const gdz = layer_rows(w.dz, T, l, B) + row;
        float* const gdy = layer_rows(w.dy, T, l, B) + row;
        float* const gdyxh = layer_rows(w.dyxh, T, l, B) + row;
        for (int j = lane; j < h; j += 32) {
          const float xh = (zrow[j] - mu) * inv;
          const float y = xh * s[j] + tb[j];
          const float dy = y > 0.0f ? dhr[j] : 0.0f;
          const float dxh = dy * s[j];
          const float dz = inv * (dxh - m1 - xh * m2);
          dzs[j * kLdB + r] = dz;
          gdz[j] = dz;
          gdy[j] = dy;
          gdyxh[j] = dy * xh;
        }
      }
    }
    __syncthreads();
    if (l > 0)
      rows_product<kRowsB, kLdB, false, kColsB>(dzs, h, T.h(l - 1),
                                                Q + L.w(l), nullptr, dh, ldz,
                                                ring, true);
  }
  CP_MARK(6);  // the backward
}

// One tile of a weight gradient, dW[j][i] = sum_b G[b][j] X[b][i] for j
// in [j0, j0 + 32) (< out) and i in [i0, i0 + 32) (< in), b in order from
// 0 (the stage engine's order), then Adam and Polyak on each element at
// `off` + j in + i. The tile's columns of G and X come into shared memory
// kGB rows at a time; a thread owns 2 x 2 elements.
__device__ void grad_w_tile(const float* G, int out, const float* X, int in,
                            int B, int off, int j0, int i0, const NetPtr& net,
                            const AdamStep& as, const LearnerConsts& c,
                            float* sm) {
  float* const Gs = sm;              // (kGB, kGT)
  float* const Xs = sm + kGB * kGT;  // (kGB, kGT)
  const int tid = threadIdx.x, ig = tid % 16, jg = tid / 16;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  // Whole 16-byte pieces where the rows allow and the tile is full.
  const bool gv = (reinterpret_cast<uintptr_t>(G) & 15) == 0 &&
                  out % 4 == 0 && j0 + kGT <= out;
  const bool xv = (reinterpret_cast<uintptr_t>(X) & 15) == 0 &&
                  in % 4 == 0 && i0 + kGT <= in;
  for (int b0 = 0; b0 < B; b0 += kGB) {
    const int nb = min(kGB, B - b0);
    __syncthreads();  // the last rows are read
    for (int idx = tid; idx < nb * kGT / 4; idx += kThreads) {
      const int e = 4 * (idx % (kGT / 4));
      const size_t b = static_cast<size_t>(b0 + idx / (kGT / 4));
      float* const gs = Gs + 4 * idx;
      float* const xs = Xs + 4 * idx;
      if (gv) {
        cp_async16(gs, G + b * out + j0 + e);
      } else {
        for (int u = 0; u < 4; ++u) {
          if (j0 + e + u < out)
            cp_async4(gs + u, G + b * out + j0 + e + u);
          else
            gs[u] = 0.0f;
        }
      }
      if (xv) {
        cp_async16(xs, X + b * in + i0 + e);
      } else {
        for (int u = 0; u < 4; ++u) {
          if (i0 + e + u < in)
            cp_async4(xs + u, X + b * in + i0 + e + u);
          else
            xs[u] = 0.0f;
        }
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 4
    for (int bb = 0; bb < nb; ++bb) {
      const float2 g = *reinterpret_cast<const float2*>(Gs + bb * kGT +
                                                        2 * jg);
      const float2 x = *reinterpret_cast<const float2*>(Xs + bb * kGT +
                                                        2 * ig);
      acc[0][0] = fmaf(g.x, x.x, acc[0][0]);
      acc[0][1] = fmaf(g.x, x.y, acc[0][1]);
      acc[1][0] = fmaf(g.y, x.x, acc[1][0]);
      acc[1][1] = fmaf(g.y, x.y, acc[1][1]);
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = j0 + 2 * jg + a, i = i0 + 2 * ig + e;
      if (j < out && i < in)
        adam_elem(net, off + j * in + i, acc[a][e], as.bc1, as.bc2,
                  as.lr[0], c);
    }
  __syncthreads();  // sm is free
}

// Items of a vector op (kGradV: 64 elements each) or of the loss (one).
__device__ __forceinline__ int vec_items(const GradOp& op) {
  return op.kind == kGradV ? cdiv(op.out, 2 * 32) : 1;
}

// Item `item` of a vector op: grad_item's kGradV for 64 elements, lane l
// of warp w summing rows of slice w for elements l and l + 32 (the same
// sums in the same order), or the loss by grad_item.
__device__ void vec_item(const GradOp& op, int item, int B,
                         const NetPtr* nets, const AdamStep& as,
                         const LearnerConsts& c, float* sm) {
  if (op.kind != kGradV) {
    grad_item(op, item, B, nets, as, c, sm);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slice = cdiv(B, kWarps);
  const int b_end = min(B, (warp + 1) * slice);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int e = item * 64 + h * 32 + lane;
    float s = 0.0f;
    if (e < op.out) {
      for (int b = warp * slice; b < b_end; ++b)
        s = s + op.g[static_cast<size_t>(b) * op.out + e];
    }
    sm[(h * kWarps + warp) * 32 + lane] = s;
  }
  __syncthreads();
  if (warp < 2) {
    const int e = item * 64 + warp * 32 + lane;
    if (e < op.out) {
      float g = 0.0f;
      for (int w = 0; w < kWarps; ++w) g = g + sm[(warp * kWarps + w) * 32 + lane];
      adam_elem(nets[op.net], op.off + e, g, as.bc1, as.bc2, as.lr[op.net],
                c);
    }
  }
  __syncthreads();
}

// The gradient stage of update k: every weight gradient in 32 x 32 tiles
// (grad_w_tile), then every bias and LayerNorm gradient and the loss as
// the stage engine reduces them (grad_item), the items of the one list
// dealt to the blocks round-robin. Each element is reduced in a fixed
// order whichever block takes it.
__device__ void grad_stage(const DqnDims& d, const LearnerConsts& c,
                           const DqnWorkspace& w, const Torso& T,
                           const NetLayout& L, const NetPtr* nets,
                           const AdamStep& as, const float* obs,
                           float* loss, float* sm) {
  const int B = d.batch, F = d.obs_dim, nl = T.L;
  const NetGrads ng{0, 0, kNumActions, 0, c.inv_batch, loss, obs, w.dz,
                    w.dy, w.dyxh, w.hin, w.dq, w.hlast, w.hub, L};
  auto tiles_of = [](int out, int in) {
    return cdiv(out, kGT) * cdiv(in, kGT);
  };
  int total = 0;
  for (int l = 0; l <= nl; ++l)
    total += l < nl ? tiles_of(T.h(l), l == 0 ? F : T.h(l - 1))
                    : tiles_of(kNumActions, T.h(nl - 1));
  const int n_w = total;
  // The vector ops of net_grad_op's list: per layer b, scale, bias; the
  // head's b; the loss.
  for (int l = 0; l <= nl; ++l)
    for (int q = 1; q < 4; ++q) {
      if (l == nl && q > 2) break;
      total += vec_items(net_grad_op(ng, l < nl ? 4 * l + q : 4 * nl + q,
                                     T, F, B));
    }
  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    if (item < n_w) {
      int rest = item, l = 0;
      for (;; ++l) {
        const int out = l < nl ? T.h(l) : kNumActions;
        const int in = l < nl ? (l == 0 ? F : T.h(l - 1)) : T.h(nl - 1);
        const int n = tiles_of(out, in);
        if (rest >= n) {
          rest -= n;
          continue;
        }
        const int ti = cdiv(in, kGT);
        const float* G = l < nl ? layer_rows(w.dz, T, l, B) : w.dq;
        const float* X = l == nl ? w.hlast
                         : l == 0 ? obs
                                  : input_rows(w.hin, T, l, 0, B);
        grad_w_tile(G, out, X, in, B, l < nl ? L.w(l) : L.wh,
                    (rest / ti) * kGT, (rest % ti) * kGT, nets[0], as, c,
                    sm);
        break;
      }
    } else {
      int rest = item - n_w;
      for (int l = 0; l <= nl; ++l)
        for (int q = 1; q < 4; ++q) {
          if (rest < 0 || (l == nl && q > 2)) continue;
          const GradOp op = net_grad_op(ng, l < nl ? 4 * l + q : 4 * nl + q,
                                        T, F, B);
          const int n = vec_items(op);
          if (rest < n) vec_item(op, rest, B, nets, as, c, sm);
          rest -= n;
        }
    }
  }
}

__global__ void __launch_bounds__(kThreads) dqn_update_kernel(
    const DqnDims d, const LearnerConsts c, const DqnWorkspace w,
    float* __restrict__ qp, float* __restrict__ qtp, float* __restrict__ m,
    float* __restrict__ v, const DqnBatches bt, float* __restrict__ loss,
    const int t0, const RowPlan rp) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int B = d.batch, F = d.obs_dim;
  int* const tab = reinterpret_cast<int*>(smem + rp.region);
  const Torso T = stage_table(d.torso, table_ints(d), tab);
  const NetLayout L = layout_on(d.q, d.torso, T);
  const NetPtr nets[1] = {{qp, qtp, m, v}};
  const int tiles_f = (B + kRowsF - 1) / kRowsF;
  const int tiles_b = (B + kRowsB - 1) / kRowsB;
  auto bufs_of = [&](int item) {
    return rp.spill ? w.tiles + rp.tile_floats * item : smem + kFixed;
  };

  for (int k = 0; k < d.k_updates; ++k) {
    const float tk = static_cast<float>(t0 + k + 1);
    AdamStep as;
    as.bc1 = 1.0f - expf(tk * c.log_b1);
    as.bc2 = 1.0f - expf(tk * c.log_b2);
    as.lr[0] = as.lr[1] = c.actor_lr;

    // Forward items: (pass, tile); pass 1 under double DQN only.
    const int n_f = (d.double_dqn ? 3 : 2) * tiles_f;
    for (int item = blockIdx.x; item < n_f; item += gridDim.x) {
      int p = item / tiles_f;
      if (p == 1 && !d.double_dqn) p = 2;
      fwd_item(d, c, w, rp, T, L, p == 2 ? qtp : qp, bt, k,
               (item % tiles_f) * kRowsF, p, smem, bufs_of(item));
    }
    grid.sync();
    for (int item = blockIdx.x; item < tiles_b; item += gridDim.x)
      bwd_item(d, c, w, rp, T, L, qp, bt, k, item * kRowsB, smem,
               bufs_of(item));
    grid.sync();
    grad_stage(d, c, w, T, L, nets, as,
               bt.obs + static_cast<size_t>(k) * B * F, loss + k, smem);
    grid.sync();
  }
}

// The dims as the host checks them against its copy of the widths; *sum
// and *hmax get the widths' sum and max.
bool dims_ok(const DqnDims& d, const int* widths, long long* sum,
             int* hmax) {
  return d.obs_dim >= 1 && d.batch >= 1 && d.k_updates >= 1 &&
         (d.spill == 0 || d.spill == 1) && d.torso.tab != nullptr &&
         d.q.lay != nullptr &&
         widths_ok(widths, d.torso.L, 1, sum, hmax, 0);
}

// The items' plan: the spill route when d.spill asks for it or an item's
// buffers (a forward item's, the larger) do not fit in shared memory
// beside the ring and the table.
RowPlan row_plan(const DqnDims& d, int hmax) {
  static_assert(kRowsB <= kRowsF && kLdB <= kLdF, "forward's the larger");
  RowPlan rp{};
  rp.wmax = d.obs_dim > hmax ? d.obs_dim : hmax;
  rp.ldz = pad4(hmax);
  const long long bufs =
      static_cast<long long>(kLdF) * rp.wmax +
      static_cast<long long>(kRowsF) * rp.ldz;
  rp.tile_floats = (bufs + 31) / 32 * 32;
  rp.spill = d.spill || (kFixed + bufs + table_ints(d)) * 4 > kDynSmem;
  rp.region = kFixed + (rp.spill ? 0 : static_cast<int>(bufs));
  return rp;
}

// Carves the workspace from `base` (or only counts floats when it is null).
long long carve(const DqnDims& d, const int* widths, float* base,
                DqnWorkspace* w) {
  long long off = 0;
  auto take = [&](long long n) -> float* {
    float* p = base != nullptr ? base + off : nullptr;
    off += (n + 31) / 32 * 32;   // 128-byte aligned pieces
    return p;
  };
  long long sum;
  int hmax;
  dims_ok(d, widths, &sum, &hmax);
  const RowPlan rp = row_plan(d, hmax);
  const long long B = d.batch;
  const long long hl = widths[d.torso.L - 1];
  const long long items = kPasses * ((B + kRowsF - 1) / kRowsF);
  *w = DqnWorkspace{};
  w->zS = take(B * sum);
  w->hin = take(B * (sum - hl));
  w->dz = take(B * sum);
  w->dy = take(B * sum);
  w->dyxh = take(B * sum);
  w->hlast = take(B * hl);
  w->dq = take(B * kNumActions);
  w->hub = take(B);
  w->qv = take(kPasses * B * kNumActions);
  w->tiles = rp.spill ? take(items * rp.tile_floats) : nullptr;
  return off;
}

}  // namespace

extern "C" {

// Floats of workspace cp_dqn_update_phase needs for these dims (0 when the
// dims are outside what the kernel takes). widths: the host's copy of the
// torso's widths (dims->torso.L ints).
long long cp_dqn_workspace_floats(const DqnDims* dims, const int* widths) {
  long long sum;
  int hmax;
  if (!dims_ok(*dims, widths, &sum, &hmax)) return 0;
  DqnWorkspace w;
  return carve(*dims, widths, nullptr, &w);
}

// The K-update phase in one cooperative launch on `stream`. widths: as
// above; dims->torso.tab and dims->q.lay: the device table
// (ops/learner_kernel.py::_learner_table). q, q_t, m, v: the 4 group
// buffers (updated in place); batches: obs (K, B, F), act (K, B) int32,
// rew (K, B), nobs (K, B, F), done (K, B) bool; loss (K,); workspace:
// cp_dqn_workspace_floats(dims, widths) floats; t0: the Adam count before
// the phase. Returns a cudaError_t.
int cp_dqn_update_phase(const DqnDims* dims, const int* widths,
                        const LearnerConsts* consts, float* q, float* q_t,
                        float* m, float* v, const float* obs, const int* act,
                        const float* rew, const float* nobs, const bool* done,
                        float* loss, float* workspace, int t0, void* stream) {
  DqnDims d = *dims;
  LearnerConsts c = *consts;
  long long sum;
  int hmax;
  if (!dims_ok(d, widths, &sum, &hmax))
    return static_cast<int>(cudaErrorInvalidValue);
  DqnWorkspace w;
  carve(d, widths, workspace, &w);
  DqnBatches bt = {obs, rew, nobs, act, done};
  RowPlan rp = row_plan(d, hmax);
  const size_t smem = sizeof(float) * static_cast<size_t>(rp.region) +
                      sizeof(int) * static_cast<size_t>(table_ints(d));
  static int blocks = 0;
  static size_t blocks_smem = 0;
  void* args[] = {&d, &c, &w, &q, &q_t, &m, &v, &bt, &loss, &t0, &rp};
  return static_cast<int>(launch_cooperative(
      reinterpret_cast<const void*>(dqn_update_kernel), smem, args,
      static_cast<cudaStream_t>(stream), blocks, blocks_smem));
}

}  // extern "C"
