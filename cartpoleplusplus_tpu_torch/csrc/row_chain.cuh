// The row chains of the cooperative learner kernels B3 (ddpg_update.cu), B5
// (dqn_update.cu) and B7 (naf_update.cu): per update a few grid-synced
// stages, each a list of independent items dealt to the blocks.
//   * Forward items: a tile of R batch rows (kRowsF = 8; B7's 4) through
//     the layers of one network and its head (B3 splits its critic at
//     layer 1, where the actor's action joins: the layer's sums over its
//     first inputs in a forward item, the rest in the backward item that
//     needs it). Activations are feature-major in shared memory, the
//     pre-LN rows row-major; each layer's weights stream by cp.async (16-
//     or 8-byte pieces where the rows allow) through a ring of kStages = 3
//     chunks of 32 inputs x 256 outputs, 2 in flight while one is
//     multiplied (3 in flight measured slower on the H100), a thread
//     owning kColsF columns for its rows (torso_fwd, head_fwd).
//   * Backward items: a tile of kRowsB = 4 rows: a kernel's epilogue, the
//     head's backward, and per layer the LayerNorm/relu backward and dh =
//     dz W through the same ring (head_bwd, torso_bwd).
//   * The gradient stage: every weight gradient in 32 x 32 tiles, the
//     tile's columns of the whole batch staged in shared memory and each
//     thread summing 2 x 2 elements over the batch in order; the bias and
//     LayerNorm gradients (64 elements an item) and the loss in the stage
//     engine's orders; Adam and Polyak on each element (grad_stage). Under
//     a global-norm clip the stage stores the flat gradient instead and
//     counts the elements of each of kNormParts fixed slices as they land;
//     the block that completes a slice sums its squares (FlatStore), so the
//     norm's partial sums need no stage of their own.
// Where an item's buffers do not fit in shared memory beside the ring they
// live in the item's slice of the workspace: the same code with other
// pointers (RowPlan). Every product sums its inputs in order from zero with
// fmaf and adds the bias last (a joined input's products summed apart and
// added first), every batch sum runs in a fixed order, and the LayerNorm
// statistics and backward follow learner_stages.cuh's lane order (ln_stats):
// the orders of the stage-engine design these kernels replaced, whose bits
// they give. The bits do not depend on the grid, the route or the block
// that takes an item. No float atomics (the slice counts are integers):
// two runs give the same bits.
#pragma once

#include <cstdint>

#include "learner_stages.cuh"

namespace {

constexpr int kRowsF = 8;         // batch rows of a forward item
constexpr int kLdF = kRowsF + 4;  // feature stride of its activations
constexpr int kRowsB = 4;         // batch rows of a backward item
constexpr int kLdB = kRowsB;      // feature stride of its dz
constexpr int kColsF = 2;         // output columns of a forward thread
constexpr int kColsB = 2;         // output columns of a backward thread
constexpr int kWk = 32;           // weight rows (inputs) of a chunk
constexpr int kStages = 3;        // chunks in the ring
constexpr int kPanel = 256;       // output columns of a chunk
constexpr int kWLd = kPanel + 4;  // input stride of a backward chunk
constexpr int kWT = kWk + 4;      // column stride of a forward chunk
constexpr int kWSlot = kPanel * kWT > kWk * kWLd ? kPanel * kWT : kWk * kWLd;
constexpr int kRing = kStages * kWSlot;
constexpr int kQLd = 8;           // stride of a row's head values
constexpr int kMaxJoin = 2;       // inputs joined at layer 1, at most
// Shared memory of the ring and of a backward item's d loss / d head, in
// floats; an item's buffers follow unless they spill. The gradient stage
// reuses it.
constexpr int kFixed = kRing + kRowsB * kQLd;
constexpr int kGT = 32;           // a weight-gradient tile's edge
constexpr int kGB = 256;          // batch rows of it staged at a time
static_assert(2 * kGB * kGT <= kFixed, "the gradient tile in the ring");
static_assert(kThreads % kWk == 0, "whole chunk rows a pass");
static_assert(kPanel == kThreads, "one output column a thread");
static_assert(kRowsB <= kWarps, "one warp a backward row");
// Dynamic shared memory a block may take: ops/_native.py::MAX_SMEM less
// 4 KB of room.
constexpr int kDynSmem = 232448 - 4096;

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// Where an item's buffers go: in shared memory after the fixed part, or
// (spill) in the item's slice of the workspace, tile_floats each.
struct RowPlan {
  int spill, wmax, ldz;
  int region;  // floats of a block's shared region; the table follows
  long long tile_floats;
};

// The items' plan for a torso whose widest layer is hmax: a forward item
// of rows_f rows takes its activations (feature-major, rows_f + 4, over
// max(obs_dim, hmax) features), its pre-LN rows (row-major, ldz) and
// fwd_extra floats; a backward item its dh rows (row-major, ldz), its dz
// (feature-major, kLdB, over ldz features) and bwd_extra floats. Both use
// one buffer of the larger size, in the workspace when spill asks for it
// or it does not fit in shared memory beside the ring and the table (n_tab
// ints).
inline RowPlan row_plan(int obs_dim, int hmax, int n_tab, int spill,
                        int rows_f, int fwd_extra, int bwd_extra) {
  RowPlan rp{};
  rp.wmax = obs_dim > hmax ? obs_dim : hmax;
  rp.ldz = pad4(hmax);
  const long long fwd = static_cast<long long>(rows_f + 4) * rp.wmax +
                        static_cast<long long>(rows_f) * rp.ldz + fwd_extra;
  const long long bwd = static_cast<long long>(kRowsB + kLdB) * rp.ldz +
                        bwd_extra;
  const long long bufs = fwd > bwd ? fwd : bwd;
  rp.tile_floats = (bufs + 31) / 32 * 32;
  rp.spill = spill || (kFixed + bufs + n_tab) * 4 > kDynSmem;
  rp.region = kFixed + (rp.spill ? 0 : static_cast<int>(bufs));
  return rp;
}

// Bytes of a block's dynamic shared memory under the plan.
inline size_t plan_smem(const RowPlan& rp, int n_tab) {
  return sizeof(float) * static_cast<size_t>(rp.region) +
         sizeof(int) * static_cast<size_t>(n_tab);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
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

// Floats a cp.async of a product's weights may take at once: 4 or 2 where
// W and its row stride ldw allow, else 1.
__device__ __forceinline__ int ring_vec(const float* W, int ldw) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(W);
  if ((a & 15) == 0 && ldw % 4 == 0) return 4;
  if ((a & 7) == 0 && ldw % 2 == 0) return 2;
  return 1;
}

// Issues chunk q of nq of a product's weights into its ring slot, by
// cp.async, and commits a group (an empty one past the last chunk). Chunk
// q: inputs (q % nch) kWk .. + kWk of the output panel q / nch. kTrans: W
// is a torch (n, >= K) weight of row stride ldw, read as its transpose (the
// forward), each column's run of inputs at kWT floats; else a (K, >= n)
// matrix of row stride ldw read as it is (dh = dz W), each input's row of
// the panel at kWLd floats. Pieces of vec floats (ring_vec) where the chunk
// allows.
template <bool kTrans>
__device__ __forceinline__ void issue_chunk(float* ring, int q, int nq,
                                            int nch, int n, int K,
                                            const float* W, int ldw,
                                            int vec) {
  if (q < nq) {
    float* const slot = ring + (q % kStages) * kWSlot;
    const int c0 = (q / nch) * kPanel, k0 = (q % nch) * kWk;
    const int pw = min(kPanel, n - c0), kc = min(kWk, K - k0);
    const int tid = threadIdx.x;
    if constexpr (kTrans) {
      const float* src = W + static_cast<size_t>(c0) * ldw + k0;
      if (vec == 4 && kc % 4 == 0) {
        for (int i = tid; i < pw * (kWk / 4); i += kThreads) {
          const int cc = i / (kWk / 4), g = 4 * (i % (kWk / 4));
          if (g < kc)
            cp_async16(slot + cc * kWT + g,
                       src + static_cast<size_t>(cc) * ldw + g);
        }
      } else if (vec >= 2 && kc % 2 == 0) {
        for (int i = tid; i < pw * (kWk / 2); i += kThreads) {
          const int cc = i / (kWk / 2), g = 2 * (i % (kWk / 2));
          if (g < kc)
            cp_async8(slot + cc * kWT + g,
                      src + static_cast<size_t>(cc) * ldw + g);
        }
      } else {
        for (int i = tid; i < pw * kWk; i += kThreads) {
          const int cc = i / kWk, kk = i % kWk;
          if (kk < kc)
            cp_async4(slot + cc * kWT + kk,
                      src + static_cast<size_t>(cc) * ldw + kk);
        }
      }
    } else {
      const float* src = W + static_cast<size_t>(k0) * ldw + c0;
      if (vec == 4 && pw % 4 == 0) {
        for (int i = tid; i < kc * (kPanel / 4); i += kThreads) {
          const int kk = i / (kPanel / 4), g = 4 * (i % (kPanel / 4));
          if (g < pw)
            cp_async16(slot + kk * kWLd + g,
                       src + static_cast<size_t>(kk) * ldw + g);
        }
      } else if (vec >= 2 && pw % 2 == 0) {
        for (int i = tid; i < kc * (kPanel / 2); i += kThreads) {
          const int kk = i / (kPanel / 2), g = 2 * (i % (kPanel / 2));
          if (g < pw)
            cp_async8(slot + kk * kWLd + g,
                      src + static_cast<size_t>(kk) * ldw + g);
        }
      } else if (tid < pw) {
        for (int kk = 0; kk < kc; ++kk)
          cp_async4(slot + kk * kWLd + tid,
                    src + static_cast<size_t>(kk) * ldw + tid);
      }
    }
  }
  cp_async_commit();
}

// Issues a product's first kStages - 1 chunks into the free ring, so that
// they can fly while the block still works on something else.
template <bool kTrans>
__device__ __forceinline__ void ring_start(float* ring, int n, int K,
                                           const float* W, int ldw) {
  const int nch = (K + kWk - 1) / kWk;
  const int nq = nch * ((n + kPanel - 1) / kPanel);
  const int vec = ring_vec(W, ldw);
  for (int q = 0; q < kStages - 1; ++q)
    issue_chunk<kTrans>(ring, q, nq, nch, n, K, W, ldw, vec);
}

// Y[r ldy + c] = sum_k X[k LDX + r] M(k, c) (+ bias[c]) for the R rows and
// c < n, k < K in order from zero: M(k, c) = W[c ldw + k] (kTrans, a torch
// weight) or W[k ldw + c]. kTrans may join na <= kMaxJoin more inputs
// xa[i LDX + r] at W[c ldw + K + i], summed apart from zero and added
// before the bias (the critic's action at layer 1). The block's threads
// form kThreads / (kPanel / CC) row groups; thread t of a group owns
// columns t + j kPanel / CC (j < CC) of each 256-column panel for its
// group's rows, so that every activation it loads serves CC columns; the
// weights stream through the ring kStages - 1 chunks ahead (the first of
// them already in flight when `started`: ring_start). Ends with a barrier.
template <int R, int LDX, bool kTrans, int CC>
__device__ void rows_product(const float* X, int K, int n, const float* W,
                             int ldw, const float* bias, float* Y, int ldy,
                             float* ring, bool started = false,
                             const float* xa = nullptr, int na = 0) {
  constexpr int kCols = kPanel / CC;         // threads of a row group
  constexpr int kGroups = kThreads / kCols;  // row groups
  constexpr int RH = R / kGroups;            // rows of a thread
  static_assert(RH % 2 == 0 && LDX % 4 == 0, "8-byte row groups");
  const int tid = threadIdx.x;
  const int ct = tid % kCols, r0 = (tid / kCols) * RH;
  const int nch = (K + kWk - 1) / kWk;
  const int nq = nch * ((n + kPanel - 1) / kPanel);
  const int vec = ring_vec(W, ldw);
  if (!started) ring_start<kTrans>(ring, n, K, W, ldw);
  float acc[CC][RH];
#pragma unroll
  for (int j = 0; j < CC; ++j)
#pragma unroll
    for (int r = 0; r < RH; ++r) acc[j][r] = 0.0f;
  for (int q = 0; q < nq; ++q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk q is in; chunk q - 1's slot is free
    issue_chunk<kTrans>(ring, q + kStages - 1, nq, nch, n, K, W, ldw, vec);
    const int c0 = (q / nch) * kPanel, k0 = (q % nch) * kWk;
    if (c0 + ct < n) {
      const float* wp =
          ring + (q % kStages) * kWSlot + (kTrans ? ct * kWT : ct);
      const float* xp = X + k0 * LDX + r0;
      auto step = [&](int kk, const float* w) {
        float x[RH];
        if constexpr (RH % 4 == 0) {
#pragma unroll
          for (int g = 0; g < RH / 4; ++g) {
            const float4 v =
                *reinterpret_cast<const float4*>(xp + kk * LDX + 4 * g);
            x[4 * g] = v.x;
            x[4 * g + 1] = v.y;
            x[4 * g + 2] = v.z;
            x[4 * g + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int g = 0; g < RH / 2; ++g) {
            const float2 v =
                *reinterpret_cast<const float2*>(xp + kk * LDX + 2 * g);
            x[2 * g] = v.x;
            x[2 * g + 1] = v.y;
          }
        }
#pragma unroll
        for (int j = 0; j < CC; ++j)
#pragma unroll
          for (int r = 0; r < RH; ++r) acc[j][r] = fmaf(x[r], w[j], acc[j][r]);
      };
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
          const int c = c0 + ct + j * kCols;
          if (c < n) {
            const float b = bias != nullptr ? bias[c] : 0.0f;
            float wa[kMaxJoin];
#pragma unroll
            for (int i = 0; i < kMaxJoin; ++i)
              wa[i] = i < na ? W[static_cast<size_t>(c) * ldw + K + i] : 0.0f;
#pragma unroll
            for (int r = 0; r < RH; ++r) {
              float v = acc[j][r];
              if (na > 0) {
                float a2 = 0.0f;
#pragma unroll
                for (int i = 0; i < kMaxJoin; ++i)
                  if (i < na) a2 = fmaf(xa[i * LDX + r0 + r], wa[i], a2);
                v = v + a2;
              }
              Y[(r0 + r) * ldy + c] = bias != nullptr ? v + b : v;
            }
          }
#pragma unroll
          for (int r = 0; r < RH; ++r) acc[j][r] = 0.0f;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring and Y are read next
}

// What a forward pass keeps for the gradient stage (each may be null):
// per-layer regions of its pre-LN rows (z) and of its layer inputs l >= 1
// (hin, layer 1's joined by `join` columns), and its last layer's output.
struct FwdSave {
  float *z, *hin, *hlast;
  int join;
};

// The torso of one network, layers l0 .. l1 - 1 (l1 <= 0: to the last),
// over R rows from b0 (nr of them real; a forward item's kRowsF, or a
// backward item's kRowsB): act (wmax, R + 4) holds each row's input to
// layer l0 (feature-major); layer l's pre-LN rows z = x W_l^T + b_l (layer
// 1 joining na inputs xa, feature-major (na, R + 4), when na > 0) go to zr
// (R, ldz), their LayerNorm + relu back into act. With zmain, layer l0's
// sums over its first inputs are given instead of multiplied (rows b0 .. of
// a (batch, H_l0) region): z = (zmain + the join's sums) + b_l0. On return
// act holds layer l1 - 1's output. The next layer's first chunks fly during
// each LayerNorm.
template <int R>
__device__ __forceinline__ void torso_fwd(
    const Torso& T, const NetLayout& L, const float* net, int F,
    const float* xa, int na, float* act, float* zr, int ldz, float* ring,
    const LearnerConsts& c, const FwdSave& sv, int b0, int nr, int B,
    int l0 = 0, int l1 = 0, const float* zmain = nullptr) {
  constexpr int LD = R + 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nl = T.L, lend = l1 > 0 ? l1 : nl;
  auto ldw_of = [&](int l) {
    return l == 0 ? F : T.h(l - 1) + (l == 1 ? na : 0);
  };
  for (int l = l0; l < lend; ++l) {
    const int K = l == 0 ? F : T.h(l - 1), h = T.h(l);
    const float* W = net + L.w(l);
    if (l == l0 && zmain != nullptr) {  // the given sums, the join, the bias
      const int ldw = ldw_of(l);
      for (int o = tid; o < R * h; o += kThreads) {
        const int r = o / h, cc = o - r * h;
        float v = zmain[static_cast<size_t>(b0 + min(r, nr - 1)) * h + cc];
        float a2 = 0.0f;
        for (int i = 0; i < na; ++i)
          a2 = fmaf(xa[i * LD + r], W[static_cast<size_t>(cc) * ldw + K + i],
                    a2);
        if (na > 0) v = v + a2;
        zr[r * ldz + cc] = v + net[L.b(l) + cc];
      }
      __syncthreads();
    } else {
      rows_product<R, LD, true, kColsF>(
          act, K, h, W, ldw_of(l), net + L.b(l), zr, ldz, ring, l > l0,
          l == 1 ? xa : nullptr, l == 1 ? na : 0);
    }
    if (l + 1 < lend)  // the next layer's first chunks fly during the LN
      ring_start<true>(ring, T.h(l + 1), h, net + L.w(l + 1), ldw_of(l + 1));
    // LayerNorm + relu of each row into act, one warp a row; the kept
    // rows to the workspace
    const float* s = net + L.s(l);
    const float* tb = net + L.t(l);
    float* const zs = sv.z != nullptr ? layer_rows(sv.z, T, l, B) : nullptr;
    // the joined columns after layer 0's output in layer 1's input rows
    const int sj = l == 0 && nl > 1 ? sv.join : 0;
    float* const save =
        l + 1 < nl ? (sv.hin != nullptr ? input_rows(sv.hin, T, l + 1,
                                                     sv.join, B)
                                        : nullptr)
                   : sv.hlast;
    for (int r = warp; r < R; r += kWarps) {
      const float* zrow = zr + r * ldz;
      float mu, inv;
      ln_stats(zrow, h, c.ln_eps, lane, mu, inv);
      const bool keep = r < nr;
      const size_t row = static_cast<size_t>(b0 + r);
      for (int j = lane; j < h; j += 32) {
        const float xh = (zrow[j] - mu) * inv;
        const float y = xh * s[j] + tb[j];
        const float a = fmaxf(y, 0.0f);
        act[j * LD + r] = a;
        if (keep) {
          if (zs != nullptr) zs[row * h + j] = zrow[j];
          if (save != nullptr) save[row * (h + sj) + j] = a;
        }
      }
      if (keep && save != nullptr && lane < sj)
        save[row * (h + sj) + h + lane] = xa[lane * LD + r];
    }
    __syncthreads();
  }
}

// The head of R rows: v(r, a) = sum_j act[j][r] wh[a hl + j] + bh[a] for a
// < n_head (act feature-major, (hl, R + 4)), one thread an output, its
// weights and bias first copied into the (free) ring where they fit;
// emit(r, a, v) takes each (rows past the batch too). Ends with a barrier.
template <int R, class Emit>
__device__ void head_fwd(const float* wh, const float* bh, int n_head,
                         int hl, const float* act, float* ring, Emit emit) {
  constexpr int LD = R + 4;
  static_assert(R * kQLd <= kThreads, "one thread a head output");
  const int tid = threadIdx.x;
  const int nwh = n_head * hl;
  const bool wh_in = nwh + n_head <= kRing;
  if (wh_in) {
    for (int i = tid; i < nwh + n_head; i += kThreads)
      ring[i] = i < nwh ? wh[i] : bh[i - nwh];
    __syncthreads();
  }
  if (tid < R * n_head) {
    const int r = tid / n_head, a = tid - r * n_head;
    const float* w = (wh_in ? ring : wh) + a * hl;
    const float b = wh_in ? ring[nwh + a] : bh[a];
    float acc = 0.0f;
#pragma unroll 16
    for (int j = 0; j < hl; ++j) acc = fmaf(act[j * LD + r], w[j], acc);
    emit(r, a, acc + b);
  }
  __syncthreads();
}

// The feature-major rows of R from b0: act[f][r] = src[(b0 + r) F + f] for
// the nr real rows, 0 past them (stride R + 4). Ends with a barrier.
template <int R>
__device__ __forceinline__ void load_rows(const float* src, int F, int b0,
                                          int nr, float* act) {
  for (int i = threadIdx.x; i < R * F; i += kThreads) {
    const int r = i / F, f = i - r * F;
    act[f * (R + 4) + r] =
        r < nr ? __ldg(src + static_cast<size_t>(b0 + r) * F + f) : 0.0f;
  }
  __syncthreads();
}

// The head's backward of a backward item: dh[r ldz + cc] = sum_a dqs[r kQLd
// + a] wh[a hl + cc] (from zero, a in order) for its kRowsB rows. Ends with
// a barrier.
__device__ __forceinline__ void head_bwd(const float* dqs, int n_head,
                                         const float* wh, int hl, float* dh,
                                         int ldz) {
  for (int o = threadIdx.x; o < kRowsB * hl; o += kThreads) {
    const int r = o / hl, cc = o - r * hl;
    float acc = 0.0f;
    for (int a = 0; a < n_head; ++a)
      acc = fmaf(dqs[r * kQLd + a], wh[a * hl + cc], acc);
    dh[r * ldz + cc] = acc;
  }
  __syncthreads();
}

// What a backward pass keeps for the gradient stage (null: nothing): per
// layer the rows of dz, dy and dy * xhat.
struct BwdSave {
  float *dz, *dy, *dyxh;
};

// The backward of one network's torso over a backward item's kRowsB rows
// from b0 (nr real): dh (kRowsB, ldz) holds the gradient at the last
// layer's output; z, the pass's per-layer pre-LN rows. For l = L - 1 down
// to lo: the LayerNorm/relu backward into dzs (hmax, kLdB) and the saves,
// then dh = dz W_l over the layer's input columns for l > lo. With `tail`
// (lo = 1): at layer 1 the gradient at the joined input instead (the
// critic's dQ/da: the join columns of W_1, copied into the free ring
// during the LayerNorm backward, each of the kRowsB x join sums in order
// by one thread), into tail (kRowsB, kQLd). dh = dz W's first chunks fly
// during each LayerNorm backward.
__device__ __forceinline__ void torso_bwd(
    const Torso& T, const NetLayout& L, const float* net, int join,
    const float* z, float* dh, float* dzs, int ldz, float* ring,
    const LearnerConsts& c, const BwdSave& sv, int b0, int nr, int B, int lo,
    float* tail) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int l = T.L - 1; l >= lo; --l) {
    const int h = T.h(l);
    const float* s = net + L.s(l);
    const float* tb = net + L.t(l);
    const float* W = net + L.w(l);
    const int ldw = l == 0 ? 0 : T.h(l - 1) + (l == 1 ? join : 0);
    const int pn = l > lo ? T.h(l - 1) : 0;
    const bool tl = l == lo && tail != nullptr;
    if (pn > 0)  // dh = dz W's first chunks fly during the LN backward
      ring_start<false>(ring, pn, h, W, ldw);
    if (tl) {  // the join columns of W_l: ring[j join + i] = W[j ldw + H + i]
      const int col0 = T.h(l - 1);
      for (int i = threadIdx.x; i < h * join; i += kThreads)
        ring[i] = W[static_cast<size_t>(i / join) * ldw + col0 + i % join];
    }
    if (warp < kRowsB) {  // one warp a row: dz, dy, dy * xhat
      const int r = warp;
      if (r >= nr) {
        for (int j = lane; j < h; j += 32) dzs[j * kLdB + r] = 0.0f;
      } else {
        const size_t row = static_cast<size_t>(b0 + r) * h;
        const float* zrow = layer_rows(z, T, l, B) + row;
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
        float* const gdz =
            sv.dz != nullptr ? layer_rows(sv.dz, T, l, B) + row : nullptr;
        float* const gdy =
            sv.dz != nullptr ? layer_rows(sv.dy, T, l, B) + row : nullptr;
        float* const gdyxh =
            sv.dz != nullptr ? layer_rows(sv.dyxh, T, l, B) + row : nullptr;
        for (int j = lane; j < h; j += 32) {
          const float xh = (zrow[j] - mu) * inv;
          const float y = xh * s[j] + tb[j];
          const float dy = y > 0.0f ? dhr[j] : 0.0f;
          const float dxh = dy * s[j];
          const float dz = inv * (dxh - m1 - xh * m2);
          dzs[j * kLdB + r] = dz;
          if (gdz != nullptr) {
            gdz[j] = dz;
            gdy[j] = dy;
            gdyxh[j] = dy * xh;
          }
        }
      }
    }
    __syncthreads();
    if (pn > 0)
      rows_product<kRowsB, kLdB, false, kColsB>(dzs, h, pn, W, ldw, nullptr,
                                                dh, ldz, ring, true);
    if (tl) {
      if (threadIdx.x < kRowsB * join) {
        const int r = threadIdx.x / join, i = threadIdx.x - r * join;
        float acc = 0.0f;
#pragma unroll 8
        for (int j = 0; j < h; ++j)
          acc = fmaf(dzs[j * kLdB + r], ring[j * join + i], acc);
        tail[r * kQLd + i] = acc;
      }
      __syncthreads();
    }
  }
}

// --- the gradient stage -----------------------------------------------------

// A clipped update's flat gradient (optax.clip_by_global_norm needs the
// norm of every gradient before any Adam step): the gradient stage stores
// each element at its offset in the group layout and adds the elements it
// stored in each of kNormParts fixed slices of [0, n) to the slice's count
// (integers, since the launch's start); the block whose addition completes
// a slice for update k sums its squares into parts[slice] as
// learner_stages.cuh's adam_flat expects them.
struct FlatStore {
  float* g;
  float* parts;
  int* cnt;
  int n, k;
};

// The slices this block completed in the current gradient stage.
__device__ __forceinline__ int* done_slices() {
  __shared__ int s[kNormParts + 1];  // s[0]: how many
  return s;
}

// Counts the elements [lo, hi) of the flat gradient, stored by this block
// (a block barrier, then a fence by the counting thread: the pattern of a
// grid barrier's arrival), against their slices.
__device__ void count_stored(const FlatStore& fs, int lo, int hi) {
  const int len = cdiv(fs.n, kNormParts);
  for (int p = lo / len; p * len < hi; ++p) {
    const int a = max(lo, p * len), b = min(hi, (p + 1) * len);
    const int size = min(fs.n, (p + 1) * len) - p * len;
    if (atomicAdd(fs.cnt + p, b - a) + (b - a) == (fs.k + 1) * size) {
      int* const ds = done_slices();
      ds[1 + atomicAdd(ds, 1)] = p;
    }
  }
}

// parts[p] = the sum of squares of slice p of the flat gradient for each
// slice p = ps[d], d < nd (<= kSliceBatch): thread t sums the slice's
// elements t, t + kThreads, ... in order (its share), thread d the shares
// of slice ps[d] in thread order.
constexpr int kSliceBatch = 32;
static_assert(kSliceBatch * (kThreads + 1) <= kFixed, "shares in the ring");
__device__ void norm_slices(const FlatStore& fs, const int* ps, int nd,
                            float* sm) {
  const int len = cdiv(fs.n, kNormParts);
  if (len <= 2 * kThreads) {  // at most 2 elements a thread: loads first
    float va[kSliceBatch], vb[kSliceBatch];
    int na[kSliceBatch];
#pragma unroll
    for (int d = 0; d < kSliceBatch; ++d) {
      na[d] = 0;
      if (d < nd) {
        const int lo = ps[d] * len, hi = min(fs.n, lo + len);
        const int e = lo + threadIdx.x;
        na[d] = (e < hi) + (e + kThreads < hi);
        va[d] = na[d] > 0 ? __ldcg(fs.g + e) : 0.0f;
        vb[d] = na[d] > 1 ? __ldcg(fs.g + e + kThreads) : 0.0f;
      }
    }
#pragma unroll
    for (int d = 0; d < kSliceBatch; ++d) {
      if (d >= nd) continue;
      float s = 0.0f;  // the loop below, element by element
      if (na[d] > 0) s = s + va[d] * va[d];
      if (na[d] > 1) s = s + vb[d] * vb[d];
      sm[d * (kThreads + 1) + threadIdx.x] = s;
    }
  } else {
    for (int d = 0; d < nd; ++d) {
      const int lo = ps[d] * len, hi = min(fs.n, lo + len);
      float s = 0.0f;
      for (int e = lo + threadIdx.x; e < hi; e += kThreads) {
        const float v = __ldcg(fs.g + e);
        s = s + v * v;
      }
      sm[d * (kThreads + 1) + threadIdx.x] = s;
    }
  }
  __syncthreads();
  if (threadIdx.x < nd) {
    const float* sh = sm + threadIdx.x * (kThreads + 1);
    float total = 0.0f;
    for (int i = 0; i < kThreads; ++i) total = total + sh[i];
    fs.parts[ps[threadIdx.x]] = total;
  }
  __syncthreads();
}

// One tile of a weight gradient, dW[j][i] = sum_b G[b][j] X[b][i] for j
// in [j0, j0 + 32) (< out) and i in [i0, i0 + 32) (< in), b in order from
// 0, then Adam and Polyak on each element at `off` + j in + i (kStore: the
// element stored into the flat gradient and counted). The tile's columns
// of G and X come into shared memory kGB rows at a time; a thread owns 2 x
// 2 elements.
template <bool kStore>
__device__ void grad_w_tile(const float* G, int out, const float* X, int in,
                            int B, int off, int j0, int i0, const NetPtr& net,
                            float bc1, float bc2, float lr,
                            const LearnerConsts& c, float* sm,
                            const FlatStore& fs) {
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
  int offs[4];
  bool ok[4];
  float gs[4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = j0 + 2 * jg + a, i = i0 + 2 * ig + e;
      offs[2 * a + e] = off + j * in + i;
      ok[2 * a + e] = j < out && i < in;
      gs[2 * a + e] = acc[a][e];
    }
  if constexpr (kStore) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (ok[u]) fs.g[offs[u]] = gs[u];
  } else {
    adam_elems<4>(net, offs, ok, gs, bc1, bc2, lr, c);
  }
  if constexpr (kStore) {
    __syncthreads();  // the tile's elements are stored
    const int j = j0 + tid;
    if (tid < kGT && j < out) {
      __threadfence();
      count_stored(fs, off + j * in + i0, off + j * in + min(i0 + kGT, in));
    }
  }
  __syncthreads();  // sm is free
}

// Items of a vector op (kGradV: 64 elements each) or of the loss (one).
__device__ __forceinline__ int vec_items(const GradOp& op) {
  return op.kind == kGradV ? cdiv(op.out, 2 * 32) : 1;
}

// Item `item` of a vector op: 64 elements, lane l of warp w summing rows
// of the batch's slice w (of kWarps) in order for elements l and l + 32,
// warp 0 or 1 the slices' sums in order; or the loss (loss_item).
template <bool kStore>
__device__ void vec_item(const GradOp& op, int item, int B,
                         const NetPtr* nets, const AdamStep& as,
                         const LearnerConsts& c, float* sm,
                         const FlatStore& fs) {
  if (op.kind != kGradV) {
    loss_item(op, B, sm);
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
      for (int w = 0; w < kWarps; ++w)
        g = g + sm[(warp * kWarps + w) * 32 + lane];
      if constexpr (kStore) {
        fs.g[op.off + e] = g;
      } else {
        const int off = op.off + e;
        const bool ok = true;
        adam_elems<1>(nets[op.net], &off, &ok, &g, as.bc1, as.bc2,
                      as.lr[op.net], c);
      }
    }
  }
  if constexpr (kStore) {
    __syncthreads();  // the item's elements are stored
    if (threadIdx.x == 0) {
      __threadfence();
      count_stored(fs, op.off + item * 64, op.off + min(item * 64 + 64,
                                                        op.out));
    }
  }
  __syncthreads();
}

// A weight's tiles: (out, in) in 32 x 32 pieces.
__device__ __forceinline__ int w_tiles(const GradOp& op) {
  return cdiv(op.out, kGT) * cdiv(op.in, kGT);
}

// The gradient stage of one update over n_nets networks (net_grad_op's
// lists): every weight gradient in 32 x 32 tiles (grad_w_tile), then every
// bias and LayerNorm gradient and each loss (vec_item), the items of the
// one list dealt to the blocks round-robin. Each element is reduced in a
// fixed order whichever block takes it. kStore (one network): the elements
// go to the flat gradient, and the slices this block completes are summed
// at the end of the stage.
template <bool kStore>
__device__ __forceinline__ void grad_stage(const NetGrads* g, int n_nets,
                                           const Torso& T, int F, int B,
                                           const NetPtr* nets,
                                           const AdamStep& as,
                                           const LearnerConsts& c, float* sm,
                                           const FlatStore& fs) {
  const int nl = T.L;
  if constexpr (kStore) {
    if (threadIdx.x == 0) done_slices()[0] = 0;
  }
  int total = 0;
  for (int n = 0; n < n_nets; ++n)
    for (int l = 0; l <= nl; ++l)
      total += w_tiles(net_grad_op(g[n], 4 * l, T, F, B));
  const int n_w = total;
  // The vector ops of net_grad_op's list: per layer b, scale, bias; the
  // head's b; the loss.
  auto vec_op = [&](int n, int l, int q) {
    return net_grad_op(g[n], l < nl ? 4 * l + q : 4 * nl + q, T, F, B);
  };
  for (int n = 0; n < n_nets; ++n)
    for (int l = 0; l <= nl; ++l)
      for (int q = 1; q < (l < nl ? 4 : 3); ++q)
        total += vec_items(vec_op(n, l, q));
  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    int rest = item;
    if (rest < n_w) {
      for (int n = 0; n < n_nets; ++n)
        for (int l = 0; l <= nl; ++l) {
          if (rest < 0) continue;
          const GradOp op = net_grad_op(g[n], 4 * l, T, F, B);
          const int m = w_tiles(op);
          if (rest < m) {
            const int ti = cdiv(op.in, kGT);
            grad_w_tile<kStore>(op.g, op.out, op.x, op.in, B, op.off,
                                (rest / ti) * kGT, (rest % ti) * kGT,
                                nets[op.net], as.bc1, as.bc2, as.lr[op.net],
                                c, sm, fs);
          }
          rest -= m;
        }
    } else {
      rest -= n_w;
      for (int n = 0; n < n_nets; ++n)
        for (int l = 0; l <= nl; ++l)
          for (int q = 1; q < (l < nl ? 4 : 3); ++q) {
            if (rest < 0) continue;
            const GradOp op = vec_op(n, l, q);
            const int m = vec_items(op);
            if (rest < m) vec_item<kStore>(op, rest, B, nets, as, c, sm, fs);
            rest -= m;
          }
    }
  }
  if constexpr (kStore) {
    __syncthreads();
    CP_MARK(5);  // the items
    const int nd = done_slices()[0];
    if (nd > 0) __threadfence();  // the other blocks' elements are in
    for (int d0 = 0; d0 < nd; d0 += kSliceBatch)
      norm_slices(fs, done_slices() + 1 + d0, min(kSliceBatch, nd - d0), sm);
    CP_MARK(6);  // the completed slices' sums
  }
}

}  // namespace
