// The stage engine of the cooperative learner kernels B3 (ddpg_update.cu)
// and B7 (naf_update.cu): one persistent launch per K-update phase in which
// every block walks the same list of stages, separated by
// cg::this_grid().sync(). B5 (dqn_update.cu) and B9 (lrpg_update.cu) take
// its tables, its LayerNorm helpers and B5 its gradient items and Adam.
//   * Row stages: the batch is cut into 16-row tiles and each layer's
//     outputs into 32-column tiles; a block takes (row tile, column tile)
//     items. It first computes its rows' statistics over the whole input
//     row (LayerNorm's mean and 1 / sqrt(var + eps); for the LayerNorm
//     backward also the means of dxh and dxh * xh), one warp per row, then
//     walks the input features in chunks of at most kKc: it rebuilds the
//     chunk of its rows' layer input in shared memory (copy, LayerNorm +
//     relu of the previous pre-LN z, or the LayerNorm backward from the
//     upstream gradient and the saved z), stages the chunk's rows of a
//     32-column tile of the weight beside it, and adds the chunk's
//     products to its running sums. The chunks run in order and the sums
//     stay in registers, so a row is summed in the same order at every
//     width: a layer of any width takes the same bits as one chunk would.
//     The matrix products are computed here, thread by thread (one column
//     and two rows each); no library GEMM is called. Up to kMaxRowOps
//     independent products share one stage.
//   * Gradient stages: every element of a gradient is one thread's sum
//     over the batch in a fixed order (32 x 32 weight tiles through shared
//     memory; 8 fixed row slices for the vectors), then Adam and Polyak
//     on that element in the same thread. No float atomics anywhere, so
//     two runs on the same inputs give the same bits. A network's
//     gradients are 4L + 3 ops (net_grad_op), staged kGradBatch at a time;
//     their items are dealt to the blocks as one list would be.
//   * A clipped update (B7's global-norm clip) needs the norm of every
//     gradient before any Adam step: its gradient stage only stores each
//     element into a flat buffer in the group layout (run_net_grads<true>),
//     a norm stage sums fixed slices of it as squares into one partial
//     each (norm_partials; the slices do not depend on the grid), and an
//     elementwise stage sums the partials in the same order in every
//     block, scales and applies Adam and Polyak (adam_flat).
// Parameters, targets and moments are read and written in place in their
// group buffers (ops/learner_kernel.py documents the layout). The depth
// and the widths are data: a device int32 table made once per shape
// (ops/learner_kernel.py::_learner_table) holds the widths, their prefix
// sums (where a layer's rows sit in a per-layer region of the workspace)
// and every network's parameter offsets, so a kernel takes any depth; a
// block copies it into shared memory at the start of a launch. The library
// is built with --fmad=false; the matrix-product and batch-sum inner loops
// use explicit fmaf(), every elementwise formula follows the plain twins
// operation by operation.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#ifdef CP_STAGE_CLOCK
// A separate build that measures how a kernel's time splits (chip_smoke.py's
// stage split; the library the wrappers load never defines this): thread 0
// of every block records clock64() when the kernel starts and when every
// grid barrier is reached and left (cg::grid_group below stands in for
// cooperative_groups' own), when a row or gradient stage's items start,
// after the lead thread has written the stage's ops (CP_MARK_ITEMS), and
// where a kernel marks the end of one of its phases (CP_MARK(id), id 3 to
// 15, right after a block barrier; a kernel without a grid barrier marks
// its start with CP_MARK_START). One kernel source per library: the
// buffers and the readers are defined here.
namespace cp_clock {
constexpr int kBlocks = 512, kMarks = 2048;
enum : int { kRelease = 0, kItems = 1, kArrive = 2 };
static __device__ long long marks[kBlocks * kMarks];
static __device__ int counts[kBlocks];

// The block's count of marks, in shared memory (set by start()).
__device__ __forceinline__ int& count() {
  __shared__ int n;
  return n;
}

// Mark (clock << 4 | kind) for this block, by thread 0: a shared-memory
// count and two stores, nothing that waits on device memory.
__device__ __forceinline__ void mark(int kind) {
  if (threadIdx.x != 0 || blockIdx.x >= kBlocks) return;
  const int n = count();
  if (n >= kMarks) return;
  marks[blockIdx.x * kMarks + n] = (clock64() << 4) | kind;
  counts[blockIdx.x] = n + 1;
  count() = n + 1;
}

// The kernel's start: the count reset, and a first mark.
__device__ __forceinline__ void start() {
  if (threadIdx.x == 0) count() = 0;
  mark(kRelease);
}

struct grid_group {
  cooperative_groups::grid_group g;
  __device__ void sync() {
    __syncthreads();
    mark(kArrive);
    g.sync();
    mark(kRelease);
  }
};

__device__ inline grid_group this_grid() {
  start();
  return grid_group{cooperative_groups::this_grid()};
}
}  // namespace cp_clock
namespace cg = cp_clock;
#define CP_MARK_ITEMS() cp_clock::mark(cp_clock::kItems)
#define CP_MARK(id) cp_clock::mark(id)
#define CP_MARK_START() cp_clock::start()

// The marks of the last launch: counts (kBlocks ints) and marks (kBlocks x
// kMarks, block-major); reset zeroes the counts. Return a cudaError_t.
extern "C" int cp_stage_clock_read(long long* marks, int* counts) {
  cudaError_t err = cudaMemcpyFromSymbol(counts, cp_clock::counts,
                                         sizeof(cp_clock::counts));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(marks, cp_clock::marks,
                               sizeof(cp_clock::marks));
  return static_cast<int>(err);
}
extern "C" int cp_stage_clock_reset() {
  static const int zeros[cp_clock::kBlocks] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(cp_clock::counts, zeros, sizeof(zeros)));
}
#else
namespace cg = cooperative_groups;
#define CP_MARK_ITEMS()
#define CP_MARK(id)
#define CP_MARK_START()
#endif

// Mirror of ops/_native.py::NetLayout: element offsets of one network's
// parameters in its group buffer. lay (device): per torso layer l,
// lay[4 l .. 4 l + 3] = the offsets of W_l, b_l, LayerNorm scale_l and
// LayerNorm bias_l; wh, bh: the head's W and b; size: the group's floats.
struct NetLayout {
  const int* lay;
  int wh, bh, size;
  __device__ int w(int l) const { return lay[4 * l]; }
  __device__ int b(int l) const { return lay[4 * l + 1]; }
  __device__ int s(int l) const { return lay[4 * l + 2]; }
  __device__ int t(int l) const { return lay[4 * l + 3]; }
};

// Mirror of ops/_native.py::Torso: the torso's depth L and its widths on
// the device, tab[l] = H_l and tab[L + l] = H_0 + ... + H_{l-1} (layer l's
// offset, in rows of the batch, in a per-layer region of the workspace).
struct Torso {
  const int* tab;
  int L;
  __device__ int h(int l) const { return tab[l]; }
  __device__ int at(int l) const { return tab[L + l]; }
};

// Mirror of ops/_native.py::LearnerConsts: the float32 constants, folded
// on the host (ops/learner_kernel.py::_learner_consts). B5's single net is
// net 0 and takes actor_lr.
struct LearnerConsts {
  float gamma, tau, inv_batch, two_inv_batch, neg_inv_batch, b1, omb1, b2,
      omb2, eps, log_b1, log_b2, ln_eps, actor_lr, critic_lr, sched_steps,
      actor_lr_delta, critic_lr_delta;
  int sched;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTR = 16;                 // batch rows per row-stage item
constexpr int kRPT = kTR / kWarps;      // rows per thread
constexpr int kTC = 32;                 // output columns per row-stage item
constexpr int kTG = 32;                 // gradient tile edge
constexpr int kKc = 1024;               // input features per row-stage chunk
constexpr int kMaxRowOps = 3;
constexpr int kGradBatch = 32;          // gradient ops staged at a time
constexpr int kNormParts = 256;         // slices of a flat gradient

enum : int { kProPlain = 0, kProLnRelu = 1, kProLnBwd = 2 };
enum : int { kEpiNone = 0, kEpiTanh = 1, kEpiTd = 2, kEpiConst = 3,
             kEpiTanhBwd = 4 };
enum : int { kGradW = 0, kGradV = 1, kGradLoss = 2 };

// One matrix product of a row stage. FWD: y[b, c] = sum_i h[b, i]
// w[c * in_w + i] + bias[c] over the kx features of h (+ the na appended
// columns, summed apart: the critic's split action product). BWD: y[b, c] =
// sum_j h[b, j] w[j * in_w + col0 + c] over the kx rows of w.
struct RowOp {
  int pro, kx, na, bwd, in_w, col0, n_out, epi;
  const float* x;    // (B, kx): activations, pre-LN z, or upstream grads
  const float* z;    // kProLnBwd: the layer's pre-LN z (B, kx)
  const float* s;    // LayerNorm scale (kx)
  const float* t;    // LayerNorm bias (kx)
  const float* xa;   // (B, na) appended columns
  float* save_h;     // optional: the layer input rows (B, kx + na)
  float *save_dz, *save_dy, *save_dyxh;   // optional (kProLnBwd)
  const float* w;
  const float* bias;
  float* y;          // (B, n_out)
  const float *e0, *e1;
  const bool* edone;
  float *eout0, *eout1;
};

// One gradient of a gradient stage, reduced over the batch and applied
// with Adam (and Polyak) in place. W: g (B, out), x (B, in) -> dW (out,
// in). V: sum over b of g (B, out). Loss: scale * sum over b of g (or g^2).
struct GradOp {
  int kind, net, out, in, off, sq;
  const float* g;
  const float* x;
  float scale;
  float* dst;
};

struct NetPtr {
  float *p, *tgt, *m, *v;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// --- row stages ------------------------------------------------------------

__device__ __forceinline__ int row_items(const RowOp& op, int B) {
  return cdiv(B, kTR) * max(1, cdiv(op.n_out, kTC));
}

// LayerNorm statistics of one row (one-pass variance, as the twin).
__device__ __forceinline__ void ln_stats(const float* row, int n, float eps,
                                         int lane, float& mu, float& inv) {
  float s1 = 0.0f, s2 = 0.0f;
  for (int i = lane; i < n; i += 32) {
    const float v = row[i];
    s1 = s1 + v;
    s2 = s2 + v * v;
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  mu = s1 / static_cast<float>(n);
  const float var = s2 / static_cast<float>(n) - mu * mu;
  inv = 1.0f / sqrtf(var + eps);
}

// One (row tile rt, column tile ct) item of a row stage. Hs: the chunk of
// the tile's input rows (kTR x ldh), Ws: the chunk's rows of the weight
// tile (ldh x 33); ldh >= min(K, kKc).
__device__ void row_item(const RowOp& op, int rt, int ct, int B,
                         const LearnerConsts& c, float* Hs, int ldh,
                         float* Ws) {
  const int r0 = rt * kTR, c0 = ct * kTC;
  const int K = op.bwd ? op.kx : op.kx + op.na;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool first_col = ct == 0;

  // The rows k0 .. k0 + kc of this item's 32 weight columns -> Ws[i][cc],
  // zero past n_out.
  auto stage_weights = [&](int k0, int kc) {
    if (op.n_out <= 0) return;
    for (int idx = tid; idx < kTC * kc; idx += kThreads) {
      int i, cc;
      float v = 0.0f;
      if (op.bwd) {
        i = idx / kTC;
        cc = idx - i * kTC;
        if (c0 + cc < op.n_out)
          v = op.w[static_cast<size_t>(k0 + i) * op.in_w + op.col0 + c0 + cc];
      } else {
        cc = idx / kc;
        i = idx - cc * kc;
        if (c0 + cc < op.n_out)
          v = op.w[static_cast<size_t>(c0 + cc) * op.in_w + k0 + i];
      }
      Ws[i * (kTC + 1) + cc] = v;
    }
  };
  // The first chunk's weights go out before the statistics' row reads,
  // so that the two streams of loads overlap.
  stage_weights(0, min(kKc, K));

  // Row statistics over the whole input row; warp w holds rows w and
  // w + 8 (q = 0, 1) in registers for every chunk.
  float mu[kRPT], inv[kRPT], m1[kRPT], m2[kRPT];
#pragma unroll
  for (int q = 0; q < kRPT; ++q) {
    mu[q] = inv[q] = m1[q] = m2[q] = 0.0f;
    const int b = r0 + warp + q * kWarps;
    if (op.pro == kProPlain || b >= B) continue;
    const size_t rowoff = static_cast<size_t>(b) * op.kx;
    if (op.pro == kProLnRelu) {
      ln_stats(op.x + rowoff, op.kx, c.ln_eps, lane, mu[q], inv[q]);
      continue;
    }
    // kProLnBwd: x is dh, the gradient at the relu output
    const float* zrow = op.z + rowoff;
    const float* xrow = op.x + rowoff;
    ln_stats(zrow, op.kx, c.ln_eps, lane, mu[q], inv[q]);
    float a1 = 0.0f, a2 = 0.0f;
    for (int i = lane; i < op.kx; i += 32) {
      const float xh = (zrow[i] - mu[q]) * inv[q];
      const float y = xh * op.s[i] + op.t[i];
      const float dy = y > 0.0f ? xrow[i] : 0.0f;
      const float dxh = dy * op.s[i];
      a1 = a1 + dxh;
      a2 = a2 + dxh * xh;
    }
    a1 = warp_sum(a1);
    a2 = warp_sum(a2);
    m1[q] = a1 / static_cast<float>(op.kx);
    m2[q] = a2 / static_cast<float>(op.kx);
  }

  float acc[kRPT], acc2[kRPT];
#pragma unroll
  for (int q = 0; q < kRPT; ++q) acc[q] = acc2[q] = 0.0f;
  const bool save_d = first_col && op.save_dz != nullptr;
  for (int k0 = 0; k0 < K; k0 += kKc) {
    const int kc = min(kKc, K - k0);
    if (k0 > 0) {
      __syncthreads();  // the last chunk's products are done
      stage_weights(k0, kc);
    }

    // Prologue: the chunk of the tile's input rows -> Hs, one warp per
    // row.
#pragma unroll
    for (int q = 0; q < kRPT; ++q) {
      const int r = warp + q * kWarps;
      const int b = r0 + r;
      float* hrow = Hs + r * ldh;
      if (b >= B) {
        for (int i = lane; i < kc; i += 32) hrow[i] = 0.0f;
        continue;
      }
      const size_t rowoff = static_cast<size_t>(b) * op.kx;
      const float* xrow = op.x + rowoff;
      const int kend = min(kc, op.kx - k0);  // features of x in the chunk
      if (op.pro == kProPlain) {
        for (int i = lane; i < kend; i += 32) hrow[i] = xrow[k0 + i];
      } else if (op.pro == kProLnRelu) {
        for (int i = lane; i < kend; i += 32) {
          const int gi = k0 + i;
          const float xh = (xrow[gi] - mu[q]) * inv[q];
          const float y = xh * op.s[gi] + op.t[gi];
          hrow[i] = fmaxf(y, 0.0f);
        }
      } else {  // kProLnBwd
        const float* zrow = op.z + rowoff;
        for (int i = lane; i < kend; i += 32) {
          const int gi = k0 + i;
          const float xh = (zrow[gi] - mu[q]) * inv[q];
          const float y = xh * op.s[gi] + op.t[gi];
          const float dy = y > 0.0f ? xrow[gi] : 0.0f;
          const float dxh = dy * op.s[gi];
          const float dz = inv[q] * (dxh - m1[q] - xh * m2[q]);
          hrow[i] = dz;
          if (save_d) {
            op.save_dz[rowoff + gi] = dz;
            op.save_dy[rowoff + gi] = dy;
            op.save_dyxh[rowoff + gi] = dy * xh;
          }
        }
      }
      // The appended columns (features kx .. kx + na) in the chunk.
      for (int i = max(kend, 0) + lane; i < kc; i += 32)
        hrow[i] = op.xa[static_cast<size_t>(b) * op.na + k0 + i - op.kx];
      if (first_col && op.save_h != nullptr) {
        __syncwarp();
        for (int i = lane; i < kc; i += 32)
          op.save_h[static_cast<size_t>(b) * K + k0 + i] = hrow[i];
      }
    }
    __syncthreads();

    if (op.n_out > 0) {
      const float* hr = Hs + (warp * kRPT) * ldh;
      const int kend = max(min(kc, op.kx - k0), 0);
      for (int i = 0; i < kend; ++i) {
        const float wv = Ws[i * (kTC + 1) + lane];
#pragma unroll
        for (int q = 0; q < kRPT; ++q)
          acc[q] = fmaf(hr[q * ldh + i], wv, acc[q]);
      }
      for (int i = kend; i < kc; ++i) {
        const float wv = Ws[i * (kTC + 1) + lane];
#pragma unroll
        for (int q = 0; q < kRPT; ++q)
          acc2[q] = fmaf(hr[q * ldh + i], wv, acc2[q]);
      }
    }
  }

  if (op.n_out > 0) {
    const int col = c0 + lane;
    if (col < op.n_out) {
#pragma unroll
      for (int q = 0; q < kRPT; ++q) {
        const int b = r0 + warp * kRPT + q;
        if (b >= B) continue;
        float v = acc[q];
        if (K > op.kx) v = v + acc2[q];
        if (op.bias != nullptr) v = v + op.bias[col];
        const size_t o = static_cast<size_t>(b) * op.n_out + col;
        switch (op.epi) {
          case kEpiTanh:
            op.y[o] = tanhf(v);
            break;
          case kEpiTd: {  // v is Q'(s', a'); n_out == 1
            op.y[o] = v;
            const float notdone = 1.0f - (op.edone[b] ? 1.0f : 0.0f);
            const float target = op.e1[b] + (c.gamma * notdone) * v;
            const float td = op.e0[b] - target;
            op.eout0[b] = td;
            op.eout1[b] = c.two_inv_batch * td;
            break;
          }
          case kEpiConst:  // v is Q(s, pi(s)); d loss / dQ = -1/B
            op.y[o] = v;
            op.eout1[b] = c.neg_inv_batch;
            break;
          case kEpiTanhBwd: {  // v is d loss / da; through the tanh head
            const float a = op.e0[o];
            op.y[o] = v * (1.0f - a * a);
            break;
          }
          default:
            op.y[o] = v;
        }
      }
    }
  }
  __syncthreads();
}

// Not inlined: the kernels call it from every stage, and one shared copy
// of the row engine keeps each stage's code warm in the instruction cache
// (inlined at ~20 call sites, B3's code doubled in size).
__device__ __noinline__ void run_rows(const RowOp* ops, int n, int B,
                                      const LearnerConsts& c, float* smem,
                                      int ldh) {
  CP_MARK_ITEMS();
  float* Hs = smem;
  float* Ws = smem + kTR * ldh;
  int total = 0;
  for (int o = 0; o < n; ++o) total += row_items(ops[o], B);
  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    int o = 0, rest = item;
    while (rest >= row_items(ops[o], B)) rest -= row_items(ops[o++], B);
    const int cols = max(1, cdiv(ops[o].n_out, kTC));
    row_item(ops[o], rest / cols, rest % cols, B, c, Hs, ldh, Ws);
  }
}

// --- gradient stages ---------------------------------------------------------

__device__ __forceinline__ int grad_items(const GradOp& op) {
  if (op.kind == kGradW) return cdiv(op.out, kTG) * cdiv(op.in, kTG);
  if (op.kind == kGradV) return cdiv(op.out, 32);
  return 1;
}

struct AdamStep {
  float bc1, bc2, lr[2];   // lr per net: 0 actor, 1 critic
};

__device__ __forceinline__ void adam_elem(const NetPtr& n, int off, float g,
                                          float bc1, float bc2, float lr,
                                          const LearnerConsts& c) {
  const float m = c.b1 * n.m[off] + c.omb1 * g;
  const float v = c.b2 * n.v[off] + c.omb2 * (g * g);
  const float p = n.p[off] - lr * (m / bc1) / (sqrtf(v / bc2) + c.eps);
  n.m[off] = m;
  n.v[off] = v;
  n.p[off] = p;
  const float t = n.tgt[off];
  n.tgt[off] = t + c.tau * (p - t);
}

// kStore: write each reduced element into gstore (at its offset in the
// group layout) instead of applying Adam and Polyak to it.
template <bool kStore = false>
__device__ void grad_item(const GradOp& op, int item, int B,
                          const NetPtr* nets, const AdamStep& as,
                          const LearnerConsts& c, float* sm,
                          float* gstore = nullptr) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const NetPtr& net = nets[op.net];
  const float lr = as.lr[op.net];
  if (op.kind == kGradW) {
    constexpr int kJ = kTG / kWarps;   // output rows per thread
    const int it_n = cdiv(op.in, kTG);
    const int j0 = (item / it_n) * kTG, i0 = (item % it_n) * kTG;
    float* Gs = sm;                    // [bb][jj]
    float* Xs = sm + kTG * (kTG + 1);  // [bb][ii]
    float acc[kJ];
#pragma unroll
    for (int q = 0; q < kJ; ++q) acc[q] = 0.0f;
    for (int b0 = 0; b0 < B; b0 += kTG) {
      for (int idx = tid; idx < kTG * kTG; idx += kThreads) {
        const int bb = idx / kTG, e = idx - bb * kTG, b = b0 + bb;
        const bool in_b = b < B;
        Gs[bb * (kTG + 1) + e] =
            (in_b && j0 + e < op.out)
                ? op.g[static_cast<size_t>(b) * op.out + j0 + e] : 0.0f;
        Xs[bb * (kTG + 1) + e] =
            (in_b && i0 + e < op.in)
                ? op.x[static_cast<size_t>(b) * op.in + i0 + e] : 0.0f;
      }
      __syncthreads();
      for (int bb = 0; bb < kTG; ++bb) {
        const float xv = Xs[bb * (kTG + 1) + lane];
#pragma unroll
        for (int q = 0; q < kJ; ++q)
          acc[q] = fmaf(Gs[bb * (kTG + 1) + warp * kJ + q], xv, acc[q]);
      }
      __syncthreads();
    }
    const int i = i0 + lane;
#pragma unroll
    for (int q = 0; q < kJ; ++q) {
      const int j = j0 + warp * kJ + q;
      if (j < op.out && i < op.in) {
        if constexpr (kStore)
          gstore[op.off + j * op.in + i] = acc[q];
        else
          adam_elem(net, op.off + j * op.in + i, acc[q], as.bc1, as.bc2, lr,
                    c);
      }
    }
  } else if (op.kind == kGradV) {
    const int e = item * 32 + lane;
    const int slice = cdiv(B, kWarps);
    const int b_end = min(B, (warp + 1) * slice);
    float s = 0.0f;
    if (e < op.out) {
      for (int b = warp * slice; b < b_end; ++b)
        s = s + op.g[static_cast<size_t>(b) * op.out + e];
    }
    sm[warp * 32 + lane] = s;
    __syncthreads();
    if (warp == 0 && e < op.out) {
      float g = 0.0f;
      for (int w = 0; w < kWarps; ++w) g = g + sm[w * 32 + lane];
      if constexpr (kStore)
        gstore[op.off + e] = g;
      else
        adam_elem(net, op.off + e, g, as.bc1, as.bc2, lr, c);
    }
    __syncthreads();
  } else {  // kGradLoss
    float s = 0.0f;
    for (int b = tid; b < B; b += kThreads) {
      const float v = op.g[b];
      s = s + (op.sq ? v * v : v);
    }
    sm[tid] = s;
    __syncthreads();
    if (tid == 0) {
      float total = 0.0f;
      for (int i = 0; i < kThreads; ++i) total = total + sm[i];
      *op.dst = op.scale * total;
    }
    __syncthreads();
  }
}

// --- flat-gradient stages (a global-norm clip) ---------------------------------

// parts[i] = the sum of squares of slice i of g[0, n), one block per slice:
// each thread sums a strided share, thread 0 the block's shares in order.
__device__ void norm_partials(const float* g, int n, float* parts,
                              float* sm) {
  const int len = cdiv(n, kNormParts);
  for (int part = blockIdx.x; part < kNormParts; part += gridDim.x) {
    const int lo = part * len, hi = min(n, lo + len);
    float s = 0.0f;
    for (int e = lo + threadIdx.x; e < hi; e += kThreads) {
      const float v = g[e];
      s = s + v * v;
    }
    sm[threadIdx.x] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.0f;
      for (int i = 0; i < kThreads; ++i) total = total + sm[i];
      parts[part] = total;
    }
    __syncthreads();
  }
}

// optax.clip_by_global_norm then Adam and Polyak on every element of the
// flat gradient g[0, n) of `net`: the norm is the square root of the
// partials summed in order (the same bits in every block), the scale 1
// below max_norm and max_norm / norm at or above it.
__device__ void adam_flat(const float* g, int n, const float* parts,
                          float max_norm, const NetPtr& net,
                          const AdamStep& as, float lr,
                          const LearnerConsts& c, float* sm) {
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int i = 0; i < kNormParts; ++i) total = total + parts[i];
    const float norm = sqrtf(total);
    sm[0] = norm < max_norm ? 1.0f : max_norm / norm;
  }
  __syncthreads();
  const float scale = sm[0];
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < n;
       e += gridDim.x * kThreads)
    adam_elem(net, e, g[e] * scale, as.bc1, as.bc2, lr, c);
}

// --- stage ops (written by thread 0 of each block) ----------------------------

__device__ RowOp fwd_op(const float* x, int kx, int pro, const float* s,
                        const float* t, const float* xa, int na,
                        const float* w, const float* bias, int n_out,
                        float* y, float* save_h, int epi) {
  RowOp op = {};
  op.pro = pro;
  op.kx = kx;
  op.na = na;
  op.bwd = 0;
  op.in_w = kx + na;
  op.n_out = n_out;
  op.epi = epi;
  op.x = x;
  op.s = s;
  op.t = t;
  op.xa = xa;
  op.save_h = save_h;
  op.w = w;
  op.bias = bias;
  op.y = y;
  return op;
}

__device__ RowOp bwd_op(const float* dh, const float* z, int kx,
                        const float* s, const float* t, float* sdz,
                        float* sdy, float* sdyxh, const float* w, int in_w,
                        int col0, int n_out, float* y) {
  RowOp op = {};
  op.pro = z != nullptr ? kProLnBwd : kProPlain;
  op.kx = kx;
  op.bwd = 1;
  op.in_w = in_w;
  op.col0 = col0;
  op.n_out = n_out;
  op.epi = kEpiNone;
  op.x = dh;
  op.z = z;
  op.s = s;
  op.t = t;
  op.save_dz = sdz;
  op.save_dy = sdy;
  op.save_dyxh = sdyxh;
  op.w = w;
  op.y = y;
  return op;
}

__device__ GradOp grad_op(int kind, int net, const float* g, int out,
                          const float* x, int in, int off) {
  GradOp op = {};
  op.kind = kind;
  op.net = net;
  op.g = g;
  op.out = out;
  op.x = x;
  op.in = in;
  op.off = off;
  return op;
}

// The gradients of one network: its 4L + 3 ops (net_grad_op) read the
// per-layer rows of dz, dy and dy * xhat, the layer inputs (x0 at layer
// 0, then `hin`, a region of (batch, H_{l-1} + (l == 1 ? join : 0))
// pieces: the critic's action joins at layer 1), the head's upstream
// gradient (batch, n_head) and the last layer's activations, and the loss
// rows (summed, or squared when sq, times scale into *dst).
struct NetGrads {
  int net, join, n_head, sq;
  float scale;
  float* dst;
  const float *x0, *dz, *dy, *dyxh, *hin, *dhead, *hlast, *loss;
  NetLayout lay;
};

// Layer l's rows in a per-layer region of (batch, H_l) pieces.
template <typename P>
__device__ __forceinline__ P* layer_rows(P* base, const Torso& T, int l,
                                         int B) {
  return base + static_cast<size_t>(B) * T.at(l);
}

// Layer l's input rows (l >= 1) in a region of (batch, H_{l-1} + (l == 1 ?
// join : 0)) pieces.
template <typename P>
__device__ __forceinline__ P* input_rows(P* base, const Torso& T, int l,
                                         int join, int B) {
  return base + static_cast<size_t>(B) * (T.at(l - 1) + (l >= 2 ? join : 0));
}

// Op i of a network's gradient list: per torso layer l, W_l, b_l,
// LayerNorm scale_l and bias_l; then the head's W and b; then the loss.
__device__ GradOp net_grad_op(const NetGrads& g, int i, const Torso& T,
                              int F, int B) {
  const int L = T.L;
  if (i < 4 * L) {
    const int l = i / 4, h = T.h(l);
    const float* rows =
        layer_rows(i % 4 == 2 ? g.dyxh : i % 4 == 3 ? g.dy : g.dz, T, l, B);
    switch (i % 4) {
      case 0: {
        const int in = l == 0 ? F : T.h(l - 1) + (l == 1 ? g.join : 0);
        const float* x = l == 0 ? g.x0 : input_rows(g.hin, T, l, g.join, B);
        return grad_op(kGradW, g.net, rows, h, x, in, g.lay.w(l));
      }
      case 1:
        return grad_op(kGradV, g.net, rows, h, nullptr, 0, g.lay.b(l));
      case 2:
        return grad_op(kGradV, g.net, rows, h, nullptr, 0, g.lay.s(l));
      default:
        return grad_op(kGradV, g.net, rows, h, nullptr, 0, g.lay.t(l));
    }
  }
  if (i == 4 * L)
    return grad_op(kGradW, g.net, g.dhead, g.n_head, g.hlast, T.h(L - 1),
                   g.lay.wh);
  if (i == 4 * L + 1)
    return grad_op(kGradV, g.net, g.dhead, g.n_head, nullptr, 0, g.lay.bh);
  GradOp loss = grad_op(kGradLoss, g.net, g.loss, 1, nullptr, 0, 0);
  loss.sq = g.sq;
  loss.scale = g.scale;
  loss.dst = g.dst;
  return loss;
}

// A block's stage lists, written by its lead thread: a row stage's ops,
// and a gradient stage's networks and the batch of ops being staged.
struct Shared {
  RowOp rows[kMaxRowOps];
  GradOp grads[kGradBatch];
  NetGrads nets[2];
  int n_rows, n_nets;
};

// One gradient stage over the sh.n_nets networks' gradients (4L + 3 ops
// each), each
// element reduced and given to Adam and Polyak (kStore: stored into
// gstore). The lead thread stages kGradBatch ops at a time; the items are
// numbered across the whole list and dealt to the blocks round-robin, as
// one list would deal them. Every element has its own sum, so the staging
// changes no bits.
template <bool kStore = false>
__device__ __noinline__ void run_net_grads(Shared& sh, const Torso& T, int F,
                                           int B, const NetPtr* ptrs,
                                           const AdamStep& as,
                                           const LearnerConsts& c,
                                           float* smem,
                                           float* gstore = nullptr) {
  __syncthreads();  // the lead thread's sh.nets
  CP_MARK_ITEMS();
  const int per = 4 * T.L + 3, n_ops = sh.n_nets * per;
  const int G = gridDim.x;
  int base = 0;  // list-wide number of the batch's first item
  for (int o0 = 0; o0 < n_ops; o0 += kGradBatch) {
    const int nb = min(kGradBatch, n_ops - o0);
    __syncthreads();  // the last batch's ops are no longer read
    if (threadIdx.x == 0)
      for (int o = 0; o < nb; ++o)
        sh.grads[o] = net_grad_op(sh.nets[(o0 + o) / per], (o0 + o) % per,
                                  T, F, B);
    __syncthreads();
    int total = 0;
    for (int o = 0; o < nb; ++o) total += grad_items(sh.grads[o]);
    for (int item = (static_cast<int>(blockIdx.x) - base % G + G) % G;
         item < total; item += G) {
      int o = 0, rest = item;
      while (rest >= grad_items(sh.grads[o]))
        rest -= grad_items(sh.grads[o++]);
      grad_item<kStore>(sh.grads[o], rest, B, ptrs, as, c, smem, gstore);
    }
    base += total;
  }
}

// The row stride of a row stage's input rows for layer inputs up to kmax
// features wide: one chunk.
inline int row_ld(int kmax) { return kmax < kKc ? kmax : kKc; }

// Floats of a block's stage region: a row stage's input rows and weight
// tile (one chunk of ldh features), or a gradient stage's two 32 x 32
// tiles, whichever is larger. The shared copy of the device table
// follows it.
__host__ __device__ inline int region_floats(int ldh) {
  const int rows = kTR * ldh + ldh * (kTC + 1);
  const int grads = 2 * kTG * (kTG + 1);
  return rows > grads ? rows : grads;
}

// Shared memory of one block: the stage region and the table's n_tab ints.
size_t smem_bytes(int ldh, int n_tab) {
  return sizeof(float) * static_cast<size_t>(region_floats(ldh) + n_tab);
}

// The device table (n ints from t.tab, which every NetLayout points into)
// copied into shared memory after the stage region, so that the lead
// thread reads widths and offsets there when it writes a stage's ops;
// returns the torso pointing at the copy. Ends with a barrier.
__device__ Torso stage_table(const Torso& t, int n, int* dst) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = t.tab[i];
  __syncthreads();
  return Torso{dst, t.L};
}

// A network's layout moved onto the shared copy of its table.
__device__ NetLayout layout_on(const NetLayout& n, const Torso& from,
                               const Torso& to) {
  NetLayout m = n;
  m.lay = to.tab + (n.lay - from.tab);
  return m;
}

// The host's copy of the torso's widths: true when there are at least
// min_layers of them, each >= 1; *sum, *widest (when not null) get their
// sum and max(first, widths...).
inline bool widths_ok(const int* widths, int L, int min_layers,
                      long long* sum, int* widest, int first) {
  if (widths == nullptr || L < min_layers) return false;
  long long s = 0;
  int m = first;
  for (int l = 0; l < L; ++l) {
    if (widths[l] < 1) return false;
    s += widths[l];
    m = widths[l] > m ? widths[l] : m;
  }
  if (sum != nullptr) *sum = s;
  if (widest != nullptr) *widest = m;
  return true;
}

// Launches `kernel` cooperatively on `stream` with as many blocks as fit,
// up to 2 per SM, at `smem` bytes of dynamic shared memory; the count is
// cached in `blocks`/`blocks_smem` across calls.
inline cudaError_t launch_cooperative(const void* kernel, size_t smem,
                                      void** args, cudaStream_t stream,
                                      int& blocks, size_t& blocks_smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (blocks == 0 || blocks_smem != smem) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, smem)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    blocks = sms * (per_sm < 2 ? per_sm : 2);
    blocks_smem = smem;
  }
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
