// The stage engine of the cooperative learner kernels B3 (ddpg_update.cu),
// B5 (dqn_update.cu) and B7 (naf_update.cu): one persistent launch per
// K-update phase in which every block walks the same list of stages,
// separated by cg::this_grid().sync().
//   * Row stages: the batch is cut into 16-row tiles and each layer's
//     outputs into 32-column tiles; a block takes (row tile, column tile)
//     items. It rebuilds its rows' layer input in shared memory (copy,
//     LayerNorm + relu of the previous pre-LN z, or the LayerNorm backward
//     from the upstream gradient and the saved z), then multiplies it by
//     a 32-column tile of the weight, also staged in shared memory. The
//     matrix products are computed here, thread by thread (one column and
//     two rows each); no library GEMM is called. Up to kMaxRowOps
//     independent products share one stage.
//   * Gradient stages: every element of a gradient is one thread's sum
//     over the batch in a fixed order (32 x 32 weight tiles through shared
//     memory; 8 fixed row slices for the vectors), then Adam and Polyak
//     on that element in the same thread. No float atomics anywhere, so
//     two runs on the same inputs give the same bits.
//   * A clipped update (B7's global-norm clip) needs the norm of every
//     gradient before any Adam step: its gradient stage only stores each
//     element into a flat buffer in the group layout (run_grads<true>),
//     a norm stage sums fixed slices of it as squares into one partial
//     each (norm_partials; the slices do not depend on the grid), and an
//     elementwise stage sums the partials in the same order in every
//     block, scales and applies Adam and Polyak (adam_flat).
// Parameters, targets and moments are read and written in place in their
// group buffers (ops/learner_kernel.py documents the layout). The library
// is built with --fmad=false; the matrix-product and batch-sum inner loops
// use explicit fmaf(), every elementwise formula follows the plain twins
// operation by operation.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace cg = cooperative_groups;

constexpr int kMaxLayers = 4;   // ops/_native.py::MAX_LAYERS

// Mirror of ops/_native.py::NetLayout: element offsets of one network's
// parameters in its group buffer.
struct NetLayout {
  int w[kMaxLayers], b[kMaxLayers], s[kMaxLayers], t[kMaxLayers];
  int wh, bh, size;
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
constexpr int kMaxWidth = 1024;         // ops/learner_kernel.py::MAX_WIDTH
constexpr int kMaxRowOps = 3;
constexpr int kMaxGradOps = 2 * (4 * kMaxLayers + 3);
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

__device__ void row_item(const RowOp& op, int rt, int ct, int B,
                         const LearnerConsts& c, float* Hs, int ldh,
                         float* Ws) {
  const int r0 = rt * kTR, c0 = ct * kTC;
  const int K = op.bwd ? op.kx : op.kx + op.na;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // This item's 32 weight columns -> Ws[i][cc], zero past n_out.
  if (op.n_out > 0) {
    for (int idx = tid; idx < kTC * K; idx += kThreads) {
      int i, cc;
      float v = 0.0f;
      if (op.bwd) {
        i = idx / kTC;
        cc = idx - i * kTC;
        if (c0 + cc < op.n_out)
          v = op.w[static_cast<size_t>(i) * op.in_w + op.col0 + c0 + cc];
      } else {
        cc = idx / K;
        i = idx - cc * K;
        if (c0 + cc < op.n_out)
          v = op.w[static_cast<size_t>(c0 + cc) * op.in_w + i];
      }
      Ws[i * (kTC + 1) + cc] = v;
    }
  }

  // Prologue: the tile's input rows -> Hs, one warp per row.
  const bool first_col = ct == 0;
  for (int r = warp; r < kTR; r += kWarps) {
    const int b = r0 + r;
    float* hrow = Hs + r * ldh;
    if (b >= B) {
      for (int i = lane; i < K; i += 32) hrow[i] = 0.0f;
      continue;
    }
    const size_t rowoff = static_cast<size_t>(b) * op.kx;
    const float* xrow = op.x + rowoff;
    if (op.pro == kProPlain) {
      for (int i = lane; i < op.kx; i += 32) hrow[i] = xrow[i];
    } else if (op.pro == kProLnRelu) {
      float mu, inv;
      ln_stats(xrow, op.kx, c.ln_eps, lane, mu, inv);
      for (int i = lane; i < op.kx; i += 32) {
        const float xh = (xrow[i] - mu) * inv;
        const float y = xh * op.s[i] + op.t[i];
        hrow[i] = fmaxf(y, 0.0f);
      }
    } else {  // kProLnBwd: x is dh, the gradient at the relu output
      const float* zrow = op.z + rowoff;
      float mu, inv;
      ln_stats(zrow, op.kx, c.ln_eps, lane, mu, inv);
      float a1 = 0.0f, a2 = 0.0f;
      for (int i = lane; i < op.kx; i += 32) {
        const float xh = (zrow[i] - mu) * inv;
        const float y = xh * op.s[i] + op.t[i];
        const float dy = y > 0.0f ? xrow[i] : 0.0f;
        const float dxh = dy * op.s[i];
        a1 = a1 + dxh;
        a2 = a2 + dxh * xh;
      }
      a1 = warp_sum(a1);
      a2 = warp_sum(a2);
      const float m1 = a1 / static_cast<float>(op.kx);
      const float m2 = a2 / static_cast<float>(op.kx);
      const bool save = first_col && op.save_dz != nullptr;
      for (int i = lane; i < op.kx; i += 32) {
        const float xh = (zrow[i] - mu) * inv;
        const float y = xh * op.s[i] + op.t[i];
        const float dy = y > 0.0f ? xrow[i] : 0.0f;
        const float dxh = dy * op.s[i];
        const float dz = inv * (dxh - m1 - xh * m2);
        hrow[i] = dz;
        if (save) {
          op.save_dz[rowoff + i] = dz;
          op.save_dy[rowoff + i] = dy;
          op.save_dyxh[rowoff + i] = dy * xh;
        }
      }
    }
    if (op.na > 0) {
      for (int i = lane; i < op.na; i += 32)
        hrow[op.kx + i] = op.xa[static_cast<size_t>(b) * op.na + i];
    }
    if (first_col && op.save_h != nullptr) {
      __syncwarp();
      for (int i = lane; i < K; i += 32)
        op.save_h[static_cast<size_t>(b) * K + i] = hrow[i];
    }
  }
  __syncthreads();

  if (op.n_out > 0) {
    const int col = c0 + lane;
    const float* hr = Hs + (warp * kRPT) * ldh;
    float acc[kRPT], acc2[kRPT];
#pragma unroll
    for (int q = 0; q < kRPT; ++q) acc[q] = acc2[q] = 0.0f;
    for (int i = 0; i < op.kx; ++i) {
      const float wv = Ws[i * (kTC + 1) + lane];
#pragma unroll
      for (int q = 0; q < kRPT; ++q) acc[q] = fmaf(hr[q * ldh + i], wv, acc[q]);
    }
    for (int i = op.kx; i < K; ++i) {
      const float wv = Ws[i * (kTC + 1) + lane];
#pragma unroll
      for (int q = 0; q < kRPT; ++q)
        acc2[q] = fmaf(hr[q * ldh + i], wv, acc2[q]);
    }
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

__device__ void run_rows(const RowOp* ops, int n, int B,
                         const LearnerConsts& c, float* smem, int ldh) {
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

template <bool kStore = false>
__device__ void run_grads(const GradOp* ops, int n, int B, const NetPtr* nets,
                          const AdamStep& as, const LearnerConsts& c,
                          float* smem, float* gstore = nullptr) {
  int total = 0;
  for (int o = 0; o < n; ++o) total += grad_items(ops[o]);
  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    int o = 0, rest = item;
    while (rest >= grad_items(ops[o])) rest -= grad_items(ops[o++]);
    grad_item<kStore>(ops[o], rest, B, nets, as, c, smem, gstore);
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

struct Shared {
  RowOp rows[kMaxRowOps];
  GradOp grads[kMaxGradOps];
  int n_rows, n_grads;
};

// Shared memory of one block: a row stage's input rows and weight tile, or
// a gradient stage's two 32 x 32 tiles, whichever is larger.
size_t smem_bytes(int kmax) {
  const size_t rows = static_cast<size_t>(kTR) * kmax +
                      static_cast<size_t>(kmax) * (kTC + 1);
  const size_t grads = 2 * kTG * (kTG + 1);
  return sizeof(float) * (rows > grads ? rows : grads);
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
