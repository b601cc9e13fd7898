// Kernel B3: the whole K-update DDPG learner phase, on Hopper.
//
// Replaces cartpoleplusplus_tpu/ops/learner_kernel.py::_update_kernel (the
// Pallas TPU kernel, made by ddpg_update_phase). Per update k, on the
// presampled minibatch k: the critic's TD gradient against the target
// actor and critic, Adam; the actor's gradient through dQ/da of the
// critic as updated ("updated") or as it was before ("pre"), Adam; Polyak
// on both targets. The plain twin is ops/learner_kernel.py.
//
// Bound on the H100: not arithmetic. At the defaults (batch 256, obs 42,
// hidden (256, 256), K = 16) one update is ~340 MFLOP of small matrix
// products whose results feed each other: 20 dependent stages per update
// (each layer of each pass needs the whole previous layer of its rows for
// LayerNorm, and Adam needs the whole batch's gradient). The work per stage
// is a few hundred thousand multiply-adds, so what bounds the phase is the
// latency of the stage chain. The TPU kernel ran the chain as a sequential
// grid carrying accumulators in VMEM; CUDA blocks run in no order.
//
// Design: ONE cooperative persistent launch per phase. Every block walks
// the same list of stages; cg::this_grid().sync() orders them, so the
// serial dependence (stage after stage, critic Adam before the actor
// pass, update k before k + 1) is a loop inside the kernel and the launch
// count does not depend on the number of layers or parameter tensors.
//   * Row stages: the batch is cut into 16-row tiles and each layer's
//     outputs into 32-column tiles; a block takes (row tile, column tile)
//     items. It rebuilds its rows' layer input in shared memory (copy,
//     LayerNorm + relu of the previous pre-LN z, or the LayerNorm backward
//     from the upstream gradient and the saved z), then multiplies it by
//     a 32-column tile of the weight, also staged in shared memory. The
//     matrix products are computed here, thread by thread (one column and
//     two rows each); no library GEMM is called.
//   * Gradient stages: every element of a gradient is one thread's sum
//     over the batch in a fixed order (32 x 32 weight tiles through shared
//     memory; 8 fixed row slices for the vectors), then Adam and Polyak
//     on that element in the same thread. No float atomics anywhere, so
//     two runs on the same inputs give the same bits.
//   * Parameters, targets and moments are read and written in place in
//     their 8 group buffers; activations, saved pre-LN values and gradient
//     rows go to the wrapper's workspace (a few MB at the defaults, in L2).
//
// Numerics: the library is built with --fmad=false, so a*b+c is two
// rounded operations, as in the twin. The matrix-product and batch-sum
// inner loops use explicit fmaf() (one rounding, half the instructions);
// every elementwise formula (LayerNorm, Adam, Polyak, the TD target)
// follows the twin operation by operation. The float32 constants (log b,
// gamma, tau, 1/batch, the lr schedule) are folded on the host.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace cg = cooperative_groups;

constexpr int kMaxLayers = 4;   // ops/_native.py::MAX_LAYERS

// Mirrors of ops/_native.py::NetLayout, LearnerDims and LearnerConsts.
struct NetLayout {
  int w[kMaxLayers], b[kMaxLayers], s[kMaxLayers], t[kMaxLayers];
  int wh, bh, size;
};

struct LearnerDims {
  int num_layers, obs_dim, batch, k_updates, merged;
  int hidden[kMaxLayers];
  NetLayout actor, critic;
};

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
constexpr int kActDim = 2;
constexpr int kMaxRowOps = 3;
constexpr int kMaxGradOps = 2 * (4 * kMaxLayers + 3);

enum : int { kProPlain = 0, kProLnRelu = 1, kProLnBwd = 2 };
enum : int { kEpiNone = 0, kEpiTanh = 1, kEpiTd = 2, kEpiConst = 3,
             kEpiTanhBwd = 4 };
enum : int { kGradW = 0, kGradV = 1, kGradLoss = 2 };

// The workspace: per-layer activations and gradient rows, (batch, width)
// row-major each. Carved by carve() on the host.
struct Workspace {
  // critic pass: target actor and target critic on s', critic on (s, a)
  float* zAT[kMaxLayers];
  float* zCT[kMaxLayers];
  float* zC[kMaxLayers];
  float* hinC[kMaxLayers];   // layer inputs (l >= 1) for the weight grads
  float* dzC[kMaxLayers];
  float* dyC[kMaxLayers];
  float* dyxhC[kMaxLayers];
  float *aN, *qN, *hlastC, *qC, *td, *dqC;
  // actor pass: actor on s, critic on (s, pi(s))
  float* zA[kMaxLayers];
  float* hinA[kMaxLayers];
  float* zQ[kMaxLayers];
  float* dzA[kMaxLayers];
  float* dyA[kMaxLayers];
  float* dyxhA[kMaxLayers];
  float *hlastA, *aA, *qA, *dqA, *dpreA;
  float* dh[2];              // upstream gradients, ping-pong
};

struct Groups {
  float* g[8];   // actor, critic, actor_t, critic_t, m_a, v_a, m_c, v_c
};

struct Batches {
  const float *obs, *act, *rew, *nobs;
  const bool* done;
};

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

__device__ void grad_item(const GradOp& op, int item, int B,
                          const NetPtr* nets, const AdamStep& as,
                          const LearnerConsts& c, float* sm) {
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
      if (j < op.out && i < op.in)
        adam_elem(net, op.off + j * op.in + i, acc[q], as.bc1, as.bc2, lr, c);
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

__device__ void run_grads(const GradOp* ops, int n, int B, const NetPtr* nets,
                          const AdamStep& as, const LearnerConsts& c,
                          float* smem) {
  int total = 0;
  for (int o = 0; o < n; ++o) total += grad_items(ops[o]);
  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    int o = 0, rest = item;
    while (rest >= grad_items(ops[o])) rest -= grad_items(ops[o++]);
    grad_item(ops[o], rest, B, nets, as, c, smem);
  }
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

// Emits the gradient ops of one network (0 actor, 1 critic).
__device__ void add_net_grads(Shared& sh, int net, const LearnerDims& d,
                              const NetLayout& L, const float* obs,
                              float* const* dz, float* const* dy,
                              float* const* dyxh, float* const* hin,
                              const float* dhead, int n_head,
                              const float* hlast, const float* loss_src,
                              int sq, float scale, float* dst) {
  const int nl = d.num_layers;
  for (int l = 0; l < nl; ++l) {
    const int h = d.hidden[l];
    const int in = l == 0 ? d.obs_dim
                          : d.hidden[l - 1] + (net == 1 && l == 1 ? kActDim : 0);
    sh.grads[sh.n_grads++] =
        grad_op(kGradW, net, dz[l], h, l == 0 ? obs : hin[l], in, L.w[l]);
    sh.grads[sh.n_grads++] = grad_op(kGradV, net, dz[l], h, nullptr, 0, L.b[l]);
    sh.grads[sh.n_grads++] =
        grad_op(kGradV, net, dyxh[l], h, nullptr, 0, L.s[l]);
    sh.grads[sh.n_grads++] = grad_op(kGradV, net, dy[l], h, nullptr, 0, L.t[l]);
  }
  const int hl = d.hidden[nl - 1];
  sh.grads[sh.n_grads++] = grad_op(kGradW, net, dhead, n_head, hlast, hl, L.wh);
  sh.grads[sh.n_grads++] =
      grad_op(kGradV, net, dhead, n_head, nullptr, 0, L.bh);
  GradOp loss = grad_op(kGradLoss, net, loss_src, 1, nullptr, 0, 0);
  loss.sq = sq;
  loss.scale = scale;
  loss.dst = dst;
  sh.grads[sh.n_grads++] = loss;
}

__global__ void __launch_bounds__(kThreads) ddpg_update_kernel(
    const LearnerDims d, const LearnerConsts c, const Workspace w,
    const Groups gr, const Batches bt, float* __restrict__ closs,
    float* __restrict__ aloss, const int t0, const int ldh) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  __shared__ Shared sh;
  const bool lead = threadIdx.x == 0;
  const int B = d.batch, F = d.obs_dim, nl = d.num_layers;
  const int* H = d.hidden;
  const int hl = H[nl - 1];
  const NetLayout& LA = d.actor;
  const NetLayout& LC = d.critic;
  float* const A = gr.g[0];
  float* const C = gr.g[1];
  float* const AT = gr.g[2];
  float* const CT = gr.g[3];
  NetPtr nets[2] = {{A, AT, gr.g[4], gr.g[5]}, {C, CT, gr.g[6], gr.g[7]}};

  // Stage boundaries: every block runs the same sequence of these.
  auto rows_stage = [&]() {
    __syncthreads();
    run_rows(sh.rows, sh.n_rows, B, c, smem, ldh);
    grid.sync();
  };
  auto add_row = [&](const RowOp& op) { sh.rows[sh.n_rows++] = op; };

  for (int k = 0; k < d.k_updates; ++k) {
    const float* obs = bt.obs + static_cast<size_t>(k) * B * F;
    const float* nobs = bt.nobs + static_cast<size_t>(k) * B * F;
    const float* act = bt.act + static_cast<size_t>(k) * B * kActDim;
    const float* rew = bt.rew + static_cast<size_t>(k) * B;
    const bool* done = bt.done + static_cast<size_t>(k) * B;
    const float tk = static_cast<float>(t0 + k + 1);
    AdamStep as;
    as.bc1 = 1.0f - expf(tk * c.log_b1);
    as.bc2 = 1.0f - expf(tk * c.log_b2);
    const float frac =
        c.sched ? fminf((tk - 1.0f) / c.sched_steps, 1.0f) : 0.0f;
    as.lr[0] = c.sched ? c.actor_lr + frac * c.actor_lr_delta : c.actor_lr;
    as.lr[1] = c.sched ? c.critic_lr + frac * c.critic_lr_delta : c.critic_lr;

    // ---- critic pass: y from the targets on s', Q(s, a) and its grads ----
    if (lead) {
      sh.n_rows = 0;
      add_row(fwd_op(nobs, F, kProPlain, nullptr, nullptr, nullptr, 0,
                     AT + LA.w[0], AT + LA.b[0], H[0], w.zAT[0], nullptr,
                     kEpiNone));
      add_row(fwd_op(nobs, F, kProPlain, nullptr, nullptr, nullptr, 0,
                     CT + LC.w[0], CT + LC.b[0], H[0], w.zCT[0], nullptr,
                     kEpiNone));
      add_row(fwd_op(obs, F, kProPlain, nullptr, nullptr, nullptr, 0,
                     C + LC.w[0], C + LC.b[0], H[0], w.zC[0], nullptr,
                     kEpiNone));
    }
    rows_stage();
    for (int l = 1; l < nl; ++l) {
      if (lead) {
        sh.n_rows = 0;
        add_row(fwd_op(w.zAT[l - 1], H[l - 1], kProLnRelu, AT + LA.s[l - 1],
                       AT + LA.t[l - 1], nullptr, 0, AT + LA.w[l],
                       AT + LA.b[l], H[l], w.zAT[l], nullptr, kEpiNone));
        add_row(fwd_op(w.zC[l - 1], H[l - 1], kProLnRelu, C + LC.s[l - 1],
                       C + LC.t[l - 1], l == 1 ? act : nullptr,
                       l == 1 ? kActDim : 0, C + LC.w[l], C + LC.b[l], H[l],
                       w.zC[l], w.hinC[l], kEpiNone));
      }
      rows_stage();
    }
    if (lead) {
      sh.n_rows = 0;
      add_row(fwd_op(w.zAT[nl - 1], hl, kProLnRelu, AT + LA.s[nl - 1],
                     AT + LA.t[nl - 1], nullptr, 0, AT + LA.wh, AT + LA.bh,
                     kActDim, w.aN, nullptr, kEpiTanh));
      add_row(fwd_op(w.zC[nl - 1], hl, kProLnRelu, C + LC.s[nl - 1],
                     C + LC.t[nl - 1], nullptr, 0, C + LC.wh, C + LC.bh, 1,
                     w.qC, w.hlastC, kEpiNone));
    }
    rows_stage();
    for (int l = 1; l < nl; ++l) {
      if (lead) {
        sh.n_rows = 0;
        add_row(fwd_op(w.zCT[l - 1], H[l - 1], kProLnRelu, CT + LC.s[l - 1],
                       CT + LC.t[l - 1], l == 1 ? w.aN : nullptr,
                       l == 1 ? kActDim : 0, CT + LC.w[l], CT + LC.b[l], H[l],
                       w.zCT[l], nullptr, kEpiNone));
      }
      rows_stage();
    }
    if (lead) {
      sh.n_rows = 0;
      RowOp op = fwd_op(w.zCT[nl - 1], hl, kProLnRelu, CT + LC.s[nl - 1],
                        CT + LC.t[nl - 1], nullptr, 0, CT + LC.wh, CT + LC.bh,
                        1, w.qN, nullptr, kEpiTd);
      op.e0 = w.qC;
      op.e1 = rew;
      op.edone = done;
      op.eout0 = w.td;
      op.eout1 = w.dqC;
      add_row(op);
    }
    rows_stage();
    if (lead) {
      sh.n_rows = 0;
      add_row(bwd_op(w.dqC, nullptr, 1, nullptr, nullptr, nullptr, nullptr,
                     nullptr, C + LC.wh, hl, 0, hl, w.dh[0]));
    }
    rows_stage();
    int cur = 0;
    for (int l = nl - 1; l >= 0; --l) {
      if (lead) {
        sh.n_rows = 0;
        const int in_w = l == 0 ? F : H[l - 1] + (l == 1 ? kActDim : 0);
        add_row(bwd_op(w.dh[cur], w.zC[l], H[l], C + LC.s[l], C + LC.t[l],
                       w.dzC[l], w.dyC[l], w.dyxhC[l], C + LC.w[l], in_w, 0,
                       l == 0 ? 0 : H[l - 1], w.dh[cur ^ 1]));
      }
      rows_stage();
      cur ^= 1;
    }
    if (!d.merged) {  // critic Adam before the actor pass
      if (lead) {
        sh.n_grads = 0;
        add_net_grads(sh, 1, d, LC, obs, w.dzC, w.dyC, w.dyxhC, w.hinC, w.dqC,
                      1, w.hlastC, w.td, 1, c.inv_batch, closs + k);
      }
      __syncthreads();
      run_grads(sh.grads, sh.n_grads, B, nets, as, c, smem);
      grid.sync();
    }

    // ---- actor pass: -mean Q(s, pi(s)) through dQ/da into the actor ----
    if (lead) {
      sh.n_rows = 0;
      add_row(fwd_op(obs, F, kProPlain, nullptr, nullptr, nullptr, 0,
                     A + LA.w[0], A + LA.b[0], H[0], w.zA[0], nullptr,
                     kEpiNone));
      add_row(fwd_op(obs, F, kProPlain, nullptr, nullptr, nullptr, 0,
                     C + LC.w[0], C + LC.b[0], H[0], w.zQ[0], nullptr,
                     kEpiNone));
    }
    rows_stage();
    for (int l = 1; l < nl; ++l) {
      if (lead) {
        sh.n_rows = 0;
        add_row(fwd_op(w.zA[l - 1], H[l - 1], kProLnRelu, A + LA.s[l - 1],
                       A + LA.t[l - 1], nullptr, 0, A + LA.w[l], A + LA.b[l],
                       H[l], w.zA[l], w.hinA[l], kEpiNone));
      }
      rows_stage();
    }
    if (lead) {
      sh.n_rows = 0;
      add_row(fwd_op(w.zA[nl - 1], hl, kProLnRelu, A + LA.s[nl - 1],
                     A + LA.t[nl - 1], nullptr, 0, A + LA.wh, A + LA.bh,
                     kActDim, w.aA, w.hlastA, kEpiTanh));
    }
    rows_stage();
    for (int l = 1; l < nl; ++l) {
      if (lead) {
        sh.n_rows = 0;
        add_row(fwd_op(w.zQ[l - 1], H[l - 1], kProLnRelu, C + LC.s[l - 1],
                       C + LC.t[l - 1], l == 1 ? w.aA : nullptr,
                       l == 1 ? kActDim : 0, C + LC.w[l], C + LC.b[l], H[l],
                       w.zQ[l], nullptr, kEpiNone));
      }
      rows_stage();
    }
    if (lead) {
      sh.n_rows = 0;
      RowOp op = fwd_op(w.zQ[nl - 1], hl, kProLnRelu, C + LC.s[nl - 1],
                        C + LC.t[nl - 1], nullptr, 0, C + LC.wh, C + LC.bh, 1,
                        w.qA, nullptr, kEpiConst);
      op.eout1 = w.dqA;
      add_row(op);
    }
    rows_stage();
    if (lead) {
      sh.n_rows = 0;
      add_row(bwd_op(w.dqA, nullptr, 1, nullptr, nullptr, nullptr, nullptr,
                     nullptr, C + LC.wh, hl, 0, hl, w.dh[0]));
    }
    rows_stage();
    cur = 0;
    for (int l = nl - 1; l >= 1; --l) {  // critic layers down to dQ/da
      if (lead) {
        sh.n_rows = 0;
        if (l > 1) {
          add_row(bwd_op(w.dh[cur], w.zQ[l], H[l], C + LC.s[l], C + LC.t[l],
                         nullptr, nullptr, nullptr, C + LC.w[l], H[l - 1], 0,
                         H[l - 1], w.dh[cur ^ 1]));
        } else {
          RowOp op = bwd_op(w.dh[cur], w.zQ[1], H[1], C + LC.s[1],
                            C + LC.t[1], nullptr, nullptr, nullptr,
                            C + LC.w[1], H[0] + kActDim, H[0], kActDim,
                            w.dpreA);
          op.epi = kEpiTanhBwd;
          op.e0 = w.aA;
          add_row(op);
        }
      }
      rows_stage();
      cur ^= 1;
    }
    if (lead) {
      sh.n_rows = 0;
      add_row(bwd_op(w.dpreA, nullptr, kActDim, nullptr, nullptr, nullptr,
                     nullptr, nullptr, A + LA.wh, hl, 0, hl, w.dh[0]));
    }
    rows_stage();
    cur = 0;
    for (int l = nl - 1; l >= 0; --l) {
      if (lead) {
        sh.n_rows = 0;
        const int in_w = l == 0 ? F : H[l - 1];
        add_row(bwd_op(w.dh[cur], w.zA[l], H[l], A + LA.s[l], A + LA.t[l],
                       w.dzA[l], w.dyA[l], w.dyxhA[l], A + LA.w[l], in_w, 0,
                       l == 0 ? 0 : H[l - 1], w.dh[cur ^ 1]));
      }
      rows_stage();
      cur ^= 1;
    }
    if (lead) {
      sh.n_grads = 0;
      if (d.merged)
        add_net_grads(sh, 1, d, LC, obs, w.dzC, w.dyC, w.dyxhC, w.hinC, w.dqC,
                      1, w.hlastC, w.td, 1, c.inv_batch, closs + k);
      add_net_grads(sh, 0, d, LA, obs, w.dzA, w.dyA, w.dyxhA, w.hinA,
                    w.dpreA, kActDim, w.hlastA, w.qA, 0, c.neg_inv_batch,
                    aloss + k);
    }
    __syncthreads();
    run_grads(sh.grads, sh.n_grads, B, nets, as, c, smem);
    grid.sync();
  }
}

// Carves the workspace from `base` (or only counts floats when it is null).
long long carve(const LearnerDims& d, float* base, Workspace* w) {
  long long off = 0;
  auto take = [&](long long n) -> float* {
    float* p = base != nullptr ? base + off : nullptr;
    off += (n + 31) / 32 * 32;   // 128-byte aligned pieces
    return p;
  };
  const long long B = d.batch;
  const int nl = d.num_layers;
  int wmax = d.obs_dim;
  for (int l = 0; l < nl; ++l) wmax = d.hidden[l] > wmax ? d.hidden[l] : wmax;
  *w = Workspace{};
  for (int l = 0; l < nl; ++l) {
    const long long h = d.hidden[l];
    const long long in_c = l == 0 ? 0 : d.hidden[l - 1] + (l == 1 ? kActDim : 0);
    const long long in_a = l == 0 ? 0 : d.hidden[l - 1];
    w->zAT[l] = take(B * h);
    w->zCT[l] = take(B * h);
    w->zC[l] = take(B * h);
    w->hinC[l] = l == 0 ? nullptr : take(B * in_c);
    w->dzC[l] = take(B * h);
    w->dyC[l] = take(B * h);
    w->dyxhC[l] = take(B * h);
    w->zA[l] = take(B * h);
    w->hinA[l] = l == 0 ? nullptr : take(B * in_a);
    w->zQ[l] = take(B * h);
    w->dzA[l] = take(B * h);
    w->dyA[l] = take(B * h);
    w->dyxhA[l] = take(B * h);
  }
  const long long hl = d.hidden[nl - 1];
  w->aN = take(B * kActDim);
  w->qN = take(B);
  w->hlastC = take(B * hl);
  w->qC = take(B);
  w->td = take(B);
  w->dqC = take(B);
  w->hlastA = take(B * hl);
  w->aA = take(B * kActDim);
  w->qA = take(B);
  w->dqA = take(B);
  w->dpreA = take(B * kActDim);
  w->dh[0] = take(B * (wmax + kActDim));
  w->dh[1] = take(B * (wmax + kActDim));
  return off;
}

bool dims_ok(const LearnerDims& d) {
  if (d.num_layers < 2 || d.num_layers > kMaxLayers || d.obs_dim < 1 ||
      d.batch < 1 || d.k_updates < 1)
    return false;
  for (int l = 0; l < d.num_layers; ++l)
    if (d.hidden[l] < 1 || d.hidden[l] + kActDim > kMaxWidth) return false;
  return d.obs_dim + kActDim <= kMaxWidth;
}

// Row width of the shared-memory input rows: the widest layer input.
int kmax_of(const LearnerDims& d) {
  int k = d.obs_dim;
  for (int l = 0; l < d.num_layers; ++l)
    k = d.hidden[l] + kActDim > k ? d.hidden[l] + kActDim : k;
  return k;
}

size_t smem_bytes(int kmax) {
  const size_t rows = static_cast<size_t>(kTR) * kmax +
                      static_cast<size_t>(kmax) * (kTC + 1);
  const size_t grads = 2 * kTG * (kTG + 1);
  return sizeof(float) * (rows > grads ? rows : grads);
}

}  // namespace

extern "C" {

// Floats of workspace cp_ddpg_update_phase needs for these dims (0 when the
// dims are outside what the kernel takes).
long long cp_ddpg_workspace_floats(const LearnerDims* dims) {
  if (!dims_ok(*dims)) return 0;
  Workspace w;
  return carve(*dims, nullptr, &w);
}

// The K-update phase in one cooperative launch on `stream`. groups: the 8
// group buffers (updated in place); batches: obs (K, B, F), act (K, B, 2),
// rew (K, B), nobs (K, B, F), done (K, B) bool; closs/aloss (K,);
// workspace: cp_ddpg_workspace_floats(dims) floats; t0: the Adam count
// before the phase. Returns a cudaError_t.
int cp_ddpg_update_phase(const LearnerDims* dims, const LearnerConsts* consts,
                         float* actor, float* critic, float* actor_t,
                         float* critic_t, float* m_a, float* v_a, float* m_c,
                         float* v_c, const float* obs, const float* act,
                         const float* rew, const float* nobs, const bool* done,
                         float* closs, float* aloss, float* workspace, int t0,
                         void* stream) {
  LearnerDims d = *dims;
  LearnerConsts c = *consts;
  if (!dims_ok(d)) return static_cast<int>(cudaErrorInvalidValue);
  Workspace w;
  carve(d, workspace, &w);
  Groups gr = {{actor, critic, actor_t, critic_t, m_a, v_a, m_c, v_c}};
  Batches bt = {obs, act, rew, nobs, done};
  int ldh = kmax_of(d);
  const size_t smem = smem_bytes(ldh);

  static int blocks = 0;
  static size_t blocks_smem = 0;
  cudaError_t err = cudaFuncSetAttribute(
      ddpg_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks == 0 || blocks_smem != smem) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, ddpg_update_kernel, kThreads, smem)) != cudaSuccess)
      return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    blocks = sms * (per_sm < 2 ? per_sm : 2);
    blocks_smem = smem;
  }
  void* args[] = {&d, &c, &w, &gr, &bt, &closs, &aloss, &t0, &ldh};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(ddpg_update_kernel),
                                    dim3(blocks), dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
