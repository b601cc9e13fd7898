// The shared pieces of the cooperative learner kernels B3 (ddpg_update.cu),
// B5 (dqn_update.cu) and B7 (naf_update.cu), whose row chains are
// row_chain.cuh, and of B9 (lrpg_update.cu): the stage clock of the
// instrumented build, the mirrors of the host's structures (NetLayout,
// Torso, LearnerConsts), the device table's copy in shared memory, the
// LayerNorm statistics, Adam and Polyak on a few elements, the gradient ops of
// a network (net_grad_op) and the loss's reduction, the clipped update's
// scale and Adam (adam_flat), and the cooperative launch.
//   * Every element of a gradient is one thread's sum over the batch in a
//     fixed order, then Adam and Polyak on that element in the same thread.
//     No float atomics anywhere, so two runs on the same inputs give the
//     same bits.
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
// cooperative_groups' own), and where a kernel marks the end of one of its
// phases (CP_MARK(id), id 3 to 15, right after a block barrier; a kernel
// without a grid barrier marks its start with CP_MARK_START). One kernel
// source per library: the buffers and the readers are defined here.
namespace cp_clock {
constexpr int kBlocks = 512, kMarks = 2048;
enum : int { kRelease = 0, kArrive = 2 };
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
constexpr int kNormParts = 256;         // slices of a flat gradient

enum : int { kGradW = 0, kGradV = 1, kGradLoss = 2 };

// One gradient of a network, reduced over the batch and applied with Adam
// (and Polyak) in place (row_chain.cuh's grad_stage). W: g (B, out), x (B,
// in) -> dW (out, in). V: sum over b of g (B, out). Loss: scale * sum over
// b of g (or g^2).
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

// --- gradients --------------------------------------------------------------

struct AdamStep {
  float bc1, bc2, lr[2];   // lr per net: 0 actor, 1 critic
};

// Adam (optax.adam's update, operation by operation) and Polyak on N
// elements (off[i], gradient g[i]) of a network where ok[i]: every moment,
// parameter and target read first, so that the reads overlap.
template <int N>
__device__ __forceinline__ void adam_elems(const NetPtr& n, const int* off,
                                           const bool* ok, const float* g,
                                           float bc1, float bc2, float lr,
                                           const LearnerConsts& c) {
  float m[N], v[N], p[N], t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (!ok[i]) continue;
    m[i] = n.m[off[i]];
    v[i] = n.v[off[i]];
    p[i] = n.p[off[i]];
    t[i] = n.tgt[off[i]];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (!ok[i]) continue;
    const float mi = c.b1 * m[i] + c.omb1 * g[i];
    const float vi = c.b2 * v[i] + c.omb2 * (g[i] * g[i]);
    const float pi = p[i] - lr * (mi / bc1) / (sqrtf(vi / bc2) + c.eps);
    n.m[off[i]] = mi;
    n.v[off[i]] = vi;
    n.p[off[i]] = pi;
    n.tgt[off[i]] = t[i] + c.tau * (pi - t[i]);
  }
}

// The loss of a network's gradient list (kGradLoss): *dst = scale * the
// sum over the batch of g (or g^2 when sq), each thread summing a strided
// share, thread 0 the shares in order.
__device__ void loss_item(const GradOp& op, int B, float* sm) {
  const int tid = threadIdx.x;
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

// --- a clipped update (a global-norm clip) ---------------------------------

// optax.clip_by_global_norm then Adam and Polyak on every element of the
// flat gradient g[0, n) of `net`: the norm is the square root of the
// partials summed in order (the same bits in every block; read into shared
// memory by all threads first), the scale 1 below max_norm and max_norm /
// norm at or above it.
static_assert(kNormParts == kThreads, "a partial a thread");
__device__ void adam_flat(const float* g, int n, const float* parts,
                          float max_norm, const NetPtr& net,
                          const AdamStep& as, float lr,
                          const LearnerConsts& c, float* sm) {
  sm[threadIdx.x] = parts[threadIdx.x];
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int i = 0; i < kNormParts; ++i) total = total + sm[i];
    const float norm = sqrtf(total);
    sm[kNormParts] = norm < max_norm ? 1.0f : max_norm / norm;
  }
  __syncthreads();
  CP_MARK(7);  // the norm
  const float scale = sm[kNormParts];
  constexpr int kU = 4;  // elements a thread takes at once
  const int stride = gridDim.x * kThreads;
  for (int e0 = blockIdx.x * kThreads + threadIdx.x; e0 < n;
       e0 += kU * stride) {
    int off[kU];
    bool ok[kU];
    float gs[kU];
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      off[i] = e0 + i * stride;
      ok[i] = off[i] < n;
      gs[i] = ok[i] ? g[off[i]] * scale : 0.0f;
    }
    adam_elems<kU>(net, off, ok, gs, as.bc1, as.bc2, lr, c);
  }
  CP_MARK(8);  // Adam and Polyak
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

// The device table (n ints from t.tab, which every NetLayout points into)
// copied into shared memory after the block's region, so that the items
// read widths and offsets there; returns the torso pointing at the copy.
// Ends with a barrier.
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
