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
// Bound on the H100: as B3, the latency of a chain of small dependent
// stages, not arithmetic (~95 MFLOP of matrix products per update at batch
// 256, obs 42, hidden (256, 256)). Design: B3's (learner_stages.cuh, the
// same device code): one cooperative persistent launch per phase, every
// block walking the same stage list between grid barriers. One update is
// 2L + 4 stages (8 at two hidden layers; B3 takes 20): L forward stages
// that run the three passes (target on s', online on s', online on s) in
// lockstep, the three 5-wide heads, the TD epilogue (one batch row per
// thread), the head backward, L LayerNorm-backward stages, and one stage
// that reduces every gradient element in a fixed order and applies Adam and
// Polyak to it. No float atomics: two runs give the same bits.
#include "learner_stages.cuh"

// Mirror of ops/_native.py::DqnDims.
struct DqnDims {
  int num_layers, obs_dim, batch, k_updates, double_dqn;
  int hidden[kMaxLayers];
  NetLayout q;
};

namespace {

constexpr int kNumActions = 5;  // ops/learner_kernel.py::NUM_ACTIONS

// The workspace: per-layer activations and gradient rows, (batch, width)
// row-major each. Carved by carve() on the host.
struct DqnWorkspace {
  float* zT[kMaxLayers];    // target net on s' (pre-LN)
  float* zN[kMaxLayers];    // online net on s' (double DQN's selector)
  float* zS[kMaxLayers];    // online net on s
  float* hin[kMaxLayers];   // its layer inputs (l >= 1) for the weight grads
  float* dz[kMaxLayers];
  float* dy[kMaxLayers];
  float* dyxh[kMaxLayers];
  float *qT, *qN, *qS, *hlast, *dq, *hub;
  float* dh[2];             // upstream gradients, ping-pong
};

struct DqnBatches {
  const float *obs, *rew, *nobs;
  const int* act;
  const bool* done;
};

// The TD epilogue, one batch row per thread: the first-max argmax of the
// selector (the online net on s' under double DQN, else the target net;
// a strict >, jnp.argmax's tie rule), the target y, the Huber-clipped
// gradient at the taken action (B, 5), and the row's Huber term.
__device__ void td_rows(const DqnWorkspace& w, const DqnBatches& bt, int k,
                        int B, int double_dqn, const LearnerConsts& c) {
  for (int b = blockIdx.x * kThreads + threadIdx.x; b < B;
       b += gridDim.x * kThreads) {
    const size_t r = static_cast<size_t>(k) * B + b;
    const float* qt = w.qT + static_cast<size_t>(b) * kNumActions;
    const float* sel =
        double_dqn ? w.qN + static_cast<size_t>(b) * kNumActions : qt;
    int first = 0;
    float best = sel[0];
    for (int a = 1; a < kNumActions; ++a) {
      if (sel[a] > best) {
        best = sel[a];
        first = a;
      }
    }
    const float notdone = 1.0f - (bt.done[r] ? 1.0f : 0.0f);
    const float y = bt.rew[r] + (c.gamma * notdone) * qt[first];
    const int act = bt.act[r];
    const float td = w.qS[static_cast<size_t>(b) * kNumActions + act] - y;
    const float g = fminf(fmaxf(td, -1.0f), 1.0f) * c.inv_batch;
    for (int a = 0; a < kNumActions; ++a)
      w.dq[static_cast<size_t>(b) * kNumActions + a] = a == act ? g : 0.0f;
    const float abs_td = fabsf(td);
    w.hub[b] = abs_td <= 1.0f ? 0.5f * td * td : 1.0f * (abs_td - 0.5f);
  }
}

__global__ void __launch_bounds__(kThreads) dqn_update_kernel(
    const DqnDims d, const LearnerConsts c, const DqnWorkspace w,
    float* __restrict__ qp, float* __restrict__ qtp, float* __restrict__ m,
    float* __restrict__ v, const DqnBatches bt, float* __restrict__ loss,
    const int t0, const int ldh) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  __shared__ Shared sh;
  const bool lead = threadIdx.x == 0;
  const int B = d.batch, F = d.obs_dim, nl = d.num_layers;
  const int* H = d.hidden;
  const int hl = H[nl - 1];
  const NetLayout& L = d.q;
  float* const Q = qp;
  float* const QT = qtp;
  const NetPtr nets[1] = {{Q, QT, m, v}};

  // Stage boundaries: every block runs the same sequence of these.
  auto rows_stage = [&]() {
    __syncthreads();
    run_rows(sh.rows, sh.n_rows, B, c, smem, ldh);
    grid.sync();
  };
  auto add_row = [&](const RowOp& op) { sh.rows[sh.n_rows++] = op; };
  auto add_grad = [&](const GradOp& op) { sh.grads[sh.n_grads++] = op; };

  for (int k = 0; k < d.k_updates; ++k) {
    const float* obs = bt.obs + static_cast<size_t>(k) * B * F;
    const float* nobs = bt.nobs + static_cast<size_t>(k) * B * F;
    const float tk = static_cast<float>(t0 + k + 1);
    AdamStep as;
    as.bc1 = 1.0f - expf(tk * c.log_b1);
    as.bc2 = 1.0f - expf(tk * c.log_b2);
    as.lr[0] = as.lr[1] = c.actor_lr;

    // ---- forward: target on s', online on s' (double DQN), online on s ----
    for (int l = 0; l < nl; ++l) {
      if (lead) {
        sh.n_rows = 0;
        const int kx = l == 0 ? F : H[l - 1];
        const int pro = l == 0 ? kProPlain : kProLnRelu;
        const bool first = l == 0;
        add_row(fwd_op(first ? nobs : w.zT[l - 1], kx, pro,
                       first ? nullptr : QT + L.s[l - 1],
                       first ? nullptr : QT + L.t[l - 1], nullptr, 0,
                       QT + L.w[l], QT + L.b[l], H[l], w.zT[l], nullptr,
                       kEpiNone));
        if (d.double_dqn)
          add_row(fwd_op(first ? nobs : w.zN[l - 1], kx, pro,
                         first ? nullptr : Q + L.s[l - 1],
                         first ? nullptr : Q + L.t[l - 1], nullptr, 0,
                         Q + L.w[l], Q + L.b[l], H[l], w.zN[l], nullptr,
                         kEpiNone));
        add_row(fwd_op(first ? obs : w.zS[l - 1], kx, pro,
                       first ? nullptr : Q + L.s[l - 1],
                       first ? nullptr : Q + L.t[l - 1], nullptr, 0,
                       Q + L.w[l], Q + L.b[l], H[l], w.zS[l],
                       first ? nullptr : w.hin[l], kEpiNone));
      }
      rows_stage();
    }
    if (lead) {  // the three 5-wide heads
      sh.n_rows = 0;
      add_row(fwd_op(w.zT[nl - 1], hl, kProLnRelu, QT + L.s[nl - 1],
                     QT + L.t[nl - 1], nullptr, 0, QT + L.wh, QT + L.bh,
                     kNumActions, w.qT, nullptr, kEpiNone));
      if (d.double_dqn)
        add_row(fwd_op(w.zN[nl - 1], hl, kProLnRelu, Q + L.s[nl - 1],
                       Q + L.t[nl - 1], nullptr, 0, Q + L.wh, Q + L.bh,
                       kNumActions, w.qN, nullptr, kEpiNone));
      add_row(fwd_op(w.zS[nl - 1], hl, kProLnRelu, Q + L.s[nl - 1],
                     Q + L.t[nl - 1], nullptr, 0, Q + L.wh, Q + L.bh,
                     kNumActions, w.qS, w.hlast, kEpiNone));
    }
    rows_stage();
    td_rows(w, bt, k, B, d.double_dqn, c);
    grid.sync();

    // ---- backward through the online net on s ----
    if (lead) {
      sh.n_rows = 0;
      add_row(bwd_op(w.dq, nullptr, kNumActions, nullptr, nullptr, nullptr,
                     nullptr, nullptr, Q + L.wh, hl, 0, hl, w.dh[0]));
    }
    rows_stage();
    int cur = 0;
    for (int l = nl - 1; l >= 0; --l) {
      if (lead) {
        sh.n_rows = 0;
        add_row(bwd_op(w.dh[cur], w.zS[l], H[l], Q + L.s[l], Q + L.t[l],
                       w.dz[l], w.dy[l], w.dyxh[l], Q + L.w[l],
                       l == 0 ? F : H[l - 1], 0, l == 0 ? 0 : H[l - 1],
                       w.dh[cur ^ 1]));
      }
      rows_stage();
      cur ^= 1;
    }

    // ---- every gradient element, Adam, Polyak; the loss ----
    if (lead) {
      sh.n_grads = 0;
      for (int l = 0; l < nl; ++l) {
        add_grad(grad_op(kGradW, 0, w.dz[l], H[l], l == 0 ? obs : w.hin[l],
                         l == 0 ? F : H[l - 1], L.w[l]));
        add_grad(grad_op(kGradV, 0, w.dz[l], H[l], nullptr, 0, L.b[l]));
        add_grad(grad_op(kGradV, 0, w.dyxh[l], H[l], nullptr, 0, L.s[l]));
        add_grad(grad_op(kGradV, 0, w.dy[l], H[l], nullptr, 0, L.t[l]));
      }
      add_grad(grad_op(kGradW, 0, w.dq, kNumActions, w.hlast, hl, L.wh));
      add_grad(grad_op(kGradV, 0, w.dq, kNumActions, nullptr, 0, L.bh));
      GradOp lo = grad_op(kGradLoss, 0, w.hub, 1, nullptr, 0, 0);
      lo.sq = 0;
      lo.scale = c.inv_batch;
      lo.dst = loss + k;
      add_grad(lo);
    }
    __syncthreads();
    run_grads(sh.grads, sh.n_grads, B, nets, as, c, smem);
    grid.sync();
  }
}

// Carves the workspace from `base` (or only counts floats when it is null).
long long carve(const DqnDims& d, float* base, DqnWorkspace* w) {
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
  *w = DqnWorkspace{};
  for (int l = 0; l < nl; ++l) {
    const long long h = d.hidden[l];
    w->zT[l] = take(B * h);
    w->zN[l] = take(B * h);
    w->zS[l] = take(B * h);
    w->hin[l] = l == 0 ? nullptr : take(B * d.hidden[l - 1]);
    w->dz[l] = take(B * h);
    w->dy[l] = take(B * h);
    w->dyxh[l] = take(B * h);
  }
  w->qT = take(B * kNumActions);
  w->qN = take(B * kNumActions);
  w->qS = take(B * kNumActions);
  w->hlast = take(B * d.hidden[nl - 1]);
  w->dq = take(B * kNumActions);
  w->hub = take(B);
  w->dh[0] = take(B * wmax);
  w->dh[1] = take(B * wmax);
  return off;
}

bool dims_ok(const DqnDims& d) {
  if (d.num_layers < 1 || d.num_layers > kMaxLayers || d.obs_dim < 1 ||
      d.obs_dim > kMaxWidth || d.batch < 1 || d.k_updates < 1)
    return false;
  for (int l = 0; l < d.num_layers; ++l)
    if (d.hidden[l] < 1 || d.hidden[l] > kMaxWidth) return false;
  return true;
}

// Row width of the shared-memory input rows: the widest layer input.
int kmax_of(const DqnDims& d) {
  int k = d.obs_dim;
  for (int l = 0; l < d.num_layers; ++l) k = d.hidden[l] > k ? d.hidden[l] : k;
  return k;
}

}  // namespace

extern "C" {

// Floats of workspace cp_dqn_update_phase needs for these dims (0 when the
// dims are outside what the kernel takes).
long long cp_dqn_workspace_floats(const DqnDims* dims) {
  if (!dims_ok(*dims)) return 0;
  DqnWorkspace w;
  return carve(*dims, nullptr, &w);
}

// The K-update phase in one cooperative launch on `stream`. q, q_t, m, v:
// the 4 group buffers (updated in place); batches: obs (K, B, F), act
// (K, B) int32, rew (K, B), nobs (K, B, F), done (K, B) bool; loss (K,);
// workspace: cp_dqn_workspace_floats(dims) floats; t0: the Adam count
// before the phase. Returns a cudaError_t.
int cp_dqn_update_phase(const DqnDims* dims, const LearnerConsts* consts,
                        float* q, float* q_t, float* m, float* v,
                        const float* obs, const int* act, const float* rew,
                        const float* nobs, const bool* done, float* loss,
                        float* workspace, int t0, void* stream) {
  DqnDims d = *dims;
  LearnerConsts c = *consts;
  if (!dims_ok(d)) return static_cast<int>(cudaErrorInvalidValue);
  DqnWorkspace w;
  carve(d, workspace, &w);
  DqnBatches bt = {obs, rew, nobs, act, done};
  int ldh = kmax_of(d);
  const size_t smem = smem_bytes(ldh);
  static int blocks = 0;
  static size_t blocks_smem = 0;
  void* args[] = {&d, &c, &w, &q, &q_t, &m, &v, &bt, &loss, &t0, &ldh};
  return static_cast<int>(launch_cooperative(
      reinterpret_cast<const void*>(dqn_update_kernel), smem, args,
      static_cast<cudaStream_t>(stream), blocks, blocks_smem));
}

}  // extern "C"
