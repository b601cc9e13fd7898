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
// Polyak to it. No float atomics: two runs give the same bits. Any depth
// >= 1 and any width, as the reference's kernel takes (learner_stages.cuh:
// device tables of the widths and offsets, chunked row stages).
#include "learner_stages.cuh"

// Mirror of ops/_native.py::DqnDims.
struct DqnDims {
  int obs_dim, batch, k_updates, double_dqn;
  Torso torso;
  NetLayout q;
};

namespace {

constexpr int kNumActions = 5;  // ops/learner_kernel.py::NUM_ACTIONS

// The workspace: per-layer regions of activations and gradient rows,
// layer l's (batch, H_l) rows at layer_rows(region, l), the layer inputs
// (l >= 1) at input_rows. Carved by carve() on the host.
struct DqnWorkspace {
  float* zT;    // target net on s' (pre-LN)
  float* zN;    // online net on s' (double DQN's selector)
  float* zS;    // online net on s
  float* hin;   // its layer inputs (l >= 1) for the weight grads
  float *dz, *dy, *dyxh;
  float *qT, *qN, *qS, *hlast, *dq, *hub;
  float* dh[2];  // upstream gradients, ping-pong
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

// Ints of the device table: the widths and their prefix sums, then the
// net's per-layer offsets.
__host__ __device__ inline int table_ints(const DqnDims& d) {
  return 6 * d.torso.L;
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
  const int B = d.batch, F = d.obs_dim;
  int* const tab = reinterpret_cast<int*>(smem + region_floats(ldh));
  const Torso T = stage_table(d.torso, table_ints(d), tab);
  const int nl = T.L;
  const int hl = T.h(nl - 1);
  const NetLayout L = layout_on(d.q, d.torso, T);
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
  auto Z = [&](float* region, int l) { return layer_rows(region, T, l, B); };

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
        const bool first = l == 0;
        const int kx = first ? F : T.h(l - 1);
        const int pro = first ? kProPlain : kProLnRelu;
        const int h = T.h(l);
        add_row(fwd_op(first ? nobs : Z(w.zT, l - 1), kx, pro,
                       first ? nullptr : QT + L.s(l - 1),
                       first ? nullptr : QT + L.t(l - 1), nullptr, 0,
                       QT + L.w(l), QT + L.b(l), h, Z(w.zT, l), nullptr,
                       kEpiNone));
        if (d.double_dqn)
          add_row(fwd_op(first ? nobs : Z(w.zN, l - 1), kx, pro,
                         first ? nullptr : Q + L.s(l - 1),
                         first ? nullptr : Q + L.t(l - 1), nullptr, 0,
                         Q + L.w(l), Q + L.b(l), h, Z(w.zN, l), nullptr,
                         kEpiNone));
        add_row(fwd_op(first ? obs : Z(w.zS, l - 1), kx, pro,
                       first ? nullptr : Q + L.s(l - 1),
                       first ? nullptr : Q + L.t(l - 1), nullptr, 0,
                       Q + L.w(l), Q + L.b(l), h, Z(w.zS, l),
                       first ? nullptr : input_rows(w.hin, T, l, 0, B),
                       kEpiNone));
      }
      rows_stage();
    }
    if (lead) {  // the three 5-wide heads
      sh.n_rows = 0;
      add_row(fwd_op(Z(w.zT, nl - 1), hl, kProLnRelu, QT + L.s(nl - 1),
                     QT + L.t(nl - 1), nullptr, 0, QT + L.wh, QT + L.bh,
                     kNumActions, w.qT, nullptr, kEpiNone));
      if (d.double_dqn)
        add_row(fwd_op(Z(w.zN, nl - 1), hl, kProLnRelu, Q + L.s(nl - 1),
                       Q + L.t(nl - 1), nullptr, 0, Q + L.wh, Q + L.bh,
                       kNumActions, w.qN, nullptr, kEpiNone));
      add_row(fwd_op(Z(w.zS, nl - 1), hl, kProLnRelu, Q + L.s(nl - 1),
                     Q + L.t(nl - 1), nullptr, 0, Q + L.wh, Q + L.bh,
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
        add_row(bwd_op(w.dh[cur], Z(w.zS, l), T.h(l), Q + L.s(l), Q + L.t(l),
                       Z(w.dz, l), Z(w.dy, l), Z(w.dyxh, l), Q + L.w(l),
                       l == 0 ? F : T.h(l - 1), 0, l == 0 ? 0 : T.h(l - 1),
                       w.dh[cur ^ 1]));
      }
      rows_stage();
      cur ^= 1;
    }

    // ---- every gradient element, Adam, Polyak; the loss ----
    if (lead) {
      sh.nets[0] = NetGrads{0, 0, kNumActions, 0, c.inv_batch, loss + k,
                            obs, w.dz, w.dy, w.dyxh, w.hin, w.dq, w.hlast,
                            w.hub, L};
      sh.n_nets = 1;
    }
    run_net_grads(sh, T, F, B, nets, as, c, smem);
    grid.sync();
  }
}

// The dims as the host checks them against its copy of the widths; *sum
// and *kmax get the widths' sum and the widest layer input.
bool dims_ok(const DqnDims& d, const int* widths, long long* sum,
             int* kmax) {
  if (d.obs_dim < 1 || d.batch < 1 || d.k_updates < 1 ||
      d.torso.tab == nullptr || d.q.lay == nullptr ||
      !widths_ok(widths, d.torso.L, 1, sum, kmax,
                 d.obs_dim > kNumActions ? d.obs_dim : kNumActions))
    return false;
  return true;
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
  int kmax;
  dims_ok(d, widths, &sum, &kmax);
  const long long B = d.batch;
  const long long hl = widths[d.torso.L - 1];
  *w = DqnWorkspace{};
  w->zT = take(B * sum);
  w->zN = take(B * sum);
  w->zS = take(B * sum);
  w->hin = take(B * (sum - hl));
  w->dz = take(B * sum);
  w->dy = take(B * sum);
  w->dyxh = take(B * sum);
  w->qT = take(B * kNumActions);
  w->qN = take(B * kNumActions);
  w->qS = take(B * kNumActions);
  w->hlast = take(B * hl);
  w->dq = take(B * kNumActions);
  w->hub = take(B);
  w->dh[0] = take(B * kmax);
  w->dh[1] = take(B * kmax);
  return off;
}

}  // namespace

extern "C" {

// Floats of workspace cp_dqn_update_phase needs for these dims (0 when the
// dims are outside what the kernel takes). widths: the host's copy of the
// torso's widths (dims->torso.L ints).
long long cp_dqn_workspace_floats(const DqnDims* dims, const int* widths) {
  long long sum;
  int kmax;
  if (!dims_ok(*dims, widths, &sum, &kmax)) return 0;
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
  int kmax;
  if (!dims_ok(d, widths, &sum, &kmax))
    return static_cast<int>(cudaErrorInvalidValue);
  DqnWorkspace w;
  carve(d, widths, workspace, &w);
  DqnBatches bt = {obs, rew, nobs, act, done};
  int ldh = row_ld(kmax);
  const size_t smem = smem_bytes(ldh, table_ints(d));
  static int blocks = 0;
  static size_t blocks_smem = 0;
  void* args[] = {&d, &c, &w, &q, &q_t, &m, &v, &bt, &loss, &t0, &ldh};
  return static_cast<int>(launch_cooperative(
      reinterpret_cast<const void*>(dqn_update_kernel), smem, args,
      static_cast<cudaStream_t>(stream), blocks, blocks_smem));
}

}  // extern "C"
