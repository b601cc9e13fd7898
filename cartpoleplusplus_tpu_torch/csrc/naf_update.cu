// Kernel B7: the whole K-update NAF learner phase, on Hopper.
//
// Replaces cartpoleplusplus_tpu/ops/learner_kernel.py::_naf_update_kernel
// (the Pallas TPU kernel, made by naf_update_phase). NafNet is a torso with
// one packed 6-row head [v, mu0, mu1, l0, l1, l2]. Per update k, on the
// presampled minibatch k: the target net on s' (its row v only) gives
// y = r + gamma (1 - done) V'(s'); the online net on s gives the head's
// pre-activations, from which
//   L = [[softplus(l0), 0], [l1, softplus(l2)]],  u = L^T (a - mu),
//   Q = v - |u|^2 / 2
// (mu is the head's raw rows 1-2, as in the reference kernel); the MSE TD
// gradient 2 (Q - y) / B flows back through that algebra and the net; the
// gradient is clipped to a global norm (optax.clip_by_global_norm, when
// max_norm > 0); Adam at the linear lr schedule keyed on the Adam count;
// Polyak on the target. The plain twin is
// ops/learner_kernel.py::naf_update_phase_math.
//
// Bound on the H100: as B3 and B5, the latency of a chain of small
// dependent stages, not arithmetic (~0.1 GFLOP of matrix products per
// update at batch 256, obs 42, hidden (256, 256)). Design: B5's, on the
// same stage engine (learner_stages.cuh): one cooperative persistent launch
// per phase, every block walking the same stage list between grid
// barriers. An update is L forward stages that run the target (on s') and
// the online net (on s) in lockstep, the two heads (the target's 1 row, the
// online net's 6), the NAF epilogue (one batch row per thread), the head
// backward, L LayerNorm-backward stages, and the gradient stage: 2L + 4
// stages. Under the clip the gradient stage only stores the flat gradient,
// and two more stages follow: the partial sums of its squares over fixed
// slices, then the scale and Adam and Polyak per element (2L + 6, 10 at two
// hidden layers). No float atomics: two runs give the same bits. Any depth
// >= 1 and any width, as the reference's kernel takes (learner_stages.cuh:
// device tables of the widths and offsets, chunked row stages).
#include "learner_stages.cuh"

// Mirror of ops/_native.py::NafDims.
struct NafDims {
  int obs_dim, batch, k_updates;
  float max_norm;  // the gradient's global-norm clip; 0 = none
  Torso torso;
  NetLayout q;
};

namespace {

constexpr int kHead = 6;  // ops/learner_kernel.py::NAF_HEAD

// The workspace: per-layer regions of activations and gradient rows,
// layer l's (batch, H_l) rows at layer_rows(region, l), the layer inputs
// (l >= 1) at input_rows, and the flat gradient of a clipped update.
// Carved by carve() on the host.
struct NafWorkspace {
  float* zT;    // target net on s' (pre-LN)
  float* zS;    // online net on s
  float* hin;   // its layer inputs (l >= 1) for the weight grads
  float *dz, *dy, *dyxh;
  float *vT, *pre, *hlast, *dpre, *td;
  float* dh[2];             // upstream gradients, ping-pong
  float* grad;              // the flat gradient, in the group layout
  float* parts;             // kNormParts partial sums of its squares
};

struct NafBatches {
  const float *obs, *act, *rew, *nobs;
  const bool* done;
};

// jax.nn.softplus's stable form and the logistic, as the twin computes
// them (accurate expf/log1pf, IEEE divide).
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The NAF epilogue, one batch row per thread: the TD target from the
// target's V, Q from the online head (naf_q), the row's TD error for the
// loss, and d loss / d head = naf_q_bwd(2 (Q - y) / B) (B, 6).
__device__ void naf_rows(const NafWorkspace& w, const NafBatches& bt, int k,
                         int B, const LearnerConsts& c) {
  for (int b = blockIdx.x * kThreads + threadIdx.x; b < B;
       b += gridDim.x * kThreads) {
    const size_t r = static_cast<size_t>(k) * B + b;
    const float* pre = w.pre + static_cast<size_t>(b) * kHead;
    const float notdone = 1.0f - (bt.done[r] ? 1.0f : 0.0f);
    const float y = bt.rew[r] + (c.gamma * notdone) * w.vT[b];
    const float da0 = bt.act[2 * r] - pre[1];
    const float da1 = bt.act[2 * r + 1] - pre[2];
    const float l0 = pre[3], l1 = pre[4], l2 = pre[5];
    const float l00 = softplus(l0), l11 = softplus(l2);
    const float u0 = l00 * da0 + l1 * da1;
    const float u1 = l11 * da1;
    const float td = (pre[0] - 0.5f * (u0 * u0 + u1 * u1)) - y;
    w.td[b] = td;
    const float dq = c.two_inv_batch * td;
    const float du0 = -dq * u0;
    const float du1 = -dq * u1;
    const float dda0 = du0 * l00;
    const float dda1 = du0 * l1 + du1 * l11;
    float* d = w.dpre + static_cast<size_t>(b) * kHead;
    d[0] = dq;
    d[1] = -dda0;
    d[2] = -dda1;
    d[3] = (du0 * da0) * sigmoid(l0);
    d[4] = du0 * da1;
    d[5] = (du1 * da1) * sigmoid(l2);
  }
}

// Ints of the device table: the widths and their prefix sums, then the
// net's per-layer offsets.
__host__ __device__ inline int table_ints(const NafDims& d) {
  return 6 * d.torso.L;
}

__global__ void __launch_bounds__(kThreads) naf_update_kernel(
    const NafDims d, const LearnerConsts c, const NafWorkspace w,
    float* __restrict__ qp, float* __restrict__ qtp, float* __restrict__ m,
    float* __restrict__ v, const NafBatches bt, float* __restrict__ loss,
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
  const bool clip = d.max_norm > 0.0f;

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
    const float frac =
        c.sched ? fminf((tk - 1.0f) / c.sched_steps, 1.0f) : 0.0f;
    as.lr[0] = as.lr[1] =
        c.sched ? c.actor_lr + frac * c.actor_lr_delta : c.actor_lr;

    // ---- forward: the target on s', the online net on s ----
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
        add_row(fwd_op(first ? obs : Z(w.zS, l - 1), kx, pro,
                       first ? nullptr : Q + L.s(l - 1),
                       first ? nullptr : Q + L.t(l - 1), nullptr, 0,
                       Q + L.w(l), Q + L.b(l), h, Z(w.zS, l),
                       first ? nullptr : input_rows(w.hin, T, l, 0, B),
                       kEpiNone));
      }
      rows_stage();
    }
    if (lead) {  // the target's V row, the online net's 6 rows
      sh.n_rows = 0;
      add_row(fwd_op(Z(w.zT, nl - 1), hl, kProLnRelu, QT + L.s(nl - 1),
                     QT + L.t(nl - 1), nullptr, 0, QT + L.wh, QT + L.bh, 1,
                     w.vT, nullptr, kEpiNone));
      add_row(fwd_op(Z(w.zS, nl - 1), hl, kProLnRelu, Q + L.s(nl - 1),
                     Q + L.t(nl - 1), nullptr, 0, Q + L.wh, Q + L.bh, kHead,
                     w.pre, w.hlast, kEpiNone));
    }
    rows_stage();
    naf_rows(w, bt, k, B, c);
    grid.sync();

    // ---- backward through the online net on s ----
    if (lead) {
      sh.n_rows = 0;
      add_row(bwd_op(w.dpre, nullptr, kHead, nullptr, nullptr, nullptr,
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

    // ---- every gradient element (clip), Adam, Polyak; the loss ----
    if (lead) {
      sh.nets[0] = NetGrads{0, 0, kHead, 1, c.inv_batch, loss + k, obs,
                            w.dz, w.dy, w.dyxh, w.hin, w.dpre, w.hlast, w.td,
                            L};
      sh.n_nets = 1;
    }
    if (clip) {
      run_net_grads<true>(sh, T, F, B, nets, as, c, smem, w.grad);
      grid.sync();
      norm_partials(w.grad, L.size, w.parts, smem);
      grid.sync();
      adam_flat(w.grad, L.size, w.parts, d.max_norm, nets[0], as, as.lr[0],
                c, smem);
    } else {
      run_net_grads(sh, T, F, B, nets, as, c, smem);
    }
    grid.sync();
  }
}

// The dims as the host checks them against its copy of the widths; *sum
// and *kmax get the widths' sum and the widest layer input.
bool dims_ok(const NafDims& d, const int* widths, long long* sum,
             int* kmax) {
  return d.obs_dim >= 1 && d.batch >= 1 && d.k_updates >= 1 &&
         d.max_norm >= 0.0f && d.q.size >= 1 && d.torso.tab != nullptr &&
         d.q.lay != nullptr &&
         widths_ok(widths, d.torso.L, 1, sum, kmax,
                   d.obs_dim > kHead ? d.obs_dim : kHead);
}

// Carves the workspace from `base` (or only counts floats when it is null).
long long carve(const NafDims& d, const int* widths, float* base,
                NafWorkspace* w) {
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
  *w = NafWorkspace{};
  w->zT = take(B * sum);
  w->zS = take(B * sum);
  w->hin = take(B * (sum - hl));
  w->dz = take(B * sum);
  w->dy = take(B * sum);
  w->dyxh = take(B * sum);
  w->vT = take(B);
  w->pre = take(B * kHead);
  w->hlast = take(B * hl);
  w->dpre = take(B * kHead);
  w->td = take(B);
  w->dh[0] = take(B * kmax);
  w->dh[1] = take(B * kmax);
  w->grad = take(d.q.size);
  w->parts = take(kNormParts);
  return off;
}

}  // namespace

extern "C" {

// Floats of workspace cp_naf_update_phase needs for these dims (0 when the
// dims are outside what the kernel takes). widths: the host's copy of the
// torso's widths (dims->torso.L ints).
long long cp_naf_workspace_floats(const NafDims* dims, const int* widths) {
  long long sum;
  int kmax;
  if (!dims_ok(*dims, widths, &sum, &kmax)) return 0;
  NafWorkspace w;
  return carve(*dims, widths, nullptr, &w);
}

// The K-update phase in one cooperative launch on `stream`. widths: as
// above; dims->torso.tab and dims->q.lay: the device table
// (ops/learner_kernel.py::_learner_table). q, q_t, m, v: the 4 group
// buffers (updated in place); batches: obs (K, B, F), act (K, B, 2), rew
// (K, B), nobs (K, B, F), done (K, B) bool; loss (K,); workspace:
// cp_naf_workspace_floats(dims, widths) floats; t0: the Adam count before
// the phase. Returns a cudaError_t.
int cp_naf_update_phase(const NafDims* dims, const int* widths,
                        const LearnerConsts* consts, float* q, float* q_t,
                        float* m, float* v, const float* obs,
                        const float* act, const float* rew, const float* nobs,
                        const bool* done, float* loss, float* workspace,
                        int t0, void* stream) {
  NafDims d = *dims;
  LearnerConsts c = *consts;
  long long sum;
  int kmax;
  if (!dims_ok(d, widths, &sum, &kmax))
    return static_cast<int>(cudaErrorInvalidValue);
  NafWorkspace w;
  carve(d, widths, workspace, &w);
  NafBatches bt = {obs, act, rew, nobs, done};
  int ldh = row_ld(kmax);
  const size_t smem = smem_bytes(ldh, table_ints(d));
  static int blocks = 0;
  static size_t blocks_smem = 0;
  void* args[] = {&d, &c, &w, &q, &q_t, &m, &v, &bt, &loss, &t0, &ldh};
  return static_cast<int>(launch_cooperative(
      reinterpret_cast<const void*>(naf_update_kernel), smem, args,
      static_cast<cudaStream_t>(stream), blocks, blocks_smem));
}

}  // extern "C"
