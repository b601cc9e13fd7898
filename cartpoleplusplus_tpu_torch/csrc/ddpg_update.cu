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
// Design: ONE cooperative persistent launch per phase, on the stage engine
// of learner_stages.cuh (shared with B5 and B7): every block walks the same list
// of stages and cg::this_grid().sync() orders them, so the serial
// dependence (stage after stage, critic Adam before the actor pass, update
// k before k + 1) is a loop inside the kernel and the launch count does
// not depend on the number of layers or parameter tensors. Any depth >= 2
// and any width, as the reference's kernel takes: the widths and the
// parameter offsets are a device table, and a row stage walks a layer
// input wider than kKc = 1024 in chunks. Row stages
// multiply 16-row x 32-column tiles through shared memory; gradient stages
// give every gradient element to one thread, which sums it over the batch
// in a fixed order and applies Adam and Polyak (no float atomics, so two
// runs give the same bits). Parameters, targets and moments are updated
// in place in their 8 group buffers; activations, saved pre-LN values and
// gradient rows go to the wrapper's workspace (a few MB at the defaults,
// in L2).
//
// A second design was tried and removed: the phase in one cluster of 16
// CTAs, each running both passes for its own batch rows in shared memory,
// with 4 cluster barriers per update instead of 20 grid barriers. At the
// defaults it was slower than this one on the H100 (PERF.md, Findings):
// its products and batch sums were latency-bound on 16 SMs.
//
// Numerics: the library is built with --fmad=false, so a*b+c is two
// rounded operations, as in the twin. The matrix-product and batch-sum
// inner loops use explicit fmaf() (one rounding, half the instructions);
// every elementwise formula (LayerNorm, Adam, Polyak, the TD target)
// follows the twin operation by operation. The float32 constants (log b,
// gamma, tau, 1/batch, the lr schedule) are folded on the host.
#include "learner_stages.cuh"

// Mirror of ops/_native.py::LearnerDims.
struct LearnerDims {
  int obs_dim, batch, k_updates, merged;
  Torso torso;
  NetLayout actor, critic;
};

namespace {

constexpr int kActDim = 2;

// The workspace: per-layer regions of activations and gradient rows,
// layer l's (batch, H_l) rows at layer_rows(region, l), the layer inputs
// (l >= 1) at input_rows. Carved by carve() on the host.
struct Workspace {
  // critic pass: target actor and target critic on s', critic on (s, a)
  float *zAT, *zCT, *zC;
  float* hinC;   // the critic's layer inputs, the action joined at layer 1
  float *dzC, *dyC, *dyxhC;
  float *aN, *qN, *hlastC, *qC, *td, *dqC;
  // actor pass: actor on s, critic on (s, pi(s))
  float *zA, *hinA, *zQ, *dzA, *dyA, *dyxhA;
  float *hlastA, *aA, *qA, *dqA, *dpreA;
  float* dh[2];  // upstream gradients, ping-pong
};

struct Groups {
  float* g[8];   // actor, critic, actor_t, critic_t, m_a, v_a, m_c, v_c
};

struct Batches {
  const float *obs, *act, *rew, *nobs;
  const bool* done;
};

// Ints of the device table: the widths and their prefix sums, then the
// actor's and the critic's per-layer offsets.
__host__ __device__ inline int table_ints(const LearnerDims& d) {
  return 10 * d.torso.L;
}

__global__ void __launch_bounds__(kThreads) ddpg_update_kernel(
    const LearnerDims d, const LearnerConsts c, const Workspace w,
    const Groups gr, const Batches bt, float* __restrict__ closs,
    float* __restrict__ aloss, const int t0, const int ldh) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  __shared__ Shared sh;
  const bool lead = threadIdx.x == 0;
  const int B = d.batch, F = d.obs_dim;
  int* const tab = reinterpret_cast<int*>(smem + region_floats(ldh));
  const Torso T = stage_table(d.torso, table_ints(d), tab);
  const int nl = T.L;
  const int hl = T.h(nl - 1);
  const NetLayout LA = layout_on(d.actor, d.torso, T);
  const NetLayout LC = layout_on(d.critic, d.torso, T);
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
  auto Z = [&](float* region, int l) { return layer_rows(region, T, l, B); };
  auto H = [&](int l) { return T.h(l); };

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
    // The two networks' gradient lists (lead thread only).
    auto grads_c = [&]() {
      return NetGrads{1, kActDim, 1, 1, c.inv_batch, closs + k, obs, w.dzC,
                      w.dyC, w.dyxhC, w.hinC, w.dqC, w.hlastC, w.td, LC};
    };
    auto grads_a = [&]() {
      return NetGrads{0, 0, kActDim, 0, c.neg_inv_batch, aloss + k, obs,
                      w.dzA, w.dyA, w.dyxhA, w.hinA, w.dpreA, w.hlastA, w.qA,
                      LA};
    };

    // ---- critic pass: y from the targets on s', Q(s, a) and its grads ----
    if (lead) {
      sh.n_rows = 0;
      add_row(fwd_op(nobs, F, kProPlain, nullptr, nullptr, nullptr, 0,
                     AT + LA.w(0), AT + LA.b(0), H(0), Z(w.zAT, 0), nullptr,
                     kEpiNone));
      add_row(fwd_op(nobs, F, kProPlain, nullptr, nullptr, nullptr, 0,
                     CT + LC.w(0), CT + LC.b(0), H(0), Z(w.zCT, 0), nullptr,
                     kEpiNone));
      add_row(fwd_op(obs, F, kProPlain, nullptr, nullptr, nullptr, 0,
                     C + LC.w(0), C + LC.b(0), H(0), Z(w.zC, 0), nullptr,
                     kEpiNone));
    }
    rows_stage();
    for (int l = 1; l < nl; ++l) {
      if (lead) {
        sh.n_rows = 0;
        add_row(fwd_op(Z(w.zAT, l - 1), H(l - 1), kProLnRelu,
                       AT + LA.s(l - 1), AT + LA.t(l - 1), nullptr, 0,
                       AT + LA.w(l), AT + LA.b(l), H(l), Z(w.zAT, l), nullptr,
                       kEpiNone));
        add_row(fwd_op(Z(w.zC, l - 1), H(l - 1), kProLnRelu, C + LC.s(l - 1),
                       C + LC.t(l - 1), l == 1 ? act : nullptr,
                       l == 1 ? kActDim : 0, C + LC.w(l), C + LC.b(l), H(l),
                       Z(w.zC, l), input_rows(w.hinC, T, l, kActDim, B),
                       kEpiNone));
      }
      rows_stage();
    }
    if (lead) {
      sh.n_rows = 0;
      add_row(fwd_op(Z(w.zAT, nl - 1), hl, kProLnRelu, AT + LA.s(nl - 1),
                     AT + LA.t(nl - 1), nullptr, 0, AT + LA.wh, AT + LA.bh,
                     kActDim, w.aN, nullptr, kEpiTanh));
      add_row(fwd_op(Z(w.zC, nl - 1), hl, kProLnRelu, C + LC.s(nl - 1),
                     C + LC.t(nl - 1), nullptr, 0, C + LC.wh, C + LC.bh, 1,
                     w.qC, w.hlastC, kEpiNone));
    }
    rows_stage();
    for (int l = 1; l < nl; ++l) {
      if (lead) {
        sh.n_rows = 0;
        add_row(fwd_op(Z(w.zCT, l - 1), H(l - 1), kProLnRelu,
                       CT + LC.s(l - 1), CT + LC.t(l - 1),
                       l == 1 ? w.aN : nullptr, l == 1 ? kActDim : 0,
                       CT + LC.w(l), CT + LC.b(l), H(l), Z(w.zCT, l), nullptr,
                       kEpiNone));
      }
      rows_stage();
    }
    if (lead) {
      sh.n_rows = 0;
      RowOp op = fwd_op(Z(w.zCT, nl - 1), hl, kProLnRelu, CT + LC.s(nl - 1),
                        CT + LC.t(nl - 1), nullptr, 0, CT + LC.wh, CT + LC.bh,
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
        const int in_w = l == 0 ? F : H(l - 1) + (l == 1 ? kActDim : 0);
        add_row(bwd_op(w.dh[cur], Z(w.zC, l), H(l), C + LC.s(l), C + LC.t(l),
                       Z(w.dzC, l), Z(w.dyC, l), Z(w.dyxhC, l), C + LC.w(l),
                       in_w, 0, l == 0 ? 0 : H(l - 1), w.dh[cur ^ 1]));
      }
      rows_stage();
      cur ^= 1;
    }
    if (!d.merged) {  // critic Adam before the actor pass
      if (lead) {
        sh.nets[0] = grads_c();
        sh.n_nets = 1;
      }
      run_net_grads(sh, T, F, B, nets, as, c, smem);
      grid.sync();
    }

    // ---- actor pass: -mean Q(s, pi(s)) through dQ/da into the actor ----
    if (lead) {
      sh.n_rows = 0;
      add_row(fwd_op(obs, F, kProPlain, nullptr, nullptr, nullptr, 0,
                     A + LA.w(0), A + LA.b(0), H(0), Z(w.zA, 0), nullptr,
                     kEpiNone));
      add_row(fwd_op(obs, F, kProPlain, nullptr, nullptr, nullptr, 0,
                     C + LC.w(0), C + LC.b(0), H(0), Z(w.zQ, 0), nullptr,
                     kEpiNone));
    }
    rows_stage();
    for (int l = 1; l < nl; ++l) {
      if (lead) {
        sh.n_rows = 0;
        add_row(fwd_op(Z(w.zA, l - 1), H(l - 1), kProLnRelu, A + LA.s(l - 1),
                       A + LA.t(l - 1), nullptr, 0, A + LA.w(l), A + LA.b(l),
                       H(l), Z(w.zA, l), input_rows(w.hinA, T, l, 0, B),
                       kEpiNone));
      }
      rows_stage();
    }
    if (lead) {
      sh.n_rows = 0;
      add_row(fwd_op(Z(w.zA, nl - 1), hl, kProLnRelu, A + LA.s(nl - 1),
                     A + LA.t(nl - 1), nullptr, 0, A + LA.wh, A + LA.bh,
                     kActDim, w.aA, w.hlastA, kEpiTanh));
    }
    rows_stage();
    for (int l = 1; l < nl; ++l) {
      if (lead) {
        sh.n_rows = 0;
        add_row(fwd_op(Z(w.zQ, l - 1), H(l - 1), kProLnRelu, C + LC.s(l - 1),
                       C + LC.t(l - 1), l == 1 ? w.aA : nullptr,
                       l == 1 ? kActDim : 0, C + LC.w(l), C + LC.b(l), H(l),
                       Z(w.zQ, l), nullptr, kEpiNone));
      }
      rows_stage();
    }
    if (lead) {
      sh.n_rows = 0;
      RowOp op = fwd_op(Z(w.zQ, nl - 1), hl, kProLnRelu, C + LC.s(nl - 1),
                        C + LC.t(nl - 1), nullptr, 0, C + LC.wh, C + LC.bh, 1,
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
          add_row(bwd_op(w.dh[cur], Z(w.zQ, l), H(l), C + LC.s(l),
                         C + LC.t(l), nullptr, nullptr, nullptr, C + LC.w(l),
                         H(l - 1), 0, H(l - 1), w.dh[cur ^ 1]));
        } else {
          RowOp op = bwd_op(w.dh[cur], Z(w.zQ, 1), H(1), C + LC.s(1),
                            C + LC.t(1), nullptr, nullptr, nullptr,
                            C + LC.w(1), H(0) + kActDim, H(0), kActDim,
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
        const int in_w = l == 0 ? F : H(l - 1);
        add_row(bwd_op(w.dh[cur], Z(w.zA, l), H(l), A + LA.s(l), A + LA.t(l),
                       Z(w.dzA, l), Z(w.dyA, l), Z(w.dyxhA, l), A + LA.w(l),
                       in_w, 0, l == 0 ? 0 : H(l - 1), w.dh[cur ^ 1]));
      }
      rows_stage();
      cur ^= 1;
    }
    if (lead) {
      sh.n_nets = 0;
      if (d.merged) sh.nets[sh.n_nets++] = grads_c();
      sh.nets[sh.n_nets++] = grads_a();
    }
    run_net_grads(sh, T, F, B, nets, as, c, smem);
    grid.sync();
  }
}

// The dims as the host checks them against its copy of the widths; *sum
// and *kmax get the widths' sum and the widest layer input.
bool dims_ok(const LearnerDims& d, const int* widths, long long* sum,
             int* kmax) {
  int widest;
  if (d.obs_dim < 1 || d.batch < 1 || d.k_updates < 1 ||
      d.torso.tab == nullptr || d.actor.lay == nullptr ||
      d.critic.lay == nullptr ||
      !widths_ok(widths, d.torso.L, 2, sum, &widest, 0))
    return false;
  *kmax = widest + kActDim > d.obs_dim ? widest + kActDim : d.obs_dim;
  return true;
}

// Carves the workspace from `base` (or only counts floats when it is null).
long long carve(const LearnerDims& d, const int* widths, float* base,
                Workspace* w) {
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
  const long long ins = sum - hl;   // the layer inputs H_0 .. H_{L-2}
  *w = Workspace{};
  w->zAT = take(B * sum);
  w->zCT = take(B * sum);
  w->zC = take(B * sum);
  w->hinC = take(B * (ins + kActDim));
  w->dzC = take(B * sum);
  w->dyC = take(B * sum);
  w->dyxhC = take(B * sum);
  w->zA = take(B * sum);
  w->hinA = take(B * ins);
  w->zQ = take(B * sum);
  w->dzA = take(B * sum);
  w->dyA = take(B * sum);
  w->dyxhA = take(B * sum);
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
  w->dh[0] = take(B * kmax);
  w->dh[1] = take(B * kmax);
  return off;
}

}  // namespace

extern "C" {

// Floats of workspace cp_ddpg_update_phase needs for these dims (0 when the
// dims are outside what the kernel takes). widths: the host's copy of the
// torso's widths (dims->torso.L ints).
long long cp_ddpg_workspace_floats(const LearnerDims* dims,
                                   const int* widths) {
  long long sum;
  int kmax;
  if (!dims_ok(*dims, widths, &sum, &kmax)) return 0;
  Workspace w;
  return carve(*dims, widths, nullptr, &w);
}

// The K-update phase in one cooperative launch on `stream`. widths: as
// above; dims->torso.tab and the layouts' tables: the device table
// (ops/learner_kernel.py::_learner_table). groups: the 8 group buffers
// (updated in place); batches: obs (K, B, F), act (K, B, 2), rew (K, B),
// nobs (K, B, F), done (K, B) bool; closs/aloss (K,); workspace:
// cp_ddpg_workspace_floats(dims, widths) floats; t0: the Adam count before
// the phase. Returns a cudaError_t.
int cp_ddpg_update_phase(const LearnerDims* dims, const int* widths,
                         const LearnerConsts* consts, float* actor,
                         float* critic, float* actor_t, float* critic_t,
                         float* m_a, float* v_a, float* m_c, float* v_c,
                         const float* obs, const float* act, const float* rew,
                         const float* nobs, const bool* done, float* closs,
                         float* aloss, float* workspace, int t0,
                         void* stream) {
  LearnerDims d = *dims;
  LearnerConsts c = *consts;
  long long sum;
  int kmax;
  if (!dims_ok(d, widths, &sum, &kmax))
    return static_cast<int>(cudaErrorInvalidValue);
  Workspace w;
  carve(d, widths, workspace, &w);
  Groups gr = {{actor, critic, actor_t, critic_t, m_a, v_a, m_c, v_c}};
  Batches bt = {obs, act, rew, nobs, done};
  int ldh = row_ld(kmax);
  const size_t smem = smem_bytes(ldh, table_ints(d));

  static int blocks = 0;
  static size_t blocks_smem = 0;
  void* args[] = {&d, &c, &w, &gr, &bt, &closs, &aloss, &t0, &ldh};
  return static_cast<int>(launch_cooperative(
      reinterpret_cast<const void*>(ddpg_update_kernel), smem, args,
      static_cast<cudaStream_t>(stream), blocks, blocks_smem));
}

}  // extern "C"
