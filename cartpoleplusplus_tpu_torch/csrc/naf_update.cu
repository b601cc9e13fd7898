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
// dependent steps, not arithmetic (~0.1 GFLOP of matrix products per
// update at batch 256, obs 42, hidden (256, 256)). Design: B5's, on the row
// chains of row_chain.cuh: one cooperative persistent launch per phase;
// per update three stages of independent items with a grid barrier after
// each, and under the clip a fourth:
//   * Forward: an item is one pass over a tile of kRowsN = 4 batch rows
//     through every layer and the head: the target net on s' (its head row
//     v only) or the online net on s (all 6 rows; it keeps its pre-LN rows,
//     layer inputs and head rows in the workspace).
//   * Backward: an item is a tile of kRowsB = 4 rows: the NAF epilogue
//     (naf_row), the head backward, and per layer the LayerNorm/relu
//     backward and dh = dz W.
//   * Gradients: every weight gradient in 32 x 32 tiles, the bias and
//     LayerNorm gradients and the loss; Adam and Polyak on each element.
//     Under the clip the stage stores the flat gradient and sums the
//     squares of its kNormParts fixed slices as they complete; after a
//     barrier, adam_flat sums the partials in order, scales and applies
//     Adam and Polyak.
// 3 grid barriers per update without the clip, 4 with it, at any depth.
// Every sum keeps the order of the earlier stage-engine design (2L + 6
// grid-synced stages per update; row_chain.cuh), so B7 gives its bits. No
// float atomics: two runs give the same bits. Any depth >= 1 and any
// width, as the reference's kernel takes; where an
// item's buffers do not fit in shared memory beside the ring (a layer wider
// than 2449 at obs 42) they live in the item's slice of the workspace.
#include "row_chain.cuh"

// Mirror of ops/_native.py::NafDims.
struct NafDims {
  int obs_dim, batch, k_updates;
  float max_norm;  // the gradient's global-norm clip; 0 = none
  Torso torso;
  NetLayout q;
  int spill;       // 1: the items' buffers in the workspace at any width
};

namespace {

constexpr int kHead = 6;  // ops/learner_kernel.py::NAF_HEAD
static_assert(kHead <= kQLd, "a head row in a row of d loss / d head");
// Batch rows of a forward item: 4 (not row_chain.cuh's 8), so that the
// target's and the online net's passes give the card 128 items at batch
// 256 (64 at 8 rows).
constexpr int kRowsN = 4;
constexpr int kLdN = kRowsN + 4;  // feature stride of its activations

// The workspace: per-layer regions of the rows the gradient stage reads
// (layer l's (batch, H_l) rows at layer_rows(region, l), the layer inputs
// l >= 1 at input_rows), the online net's pre-LN z on s, the target's V,
// the head rows and their gradients, the flat gradient of a clipped update
// with its slices' partial sums and counts and, on the spill route, every
// item's buffers. Carved by carve() on the host.
struct NafWorkspace {
  float* zS;    // online net on s (pre-LN)
  float* hin;   // its layer inputs (l >= 1) for the weight grads
  float *dz, *dy, *dyxh;
  float *vT, *pre, *hlast, *dpre, *td;
  float* grad;              // the flat gradient, in the group layout
  float* parts;             // kNormParts partial sums of its squares
  int* cnt;                 // kNormParts counts of its stored elements
  float* tiles;
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

// The NAF epilogue of batch row b: the TD target from the target's V, Q
// from the online head (naf_q), the row's TD error for the loss, and d
// loss / d head = naf_q_bwd(2 (Q - y) / B) into w.dpre and d (6 floats).
__device__ void naf_row(const NafWorkspace& w, const NafBatches& bt, int k,
                        int B, int b, const LearnerConsts& c, float* d) {
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
  d[0] = dq;
  d[1] = -dda0;
  d[2] = -dda1;
  d[3] = (du0 * da0) * sigmoid(l0);
  d[4] = du0 * da1;
  d[5] = (du1 * da1) * sigmoid(l2);
  float* const g = w.dpre + static_cast<size_t>(b) * kHead;
  for (int i = 0; i < kHead; ++i) g[i] = d[i];
}

// Ints of the device table: the widths and their prefix sums, then the
// net's per-layer offsets.
__host__ __device__ inline int table_ints(const NafDims& d) {
  return 6 * d.torso.L;
}

// Forward item: pass p (0: the target on s', head row v into w.vT; 1: the
// online net on s, its 6 head rows into w.pre, its pre-LN rows and layer
// inputs kept) over the kRowsN rows from b0.
__device__ void fwd_item(const NafDims& d, const LearnerConsts& c,
                         const NafWorkspace& w, const RowPlan& rp,
                         const Torso& T, const NetLayout& L, const float* net,
                         const NafBatches& bt, int k, int b0, int p,
                         float* smem, float* bufs) {
  const int B = d.batch, F = d.obs_dim;
  const int nr = min(kRowsN, B - b0);
  float* const act = bufs;                    // (wmax, kLdN)
  float* const zr = bufs + kLdN * rp.wmax;    // (kRowsN, ldz)
  const size_t kb = static_cast<size_t>(k) * B;

  __syncthreads();  // the last item is done with the buffers
  load_rows<kRowsN>((p == 0 ? bt.nobs : bt.obs) + kb * F, F, b0, nr, act);
  const FwdSave sv = p == 1 ? FwdSave{w.zS, w.hin, w.hlast, 0} : FwdSave{};
  torso_fwd<kRowsN>(T, L, net, F, nullptr, 0, act, zr, rp.ldz, smem, c, sv,
                    b0, nr, B);
  const int hl = T.h(T.L - 1);
  if (p == 0) {
    head_fwd<kRowsN>(net + L.wh, net + L.bh, 1, hl, act, smem,
                     [&](int r, int, float v) {
                       if (r < nr) w.vT[b0 + r] = v;
                     });
  } else {
    float* const pre = w.pre + static_cast<size_t>(b0) * kHead;
    head_fwd<kRowsN>(net + L.wh, net + L.bh, kHead, hl, act, smem,
                     [&](int r, int a, float v) {
                       if (r < nr) pre[r * kHead + a] = v;
                     });
  }
  CP_MARK(3);  // the forward item
}

// Backward item: the kRowsB rows from b0: the NAF epilogue, the head
// backward, and per layer the LayerNorm/relu backward and dh = dz W;
// writes dz, dy, dy * xhat, d loss / d head and the TD errors.
__device__ void bwd_item(const NafDims& d, const LearnerConsts& c,
                         const NafWorkspace& w, const RowPlan& rp,
                         const Torso& T, const NetLayout& L, const float* Q,
                         const NafBatches& bt, int k, int b0, float* smem,
                         float* bufs) {
  const int tid = threadIdx.x;
  const int B = d.batch, hl = T.h(T.L - 1);
  const int ldz = rp.ldz, nr = min(kRowsB, B - b0);
  float* const ring = smem;
  float* const dqs = smem + kRing;          // (kRowsB, kQLd) d loss / d head
  float* const dh = bufs;                   // (kRowsB, ldz)
  float* const dzs = bufs + kRowsB * ldz;   // (hmax, kLdB)

  __syncthreads();  // the last item is done with the buffers
  if (tid < kRowsB) {  // the NAF epilogue, one row a thread
    float* const dqr = dqs + tid * kQLd;
    if (tid < nr) {
      naf_row(w, bt, k, B, b0 + tid, c, dqr);
    } else {
      for (int a = 0; a < kHead; ++a) dqr[a] = 0.0f;
    }
  }
  __syncthreads();
  head_bwd(dqs, kHead, Q + L.wh, hl, dh, ldz);
  torso_bwd(T, L, Q, 0, w.zS, dh, dzs, ldz, ring, c,
            BwdSave{w.dz, w.dy, w.dyxh}, b0, nr, B, 0, nullptr);
  CP_MARK(4);  // the backward item
}

__global__ void __launch_bounds__(kThreads, 1) naf_update_kernel(
    const NafDims d, const LearnerConsts c, const NafWorkspace w,
    float* __restrict__ qp, float* __restrict__ qtp, float* __restrict__ m,
    float* __restrict__ v, const NafBatches bt, float* __restrict__ loss,
    const int t0, const RowPlan rp) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int B = d.batch, F = d.obs_dim;
  int* const tab = reinterpret_cast<int*>(smem + rp.region);
  const Torso T = stage_table(d.torso, table_ints(d), tab);
  const NetLayout L = layout_on(d.q, d.torso, T);
  const NetPtr nets[1] = {{qp, qtp, m, v}};
  const bool clip = d.max_norm > 0.0f;
  const int tiles_f = (B + kRowsN - 1) / kRowsN;
  const int tiles_b = (B + kRowsB - 1) / kRowsB;
  auto bufs_of = [&](int item) {
    return rp.spill ? w.tiles + rp.tile_floats * item : smem + kFixed;
  };
  if (clip && blockIdx.x == 0) {  // the slices' counts start at zero
    for (int i = threadIdx.x; i < kNormParts; i += kThreads) {
      w.cnt[i] = 0;
      w.parts[i] = 0.0f;
    }
  }

  for (int k = 0; k < d.k_updates; ++k) {
    const float tk = static_cast<float>(t0 + k + 1);
    AdamStep as;
    as.bc1 = 1.0f - expf(tk * c.log_b1);
    as.bc2 = 1.0f - expf(tk * c.log_b2);
    const float frac =
        c.sched ? fminf((tk - 1.0f) / c.sched_steps, 1.0f) : 0.0f;
    as.lr[0] = as.lr[1] =
        c.sched ? c.actor_lr + frac * c.actor_lr_delta : c.actor_lr;

    // Forward items: (pass, tile), the target's passes first.
    for (int item = blockIdx.x; item < 2 * tiles_f; item += gridDim.x) {
      const int p = item / tiles_f;
      fwd_item(d, c, w, rp, T, L, p == 0 ? qtp : qp, bt, k,
               (item % tiles_f) * kRowsN, p, smem, bufs_of(item));
    }
    grid.sync();
    for (int item = blockIdx.x; item < tiles_b; item += gridDim.x)
      bwd_item(d, c, w, rp, T, L, qp, bt, k, item * kRowsB, smem,
               bufs_of(item));
    grid.sync();
    // ---- every gradient element (clip), Adam, Polyak; the loss ----
    const NetGrads ng{0, 0, kHead, 1, c.inv_batch, loss + k,
                      bt.obs + static_cast<size_t>(k) * B * F, w.dz, w.dy,
                      w.dyxh, w.hin, w.dpre, w.hlast, w.td, L};
    if (clip) {
      grad_stage<true>(&ng, 1, T, F, B, nets, as, c, smem,
                       FlatStore{w.grad, w.parts, w.cnt, L.size, k});
      grid.sync();
      adam_flat(w.grad, L.size, w.parts, d.max_norm, nets[0], as, as.lr[0],
                c, smem);
    } else {
      grad_stage<false>(&ng, 1, T, F, B, nets, as, c, smem, FlatStore{});
    }
    grid.sync();
  }
}

// The dims as the host checks them against its copy of the widths; *sum
// and *hmax get the widths' sum and max.
bool dims_ok(const NafDims& d, const int* widths, long long* sum,
             int* hmax) {
  return d.obs_dim >= 1 && d.batch >= 1 && d.k_updates >= 1 &&
         d.max_norm >= 0.0f && d.q.size >= 1 &&
         (d.spill == 0 || d.spill == 1) && d.torso.tab != nullptr &&
         d.q.lay != nullptr && widths_ok(widths, d.torso.L, 1, sum, hmax, 0);
}

// The items' plan: the spill route when d.spill asks for it or an item's
// buffers do not fit in shared memory beside the ring and the table.
RowPlan naf_row_plan(const NafDims& d, int hmax) {
  return row_plan(d.obs_dim, hmax, table_ints(d), d.spill, kRowsN, 0, 0);
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
  int hmax;
  dims_ok(d, widths, &sum, &hmax);
  const RowPlan rp = naf_row_plan(d, hmax);
  const long long B = d.batch;
  const long long hl = widths[d.torso.L - 1];
  const long long tiles_f = (B + kRowsN - 1) / kRowsN;
  const long long tiles_b = (B + kRowsB - 1) / kRowsB;
  const long long items = 2 * tiles_f > tiles_b ? 2 * tiles_f : tiles_b;
  *w = NafWorkspace{};
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
  w->grad = take(d.q.size);
  w->parts = take(kNormParts);
  w->cnt = reinterpret_cast<int*>(take(kNormParts));
  w->tiles = rp.spill ? take(items * rp.tile_floats) : nullptr;
  return off;
}

}  // namespace

extern "C" {

// Floats of workspace cp_naf_update_phase needs for these dims (0 when the
// dims are outside what the kernel takes). widths: the host's copy of the
// torso's widths (dims->torso.L ints).
long long cp_naf_workspace_floats(const NafDims* dims, const int* widths) {
  long long sum;
  int hmax;
  if (!dims_ok(*dims, widths, &sum, &hmax)) return 0;
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
  int hmax;
  if (!dims_ok(d, widths, &sum, &hmax))
    return static_cast<int>(cudaErrorInvalidValue);
  NafWorkspace w;
  carve(d, widths, workspace, &w);
  NafBatches bt = {obs, act, rew, nobs, done};
  RowPlan rp = naf_row_plan(d, hmax);
  const size_t smem = plan_smem(rp, table_ints(d));
  static int blocks = 0;
  static size_t blocks_smem = 0;
  void* args[] = {&d, &c, &w, &q, &q_t, &m, &v, &bt, &loss, &t0, &rp};
  return static_cast<int>(launch_cooperative(
      reinterpret_cast<const void*>(naf_update_kernel), smem, args,
      static_cast<cudaStream_t>(stream), blocks, blocks_smem));
}

}  // extern "C"
