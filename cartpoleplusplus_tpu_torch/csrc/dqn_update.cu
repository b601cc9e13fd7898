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
// Bound on the H100: ~95 MFLOP of matrix products per update at batch 256,
// obs 42, hidden (256, 256) (~2.9 us at 67 TFLOP/s), but the update is a
// chain of dependent steps: on an earlier stage-engine design each step was
// a grid-synced stage, 2L + 4 per update, and the work between the
// barriers, not the barriers, took the time (chip_smoke.py's stage split).
// Here a block takes a whole row-local chain, and the products are bound
// by shared-memory loads (a thread's loads serve kCols columns).
//
// Design: one cooperative persistent launch per phase on the row chains of
// row_chain.cuh (shared with B3 and B7); per update three stages, each a
// list of independent items dealt to the blocks, with a grid barrier after
// each (3 per update at any depth):
//   * Forward: an item is one pass (online on s, online on s', target on
//     s') over a tile of kRowsF = 8 batch rows, through every layer and
//     the head (96 items at batch 256). The online net on s keeps its
//     pre-LN rows and layer inputs in the workspace; every pass writes its
//     Q values there.
//   * Backward: an item is a tile of kRowsB = 4 rows (64 items): the TD
//     epilogue, the head backward, and per layer the LayerNorm/relu
//     backward and dh = dz W; it writes dz, dy and dy * xhat per layer and
//     the head's upstream gradient and Huber terms.
//   * Gradients: every weight gradient in 32 x 32 tiles, the bias and
//     LayerNorm gradients and the loss; Adam and Polyak on each element.
// Where an item's buffers do not fit in shared memory beside the ring
// (a layer wider than 1468 at obs 42), they live in the item's slice of
// the workspace: the same code with other pointers. Every sum keeps the
// stage-engine design's order (row_chain.cuh), so B5 gives that design's
// bits. No float atomics: two runs give the same bits. Any depth >= 1 and
// any width, as the reference's kernel takes (the widths and offsets are
// the learners' device table).
#include "row_chain.cuh"

// Mirror of ops/_native.py::DqnDims.
struct DqnDims {
  int obs_dim, batch, k_updates, double_dqn;
  Torso torso;
  NetLayout q;
  int spill;  // 1: the items' buffers in the workspace at any width
};

namespace {

constexpr int kNumActions = 5;  // ops/learner_kernel.py::NUM_ACTIONS
constexpr int kPasses = 3;      // online on s, online on s', target on s'

// The workspace: per-layer regions of the rows the gradient stage reads
// (layer l's (batch, H_l) rows at layer_rows(region, l), the layer inputs
// l >= 1 at input_rows), the pre-LN z of the online net on s, the three
// passes' Q values and, on the spill route, every item's buffers. Carved
// by carve() on the host.
struct DqnWorkspace {
  float* zS;    // pre-LN z of the online net on s
  float* hin;   // its layer inputs (l >= 1)
  float *dz, *dy, *dyxh;
  float *hlast, *dq, *hub;
  float* qv;    // (3, batch, 5) Q values by pass
  float* tiles;
};

struct DqnBatches {
  const float *obs, *rew, *nobs;
  const int* act;
  const bool* done;
};

// Ints of the device table: the widths and their prefix sums, then the
// net's per-layer offsets.
__host__ __device__ inline int table_ints(const DqnDims& d) {
  return 6 * d.torso.L;
}

// Forward item: pass p over the kRowsF rows from b0 through every layer
// and the head; Q values to w.qv, and for pass 0 the pre-LN rows and the
// layer inputs to the workspace.
__device__ void fwd_item(const DqnDims& d, const LearnerConsts& c,
                         const DqnWorkspace& w, const RowPlan& rp,
                         const Torso& T, const NetLayout& L, const float* net,
                         const DqnBatches& bt, int k, int b0, int p,
                         float* smem, float* bufs) {
  const int B = d.batch, F = d.obs_dim;
  const int nr = min(kRowsF, B - b0);
  float* const act = bufs;                    // (wmax, kLdF)
  float* const zr = bufs + kLdF * rp.wmax;    // (kRowsF, ldz)
  const size_t kb = static_cast<size_t>(k) * B;

  __syncthreads();  // the last item is done with the buffers
  load_rows<kRowsF>((p == 0 ? bt.obs : bt.nobs) + kb * F, F, b0, nr, act);
  CP_MARK(3);  // the item's inputs
  const FwdSave sv = p == 0 ? FwdSave{w.zS, w.hin, w.hlast, 0} : FwdSave{};
  torso_fwd<kRowsF>(T, L, net, F, nullptr, 0, act, zr, rp.ldz, smem, c, sv,
                    b0, nr, B);
  CP_MARK(4);  // the torso
  float* const qv = w.qv + (static_cast<size_t>(p) * B + b0) * kNumActions;
  head_fwd<kRowsF>(net + L.wh, net + L.bh, kNumActions, T.h(T.L - 1), act,
                   smem, [&](int r, int a, float v) {
                     if (r < nr) qv[r * kNumActions + a] = v;
                   });
  CP_MARK(5);  // the head
}

// Backward item: the kRowsB rows from b0: the TD epilogue, the head
// backward, and per layer the LayerNorm/relu backward and dh = dz W;
// writes dz, dy, dy * xhat, d loss / dQ and the Huber terms.
__device__ void bwd_item(const DqnDims& d, const LearnerConsts& c,
                         const DqnWorkspace& w, const RowPlan& rp,
                         const Torso& T, const NetLayout& L, const float* Q,
                         const DqnBatches& bt, int k, int b0, float* smem,
                         float* bufs) {
  const int tid = threadIdx.x;
  const int B = d.batch, hl = T.h(T.L - 1);
  const int ldz = rp.ldz, nr = min(kRowsB, B - b0);
  float* const ring = smem;
  float* const dqs = smem + kRing;          // (kRowsB, kQLd) d loss / dQ
  float* const dh = bufs;                   // (kRowsB, ldz)
  float* const dzs = bufs + kRowsB * ldz;   // (hmax, kLdB)
  const size_t kb = static_cast<size_t>(k) * B;

  __syncthreads();  // the last item is done with the buffers
  // ---- the TD epilogue, one row a thread: the first-max argmax of the
  // selector (the online net on s' under double DQN, else the target;
  // a strict >, jnp.argmax's tie rule), the target y, the Huber-clipped
  // gradient at the taken action and the row's Huber term ----
  if (tid < kRowsB) {
    const int r = tid;
    float* dqr = dqs + r * kQLd;
    if (r < nr) {
      const size_t b = static_cast<size_t>(b0 + r);
      const float* qs = w.qv + b * kNumActions;
      const float* qt = w.qv + (2 * static_cast<size_t>(B) + b) * kNumActions;
      const float* sel =
          d.double_dqn ? w.qv + (static_cast<size_t>(B) + b) * kNumActions
                       : qt;
      int first = 0;
      float best = sel[0];
      for (int a = 1; a < kNumActions; ++a) {
        if (sel[a] > best) {
          best = sel[a];
          first = a;
        }
      }
      const float notdone = 1.0f - (bt.done[kb + b] ? 1.0f : 0.0f);
      const float y = bt.rew[kb + b] + (c.gamma * notdone) * qt[first];
      const int ar = bt.act[kb + b];
      const float td = qs[ar] - y;
      const float g = fminf(fmaxf(td, -1.0f), 1.0f) * c.inv_batch;
      for (int a = 0; a < kNumActions; ++a) {
        dqr[a] = a == ar ? g : 0.0f;
        w.dq[b * kNumActions + a] = dqr[a];
      }
      const float abs_td = fabsf(td);
      w.hub[b] = abs_td <= 1.0f ? 0.5f * td * td : 1.0f * (abs_td - 0.5f);
    } else {
      for (int a = 0; a < kNumActions; ++a) dqr[a] = 0.0f;
    }
  }
  __syncthreads();

  // ---- the head, then each layer ----
  head_bwd(dqs, kNumActions, Q + L.wh, hl, dh, ldz);
  torso_bwd(T, L, Q, 0, w.zS, dh, dzs, ldz, ring, c,
            BwdSave{w.dz, w.dy, w.dyxh}, b0, nr, B, 0, nullptr);
  CP_MARK(6);  // the backward
}

__global__ void __launch_bounds__(kThreads, 1) dqn_update_kernel(
    const DqnDims d, const LearnerConsts c, const DqnWorkspace w,
    float* __restrict__ qp, float* __restrict__ qtp, float* __restrict__ m,
    float* __restrict__ v, const DqnBatches bt, float* __restrict__ loss,
    const int t0, const RowPlan rp) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int B = d.batch, F = d.obs_dim;
  int* const tab = reinterpret_cast<int*>(smem + rp.region);
  const Torso T = stage_table(d.torso, table_ints(d), tab);
  const NetLayout L = layout_on(d.q, d.torso, T);
  const NetPtr nets[1] = {{qp, qtp, m, v}};
  const int tiles_f = (B + kRowsF - 1) / kRowsF;
  const int tiles_b = (B + kRowsB - 1) / kRowsB;
  auto bufs_of = [&](int item) {
    return rp.spill ? w.tiles + rp.tile_floats * item : smem + kFixed;
  };

  for (int k = 0; k < d.k_updates; ++k) {
    const float tk = static_cast<float>(t0 + k + 1);
    AdamStep as;
    as.bc1 = 1.0f - expf(tk * c.log_b1);
    as.bc2 = 1.0f - expf(tk * c.log_b2);
    as.lr[0] = as.lr[1] = c.actor_lr;

    // Forward items: (pass, tile); pass 1 under double DQN only.
    const int n_f = (d.double_dqn ? 3 : 2) * tiles_f;
    for (int item = blockIdx.x; item < n_f; item += gridDim.x) {
      int p = item / tiles_f;
      if (p == 1 && !d.double_dqn) p = 2;
      fwd_item(d, c, w, rp, T, L, p == 2 ? qtp : qp, bt, k,
               (item % tiles_f) * kRowsF, p, smem, bufs_of(item));
    }
    grid.sync();
    for (int item = blockIdx.x; item < tiles_b; item += gridDim.x)
      bwd_item(d, c, w, rp, T, L, qp, bt, k, item * kRowsB, smem,
               bufs_of(item));
    grid.sync();
    const NetGrads ng{0, 0, kNumActions, 0, c.inv_batch, loss + k,
                      bt.obs + static_cast<size_t>(k) * B * F, w.dz, w.dy,
                      w.dyxh, w.hin, w.dq, w.hlast, w.hub, L};
    grad_stage<false>(&ng, 1, T, F, B, nets, as, c, smem, FlatStore{});
    grid.sync();
  }
}

// The dims as the host checks them against its copy of the widths; *sum
// and *hmax get the widths' sum and max.
bool dims_ok(const DqnDims& d, const int* widths, long long* sum,
             int* hmax) {
  return d.obs_dim >= 1 && d.batch >= 1 && d.k_updates >= 1 &&
         (d.spill == 0 || d.spill == 1) && d.torso.tab != nullptr &&
         d.q.lay != nullptr &&
         widths_ok(widths, d.torso.L, 1, sum, hmax, 0);
}

// The items' plan: the spill route when d.spill asks for it or an item's
// buffers (a forward item's, the larger) do not fit in shared memory
// beside the ring and the table.
RowPlan dqn_row_plan(const DqnDims& d, int hmax) {
  return row_plan(d.obs_dim, hmax, table_ints(d), d.spill, kRowsF, 0, 0);
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
  int hmax;
  dims_ok(d, widths, &sum, &hmax);
  const RowPlan rp = dqn_row_plan(d, hmax);
  const long long B = d.batch;
  const long long hl = widths[d.torso.L - 1];
  const long long items = kPasses * ((B + kRowsF - 1) / kRowsF);
  *w = DqnWorkspace{};
  w->zS = take(B * sum);
  w->hin = take(B * (sum - hl));
  w->dz = take(B * sum);
  w->dy = take(B * sum);
  w->dyxh = take(B * sum);
  w->hlast = take(B * hl);
  w->dq = take(B * kNumActions);
  w->hub = take(B);
  w->qv = take(kPasses * B * kNumActions);
  w->tiles = rp.spill ? take(items * rp.tile_floats) : nullptr;
  return off;
}

}  // namespace

extern "C" {

// Floats of workspace cp_dqn_update_phase needs for these dims (0 when the
// dims are outside what the kernel takes). widths: the host's copy of the
// torso's widths (dims->torso.L ints).
long long cp_dqn_workspace_floats(const DqnDims* dims, const int* widths) {
  long long sum;
  int hmax;
  if (!dims_ok(*dims, widths, &sum, &hmax)) return 0;
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
  int hmax;
  if (!dims_ok(d, widths, &sum, &hmax))
    return static_cast<int>(cudaErrorInvalidValue);
  DqnWorkspace w;
  carve(d, widths, workspace, &w);
  DqnBatches bt = {obs, rew, nobs, act, done};
  RowPlan rp = dqn_row_plan(d, hmax);
  const size_t smem = plan_smem(rp, table_ints(d));
  static int blocks = 0;
  static size_t blocks_smem = 0;
  void* args[] = {&d, &c, &w, &q, &q_t, &m, &v, &bt, &loss, &t0, &rp};
  return static_cast<int>(launch_cooperative(
      reinterpret_cast<const void*>(dqn_update_kernel), smem, args,
      static_cast<cudaStream_t>(stream), blocks, blocks_smem));
}

}  // extern "C"
