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
// At large batch the forward and backward items are wide instead
// (row_chain.cuh's kRowsW = 32 rows, float32 alone), so that each streamed
// weight chunk serves 32 rows, not 8 or 4: a stage goes wide where its
// wide items still fill three quarters of the grid's blocks, one block an
// SM (dqn_row_plan, ops/learner_kernel.py::dqn_plan); at the suite cells'
// batch 8192 both stages (768 and 256 items on 132 SMs), at the defaults'
// 256 neither. A plan with wide stages launches dqn_update_kernel_wide, the
// float32 kernel built with them; the other kernels have none of their
// code. The items' heights change no bit.
// Where an item's buffers do not fit in shared memory beside the ring
// (a layer wider than 1468 at obs 42), they live in the item's slice of
// the workspace: the same code with other pointers. Every sum keeps the
// stage-engine design's order (row_chain.cuh), so B5 gives that design's
// bits. No float atomics: two runs give the same bits. Any depth >= 1 and
// any width, as the reference's kernel takes (the widths and offsets are
// the learners' device table). The kernel is instantiated per products'
// mode (dims.mm, learner_stages.cuh's modes), and the launcher picks the
// instance; the X3, X6, F64 and F16 instances are built in
// dqn_update_x3x6.cu and dqn_update_f64f16.cu, and the float32 one with the
// wide row items in dqn_update_wide.cu, this source with CP_MM_PRESET_UNIT
// defined, beside this one.
#include "row_chain.cuh"

// Mirror of ops/_native.py::DqnDims.
struct DqnDims {
  int obs_dim, batch, k_updates, double_dqn;
  Torso torso;
  NetLayout q;
  int spill;  // 1: the items' buffers in the workspace at any width
  int mm;     // the products' mode (learner_stages.cuh's kMm*)
  int route;  // row_chain.cuh's wide_stages: 0 the rule, 1 narrow, 2 wide
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

// Forward item: pass p over the R rows from b0 (kRowsF, or a wide item's
// kRowsW) through every layer and the head; Q values to w.qv, and for pass
// 0 the pre-LN rows and the layer inputs to the workspace.
template <int M, int R>
__device__ void fwd_item(const DqnDims& d, const LearnerConsts& c,
                         const DqnWorkspace& w, const RowPlan& rp,
                         const Torso& T, const NetLayout& L, const float* net,
                         const DqnBatches& bt, int k, int b0, int p,
                         float* smem, float* bufs) {
  const int B = d.batch, F = d.obs_dim;
  const int nr = min(R, B - b0);
  float* const act = bufs;                     // (wmax, R + 4)
  float* const zr = bufs + (R + 4) * rp.wmax;  // (R, ldz)
  const size_t kb = static_cast<size_t>(k) * B;

  __syncthreads();  // the last item is done with the buffers
  load_rows<R>((p == 0 ? bt.obs : bt.nobs) + kb * F, F, b0, nr, act);
  CP_MARK(3);  // the item's inputs
  const FwdSave sv = p == 0 ? FwdSave{w.zS, w.hin, w.hlast, 0} : FwdSave{};
  torso_fwd<M, R>(T, L, net, F, nullptr, 0, act, zr, rp.ldz, smem, c, sv, b0,
                  nr, B);
  CP_MARK(4);  // the torso
  float* const qv = w.qv + (static_cast<size_t>(p) * B + b0) * kNumActions;
  head_fwd<M, R>(net + L.wh, net + L.bh, kNumActions, T.h(T.L - 1), act,
                 smem, [&](int r, int a, float v) {
                   if (r < nr) qv[r * kNumActions + a] = v;
                 });
  CP_MARK(5);  // the head
}

// Backward item: the R rows from b0 (kRowsB, or a wide item's kRowsW): the
// TD epilogue, the head backward, and per layer the LayerNorm/relu
// backward and dh = dz W; writes dz, dy, dy * xhat, d loss / dQ and the
// Huber terms.
template <int M, int R>
__device__ void bwd_item(const DqnDims& d, const LearnerConsts& c,
                         const DqnWorkspace& w, const RowPlan& rp,
                         const Torso& T, const NetLayout& L, const float* Q,
                         const DqnBatches& bt, int k, int b0, float* smem,
                         float* bufs) {
  const int tid = threadIdx.x;
  const int B = d.batch, hl = T.h(T.L - 1);
  const int ldz = rp.ldz, nr = min(R, B - b0);
  float* const ring = smem;
  float* const dh = bufs;                   // (R, ldz)
  float* const dzs = bufs + R * ldz;        // (hmax, ld_b(R))
  // (R, kQLd) d loss / dQ: a narrow item's in the fixed part
  float* const dqs = R > kRowsB ? dzs + ld_b(R) * ldz : smem + kRing;
  const size_t kb = static_cast<size_t>(k) * B;

  __syncthreads();  // the last item is done with the buffers
  // ---- the TD epilogue, one row a thread: the first-max argmax of the
  // selector (the online net on s' under double DQN, else the target;
  // a strict >, jnp.argmax's tie rule), the target y, the Huber-clipped
  // gradient at the taken action and the row's Huber term ----
  if (tid < R) {
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
  head_bwd<M, false, R>(dqs, kNumActions, Q + L.wh, hl, dh, ldz);
  torso_bwd<M, false, R>(T, L, Q, 0, w.zS, dh, dzs, ldz, ring, c,
                         BwdSave{w.dz, w.dy, w.dyxh}, b0, nr, B, 0, nullptr);
  CP_MARK(6);  // the backward
}

// The K-update phase: the body of dqn_update_kernel (the narrow items) and,
// kWide, of dqn_update_kernel_wide (the stages that rp.wide marks in wide
// items).
template <int M, bool kWide>
__device__ __forceinline__ void dqn_update(
    const DqnDims& d, const LearnerConsts& c, const DqnWorkspace& w,
    float* __restrict__ qp, float* __restrict__ qtp, float* __restrict__ m,
    float* __restrict__ v, const DqnBatches& bt, float* __restrict__ loss,
    const int t0, const RowPlan& rp) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int B = d.batch, F = d.obs_dim;
  int* const tab = reinterpret_cast<int*>(smem + rp.region);
  const Torso T = stage_table(d.torso, table_ints(d), tab);
  const NetLayout L = layout_on(d.q, d.torso, T);
  const NetPtr nets[1] = {{qp, qtp, m, v}};
  auto bufs_of = [&](int item) {
    return rp.spill ? w.tiles + rp.tile_floats * item : smem + kFixed;
  };
  // Forward items: (pass, tile of R rows), pass 1 under double DQN only;
  // backward items: a tile each. Stage 0 (1) in wide items where the plan
  // marks it (stage_rows).
  auto forward = [&](auto rows, int k) {
    constexpr int R = decltype(rows)::value;
    const int tiles = (B + R - 1) / R;
    const int n_f = (d.double_dqn ? kPasses : 2) * tiles;
    for (int item = blockIdx.x; item < n_f; item += gridDim.x) {
      int p = item / tiles;
      if (p == 1 && !d.double_dqn) p = 2;
      fwd_item<M, R>(d, c, w, rp, T, L, p == 2 ? qtp : qp, bt, k,
                     (item % tiles) * R, p, smem, bufs_of(item));
    }
  };
  auto backward = [&](auto rows, int k) {
    constexpr int R = decltype(rows)::value;
    for (int item = blockIdx.x; item < (B + R - 1) / R; item += gridDim.x)
      bwd_item<M, R>(d, c, w, rp, T, L, qp, bt, k, item * R, smem,
                     bufs_of(item));
  };

  for (int k = 0; k < d.k_updates; ++k) {
    const float tk = static_cast<float>(t0 + k + 1);
    AdamStep as;
    as.bc1 = 1.0f - expf(tk * c.log_b1);
    as.bc2 = 1.0f - expf(tk * c.log_b2);
    as.lr[0] = as.lr[1] = c.actor_lr;

    stage_rows<kWide, kRowsF>(rp, 0, [&](auto rows) { forward(rows, k); });
    grid.sync();
    stage_rows<kWide, kRowsB>(rp, 1, [&](auto rows) { backward(rows, k); });
    grid.sync();
    const NetGrads ng{0, 0, kNumActions, 0, c.inv_batch, loss + k,
                      bt.obs + static_cast<size_t>(k) * B * F, w.dz, w.dy,
                      w.dyxh, w.hin, w.dq, w.hlast, w.hub, L};
    grad_stage<false, M>(&ng, 1, T, F, B, nets, as, c, smem, FlatStore{});
    grid.sync();
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads, 1) dqn_update_kernel(
    const DqnDims d, const LearnerConsts c, const DqnWorkspace w,
    float* __restrict__ qp, float* __restrict__ qtp, float* __restrict__ m,
    float* __restrict__ v, const DqnBatches bt, float* __restrict__ loss,
    const int t0, const RowPlan rp) {
  dqn_update<M, false>(d, c, w, qp, qtp, m, v, bt, loss, t0, rp);
}

// The dims as the host checks them against its copy of the widths; *sum
// and *hmax get the widths' sum and max.
bool dims_ok(const DqnDims& d, const int* widths, long long* sum,
             int* hmax) {
  return d.obs_dim >= 1 && d.batch >= 1 && d.k_updates >= 1 &&
         (d.spill == 0 || d.spill == 1) && d.route >= 0 && d.route <= 2 &&
         mm_ok(d.mm) && d.torso.tab != nullptr && d.q.lay != nullptr &&
         widths_ok(widths, d.torso.L, 1, sum, hmax, 0);
}

// The items of each stage of an update, stage s in wide items where bit s
// of `wide` is set (else kRowsF, kRowsB rows): the forward (the passes it
// runs: kPasses under double DQN, else the online net on s and the target
// on s'), the backward. Returns the number of stages.
int dqn_stages(const DqnDims& d, int wide, int* items) {
  const int rf = wide & 1 ? kRowsW : kRowsF, rb = wide & 2 ? kRowsW : kRowsB;
  items[0] = (d.double_dqn ? kPasses : 2) * ((d.batch + rf - 1) / rf);
  items[1] = (d.batch + rb - 1) / rb;
  return 2;
}

// The items' plan: the stages that take wide items (float32 alone, by
// d.route and the rule over the device's SMs), and the spill route when
// d.spill asks for it or an item's buffers do not fit in shared memory
// beside the ring and the table. A wide backward item's d loss / dQ rows
// follow its dz.
RowPlan dqn_row_plan(const DqnDims& d, int hmax) {
  int items[2];
  const int n = dqn_stages(d, ~0, items);
  const int wide =
      d.mm == kMmF32 ? wide_stages(items, n, d.route) : 0;
  return row_plan(d.obs_dim, hmax, table_ints(d), d.spill, kRowsF, 0, 0,
                  wide, 0, kRowsW * kQLd, d.route);
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
  int st[2];
  dqn_stages(d, rp.wide, st);
  const long long items = st[0] > st[1] ? st[0] : st[1];  // the larger stage
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

// The X3 and X6 instances of the kernel (dqn_update_x3x6.cu) and the F64
// and F16 ones (dqn_update_f64f16.cu), each made in a translation unit that
// includes this source with CP_MM_PRESET_UNIT defined; null for another
// mode.
const void* cp_dqn_x3x6_kernel(int m);
const void* cp_dqn_f64f16_kernel(int m);
const void* cp_dqn_wide_kernel();

// The float32 kernel with the wide items (a plan with rp.wide set), a
// kernel of its own, as ddpg_update.cu's: made in dqn_update_wide.cu
// (CP_MM_PRESET_UNIT 3; in a stage-clock build, here) and taken from
// cp_dqn_wide_kernel.
#if CP_MM_PRESET_UNIT == 3 || \
    (CP_MM_PRESET_UNIT == 0 && defined(CP_STAGE_CLOCK))
__global__ void __launch_bounds__(kThreads, 1) dqn_update_kernel_wide(
    const DqnDims d, const LearnerConsts c, const DqnWorkspace w,
    float* __restrict__ qp, float* __restrict__ qtp, float* __restrict__ m,
    float* __restrict__ v, const DqnBatches bt, float* __restrict__ loss,
    const int t0, const RowPlan rp) {
  dqn_update<kMmF32, true>(d, c, w, qp, qtp, m, v, bt, loss, t0, rp);
}

const void* cp_dqn_wide_kernel() {
  return reinterpret_cast<const void*>(dqn_update_kernel_wide);
}
#endif

#if CP_MM_PRESET_UNIT == 1
const void* cp_dqn_x3x6_kernel(int m) {
  if (m == kMmX3)
    return reinterpret_cast<const void*>(dqn_update_kernel<kMmX3>);
  if (m == kMmX6)
    return reinterpret_cast<const void*>(dqn_update_kernel<kMmX6>);
  return nullptr;
}
#elif CP_MM_PRESET_UNIT == 2
const void* cp_dqn_f64f16_kernel(int m) {
  if (m == kMmF64)
    return reinterpret_cast<const void*>(dqn_update_kernel<kMmF64>);
  if (m == kMmF16)
    return reinterpret_cast<const void*>(dqn_update_kernel<kMmF16>);
  return nullptr;
}
#elif CP_MM_PRESET_UNIT == 0
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
// the phase; dims->mm picks the kernel's instance; wide, when not null,
// gets the stages the launch took in wide items (RowPlan.wide). Returns a
// cudaError_t.
int cp_dqn_update_phase(const DqnDims* dims, const int* widths,
                        const LearnerConsts* consts, float* q, float* q_t,
                        float* m, float* v, const float* obs, const int* act,
                        const float* rew, const float* nobs, const bool* done,
                        float* loss, float* workspace, int t0, void* stream,
                        int* wide) {
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
  // Each instance keeps its own block count; the wide kernel (a float32
  // plan with wide stages) the last.
  static int blocks[kMmModes + 1] = {};
  static size_t blocks_smem[kMmModes + 1] = {};
  const void* kernels[kMmModes] =
      CP_MM_INSTANCES(dqn_update_kernel, cp_dqn_x3x6_kernel,
                      cp_dqn_f64f16_kernel);
  const int slot = rp.wide != 0 ? kMmModes : d.mm;
  const void* kernel = rp.wide != 0 ? cp_dqn_wide_kernel() : kernels[d.mm];
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&d, &c, &w, &q, &q_t, &m, &v, &bt, &loss, &t0, &rp};
  const cudaError_t err = launch_cooperative(
      kernel, smem, args, static_cast<cudaStream_t>(stream), blocks[slot],
      blocks_smem[slot]);
  if (err == cudaSuccess && wide != nullptr) *wide = rp.wide;
  return static_cast<int>(err);
}

}  // extern "C"
#endif  // CP_MM_PRESET_UNIT
