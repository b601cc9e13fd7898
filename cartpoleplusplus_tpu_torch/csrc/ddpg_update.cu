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
// products whose results feed each other: each layer of each pass needs the
// whole previous layer of its rows for LayerNorm, and Adam needs the whole
// batch's gradient, so what bounds the phase is the latency of the chain.
// The TPU kernel ran the chain as a sequential grid carrying accumulators in
// VMEM; CUDA blocks run in no order.
//
// Design: ONE cooperative persistent launch per phase on the row chains of
// row_chain.cuh (shared with B5 and B7): per update a few stages, each a
// list of independent items dealt to the blocks, with a grid barrier after
// each. At actor_grad_critic "updated" (6 barriers per update, at any
// depth):
//   1. Critic forward: an item is a tile of kRowsF = 8 batch rows through
//      the target actor on s' (a'), through the target critic's front on
//      s' (layer 0, and layer 1's sums over its first H_0 inputs: the
//      action joins there, and a' is not known yet), or through the online
//      critic on (s, a), which keeps its pre-LN rows, layer inputs (the
//      action joined at layer 1) and Q.
//   2. Critic backward: an item is a tile of kRowsB = 4 rows: the target
//      critic's rest for its rows (layer 1 from the front's sums and a',
//      the layers above, the head: Q'), the TD epilogue, the head's
//      backward, and per layer the LayerNorm/relu backward and dh = dz W.
//   3. Critic gradients: every weight gradient in 32 x 32 tiles, the
//      vectors and the loss; Adam and Polyak on each element.
//   4. Actor forward (tiles of kRowsA = 4 rows): the actor on s (tanh
//      head), or the updated critic's front on s.
//   5. Actor backward: the critic's rest on (s, pi(s)), its backward from
//      d loss / dQ = -1/B down to dQ/da (no parameter gradients), the
//      tanh's backward, then the actor's head and layers.
//   6. Actor gradients, Adam and Polyak.
// At large batch a stage's items are wide instead (row_chain.cuh's kRowsW
// = 32 rows, float32 alone): each streamed weight chunk then serves 32
// rows of products, not 4 or 8. The rule is the shape's (ddpg_row_plan,
// ops/learner_kernel.py::ddpg_plan): a stage goes wide where its wide
// items still fill three quarters of the grid's blocks, one block an SM;
// at batch 8192 every stage (768, 256, 512 and 256 items on 132 SMs), at
// the defaults' 256 none. A plan with wide stages launches
// ddpg_update_kernel_wide, the float32 kernel built with them; the other
// kernels have none of their code. The items' heights change no bit.
// Splitting the critic at layer 1 keeps each forward item to one network's
// chain (the actor's and the critic's fronts run side by side). At "pre"
// the actor's chain reads the critic as it was before the update, so the
// five forward passes share stage 1, the backward lists stage 2 and the
// gradients stage 3: 3 barriers. Any depth >= 2 and any width, as the
// reference's kernel takes: the widths and the parameter offsets are a
// device table, and where an item's buffers do not fit in shared memory
// beside the weight ring (two layers wider than 1468 at obs 42) they live in
// the item's slice of the workspace. Parameters, targets and moments are
// updated in place in their 8 group buffers; the rows the gradient stages
// read go to the wrapper's workspace (a few MB at the defaults, in L2).
//
// Not a single cluster of CTAs: one such design measured slower, its
// products and batch sums latency-bound on 16 SMs (PERF.md, Findings).
//
// Numerics: the library is built with --fmad=false, so a*b+c is two
// rounded operations, as in the twin. The matrix-product and batch-sum
// inner loops use explicit fmaf() (one rounding, half the instructions) in
// the orders of the stage-engine design this one replaced (row_chain.cuh),
// so the bits are that design's; every elementwise formula (LayerNorm,
// Adam, Polyak, the TD target) follows the twin operation by operation.
// The float32 constants (log b, gamma, tau, 1/batch, the lr schedule) are
// folded on the host. No float atomics: two runs give the same bits. The
// kernel is instantiated per products' mode (dims.mm, learner_stages.cuh's
// modes), and the launcher picks the instance; the X3, X6, F64 and F16
// instances are built in ddpg_update_x3x6.cu and ddpg_update_f64f16.cu, and
// the float32 one with the wide row items in ddpg_update_wide.cu, this
// source with CP_MM_PRESET_UNIT defined, beside this one. At the tensor
// cores' modes (bfloat16, TF32, F16, X3, X6: mm_tc) every product of the
// row chains runs on the tensor cores (row_chain.cuh's kTc, which B5 and
// B7 leave off): kTcMode<M> below.
#include "row_chain.cuh"

// Mirror of ops/_native.py::LearnerDims.
struct LearnerDims {
  int obs_dim, batch, k_updates, merged;
  Torso torso;
  NetLayout actor, critic;
  int spill;  // 1: the items' buffers in the workspace at any width
  int mm;     // the products' mode (learner_stages.cuh's kMm*)
  int* instance;  // when not null: the instance's id (kMmInstance)
  int route;  // row_chain.cuh's wide_stages: 0 the rule, 1 narrow, 2 wide
};

namespace {

// Whether mode M's products run on the tensor cores: bfloat16, X3 and F16.
// X6 and TF32 keep their fmaf instances (PERF.md §6 has the readings): X6
// on the tensor cores lies nearer the float32 and F64 twins than the
// float32 kernel does after one update, against phase 32's identity check
// (chip_smoke.py's _mode_identity), and its sums chained through the
// tensor core drift past its share after K updates; TF32 on the tensor
// cores holds its checks but runs slower than its fmaf instance (each
// weight converts once per item in both, and TF32's conversion and
// twice the mma and additions per k cost more than the fmaf it saves).
template <int M>
inline constexpr bool kTcMode = mm_tc<M> && M != kMmX6 && M != kMmTf32;

constexpr int kActDim = 2;
static_assert(kActDim <= kMaxJoin && kActDim <= kQLd, "the action's room");
// A forward item's action rows (feature-major, R + 4) after its pre-LN
// rows; a backward item's dQ/da and d loss / d pre-tanh rows after its dz,
// then (the critic's rest of the forward) its activations over wmax
// features and its action rows (feature-major, R + 4), and a wide item's
// d loss / dQ rows (a narrow item's sit in the fixed part).
__host__ __device__ constexpr int fwd_extra(int R) {
  return kActDim * (R + 4);
}
__host__ __device__ inline int bwd_extra(int wmax, int R) {
  return 2 * R * kQLd + (R + 4) * wmax + kActDim * (R + 4) +
         (R > kRowsB ? R * kQLd : 0);
}

// The workspace: per-layer regions of the rows the gradient stages and the
// backward items read, layer l's (batch, H_l) rows at layer_rows(region,
// l), the layer inputs (l >= 1) at input_rows, and on the spill route every
// item's buffers. Carved by carve() on the host.
struct Workspace {
  // critic pass: the online critic on (s, a); the target critic's layer-1
  // sums over its first H_0 inputs on s', the target actor's a'
  float *zC, *hinC, *dzC, *dyC, *dyxhC, *hlastC;
  float *zTm, *aN, *qC, *td, *dqC;  // ..., Q(s, a), TD error, d loss / dQ
  // actor pass: the actor on s, the critic on (s, pi(s)) (its layer-1 sums
  // over its first H_0 inputs apart)
  float *zA, *hinA, *zQ, *zQm, *dzA, *dyA, *dyxhA, *hlastA;
  float *aA, *qA, *dpreA;     // pi(s), Q(s, pi(s)), d loss / d pre-tanh
  float* tiles;
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

// One shared copy of each of the row chain's pieces for B3's many call
// sites: inlined at each, the kernel's code outgrew the instruction cache.
template <int M, int R>
__device__ __noinline__ void torso_fwd_once(
    const Torso& T, const NetLayout& L, const float* net, int F,
    const float* xa, int na, float* act, float* zr, int ldz, float* ring,
    const LearnerConsts& c, const FwdSave& sv, int b0, int nr, int B, int l0,
    int l1, const float* zmain) {
  torso_fwd<M, R, kTcMode<M>>(T, L, net, F, xa, na, act, zr, ldz, ring, c, sv,
                          b0, nr, B, l0, l1, zmain);
}

template <int M, int R>
__device__ __noinline__ void torso_bwd_once(
    const Torso& T, const NetLayout& L, const float* net, int join,
    const float* z, float* dh, float* dzs, int ldz, float* ring,
    const LearnerConsts& c, const BwdSave& sv, int b0, int nr, int B, int lo,
    float* tail) {
  torso_bwd<M, kTcMode<M>, R>(T, L, net, join, z, dh, dzs, ldz, ring, c, sv,
                              b0, nr, B, lo, tail);
}

template <int M>
__device__ __noinline__ void grad_stage_once(
    const NetGrads* g, int n_nets, const Torso& T, int F, int B,
    const NetPtr* nets, const AdamStep& as, const LearnerConsts& c,
    float* sm) {
  grad_stage<false, M, kTcMode<M>>(g, n_nets, T, F, B, nets, as, c, sm,
                               FlatStore{});
}

// The critic's front on R rows whose layer-0 input is in act: layer 0 (its
// pre-LN rows kept when sv.z), then layer 1's sums over its first H_0
// inputs (the action's sums and the bias come later), rows b0 .. b0 + nr -
// 1 of them into zm (batch, H_1).
template <int M, int R>
__device__ __noinline__ void critic_front(
    const Torso& T, const NetLayout& LC, const float* net, int F, float* act,
    float* zr, int ldz, float* ring, const LearnerConsts& c,
    const FwdSave& sv, int b0, int nr, int B, float* zm) {
  torso_fwd<M, R, kTcMode<M>>(T, LC, net, F, nullptr, 0, act, zr, ldz, ring, c,
                          sv, b0, nr, B, 0, 1, nullptr);
  const int h0 = T.h(0), h1 = T.h(1);
  rows_product<M, R, R + 4, true, prod_cols(R), kTcMode<M>>(
      act, h0, h1, net + LC.w(1), h0 + kActDim, nullptr, zr, ldz, ring);
  for (int o = threadIdx.x; o < nr * h1; o += kThreads) {
    const int r = o / h1, cc = o - r * h1;
    zm[static_cast<size_t>(b0 + r) * h1 + cc] = zr[r * ldz + cc];
  }
}

// The action rows of a backward item of R rows: xa[a][r] = src[(b0 + r) 2
// + a] for the nr real rows, 0 past them (stride R + 4). Ends with a
// barrier.
template <int R>
__device__ __forceinline__ void load_actions(const float* src, int b0,
                                             int nr, float* xa) {
  if (threadIdx.x < R * kActDim) {
    const int r = threadIdx.x / kActDim, a = threadIdx.x - r * kActDim;
    xa[a * (R + 4) + r] =
        r < nr ? src[static_cast<size_t>(b0 + r) * kActDim + a] : 0.0f;
  }
  __syncthreads();
}

enum : int { kPassTarget = 0, kPassTargetFront = 1, kPassCritic = 2,
             kPassActor = 3, kPassActorFront = 4 };
// Rows of the actor's forward items at "updated": 4, so that its two
// passes give the card 128 items at batch 256 (at "pre" the five passes
// share one stage at kRowsF).
constexpr int kRowsA = 4;
enum : int { kBwdCritic = 0, kBwdActor = 1 };

// Forward item of pass p over the R rows from b0: kPassTarget, the target
// actor on s' into w.aN; kPassTargetFront, the target critic's front on s'
// into w.zTm; kPassCritic, the critic on (s, a) into w.qC, its rows kept;
// kPassActor, the actor on s (kept) into w.aA; kPassActorFront, the
// critic's front on s (its layer-0 rows kept) into w.zQm.
template <int M, int R>
__device__ void fwd_item(const LearnerDims& d, const LearnerConsts& c,
                         const Workspace& w, const RowPlan& rp,
                         const Torso& T, const NetLayout& LA,
                         const NetLayout& LC, const Groups& gr,
                         const Batches& bt, int k, int b0, int p, float* smem,
                         float* bufs) {
  const int B = d.batch, F = d.obs_dim, hl = T.h(T.L - 1);
  constexpr int LD = R + 4;
  const int nr = min(R, B - b0), ldz = rp.ldz;
  float* const act = bufs;                      // (wmax, LD)
  float* const zr = bufs + LD * rp.wmax;        // (R, ldz)
  float* const xa = zr + R * ldz;               // (kActDim, LD)
  const size_t kb = static_cast<size_t>(k) * B;
  const float* const obs = bt.obs + kb * F;
  const float* const nobs = bt.nobs + kb * F;
  float* const ring = smem;
  const float* A = gr.g[0];
  const float* C = gr.g[1];

  __syncthreads();  // the last item is done with the buffers
  if (p == kPassTarget || p == kPassActor) {
    const bool tgt = p == kPassTarget;
    const float* net = tgt ? gr.g[2] : A;
    float* const aout = tgt ? w.aN : w.aA;
    load_rows<R>(tgt ? nobs : obs, F, b0, nr, act);
    torso_fwd_once<M, R>(T, LA, net, F, nullptr, 0, act, zr, ldz, ring, c,
                         tgt ? FwdSave{} : FwdSave{w.zA, w.hinA, w.hlastA,
                                                   0},
                         b0, nr, B, 0, 0, nullptr);
    CP_MARK(3);  // the actor's torso
    head_fwd<M, R, kTcMode<M>>(
        net + LA.wh, net + LA.bh, kActDim, hl, act, ring,
        [&](int r, int a, float v) {
          if (r < nr) aout[(b0 + r) * kActDim + a] = tanhf(v);
        });
    CP_MARK(4);  // its head
  } else if (p == kPassTargetFront || p == kPassActorFront) {
    const bool tgt = p == kPassTargetFront;
    load_rows<R>(tgt ? nobs : obs, F, b0, nr, act);
    critic_front<M, R>(T, LC, tgt ? gr.g[3] : C, F, act, zr, ldz, ring, c,
                       tgt ? FwdSave{}
                           : FwdSave{w.zQ, nullptr, nullptr, kActDim},
                       b0, nr, B, tgt ? w.zTm : w.zQm);
    CP_MARK(5);  // the critic's front
  } else {
    for (int i = threadIdx.x; i < R * kActDim; i += kThreads) {
      const int r = i / kActDim, a = i - r * kActDim;
      xa[a * LD + r] =
          r < nr ? bt.act[(kb + b0 + r) * kActDim + a] : 0.0f;
    }
    load_rows<R>(obs, F, b0, nr, act);
    torso_fwd_once<M, R>(T, LC, C, F, xa, kActDim, act, zr, ldz, ring, c,
                         FwdSave{w.zC, w.hinC, w.hlastC, kActDim}, b0, nr,
                         B, 0, 0, nullptr);
    head_fwd<M, R, kTcMode<M>>(C + LC.wh, C + LC.bh, 1, hl, act, ring,
                               [&](int r, int, float v) {
                                 if (r < nr) w.qC[b0 + r] = v;
                               });
    CP_MARK(6);  // the critic on (s, a)
  }
}

// Backward item over the R rows from b0 (kRowsB, or a wide item's kRowsW).
// kBwdCritic: the target critic's rest on (s', a') (layer 1 from its
// front's sums and a', the layers above, the head: Q'), the TD epilogue
// and the critic's backward (its dz, dy, dy * xhat kept). kBwdActor: the
// critic's rest on (s, pi(s)) (its pre-LN rows kept; Q into w.qA), its
// backward from d loss / dQ = -1/B down to dQ/da, the tanh's backward into
// w.dpreA, then the actor's backward (kept).
template <int M, int R>
__device__ void bwd_item(const LearnerDims& d, const LearnerConsts& c,
                         const Workspace& w, const RowPlan& rp,
                         const Torso& T, const NetLayout& LA,
                         const NetLayout& LC, const Groups& gr,
                         const Batches& bt, int k, int b0, int which,
                         float* smem, float* bufs) {
  constexpr int LB = ld_b(R), L4 = R + 4;
  const int tid = threadIdx.x;
  const int B = d.batch, F = d.obs_dim, hl = T.h(T.L - 1);
  const int ldz = rp.ldz, nr = min(R, B - b0);
  float* const ring = smem;
  float* const dh = bufs;                    // (R, ldz); the rest's zr
  float* const dzs = bufs + R * ldz;         // (ldz, LB)
  float* const da = dzs + LB * ldz;          // (R, kQLd) dQ/da; Q'
  float* const dps = da + R * kQLd;          // (R, kQLd) d / d pre-tanh
  float* const act = dps + R * kQLd;         // (wmax, L4) the rest's rows
  float* const xa = act + L4 * rp.wmax;      // (kActDim, L4)
  // (R, kQLd) d loss / dQ
  float* const dqs = R > kRowsB ? xa + kActDim * L4 : smem + kRing;
  const float* A = gr.g[0];
  const float* C = gr.g[1];
  const bool critic = which == kBwdCritic;
  const float* net = critic ? gr.g[3] : C;
  const size_t kb = static_cast<size_t>(k) * B;

  __syncthreads();  // the last item is done with the buffers
  load_actions<R>(critic ? w.aN : w.aA, b0, nr, xa);
  torso_fwd_once<M, R>(T, LC, net, F, xa, kActDim, act, dh, ldz, ring, c,
                       critic ? FwdSave{}
                              : FwdSave{w.zQ, nullptr, nullptr, kActDim},
                       b0, nr, B, 1, 0, critic ? w.zTm : w.zQm);
  head_fwd<M, R, kTcMode<M>>(net + LC.wh, net + LC.bh, 1, hl, act, ring,
                             [&](int r, int, float v) {
                               if (critic)
                                 da[r] = v;
                               else if (r < nr)
                                 w.qA[b0 + r] = v;
                             });
  CP_MARK(7);  // the critic's rest
  if (critic) {
    if (tid < R) {  // the TD epilogue, one row a thread
      float g = 0.0f;
      if (tid < nr) {
        const int b = b0 + tid;
        const float v = da[tid];
        const float notdone = 1.0f - (bt.done[kb + b] ? 1.0f : 0.0f);
        const float target = bt.rew[kb + b] + (c.gamma * notdone) * v;
        const float td = w.qC[b] - target;
        w.td[b] = td;
        g = c.two_inv_batch * td;
        w.dqC[b] = g;
      }
      dqs[tid * kQLd] = g;
    }
    __syncthreads();
    head_bwd<M, kTcMode<M>, R>(dqs, 1, C + LC.wh, hl, dh, ldz);
    torso_bwd_once<M, R>(T, LC, C, kActDim, w.zC, dh, dzs, ldz, ring, c,
                         BwdSave{w.dzC, w.dyC, w.dyxhC}, b0, nr, B, 0,
                         nullptr);
    CP_MARK(8);  // the TD epilogue and the critic's backward
    return;
  }
  if (tid < R) dqs[tid * kQLd] = tid < nr ? c.neg_inv_batch : 0.0f;
  __syncthreads();
  head_bwd<M, kTcMode<M>, R>(dqs, 1, C + LC.wh, hl, dh, ldz);
  torso_bwd_once<M, R>(T, LC, C, kActDim, w.zQ, dh, dzs, ldz, ring, c,
                       BwdSave{}, b0, nr, B, 1, da);
  if (tid < R * kActDim) {  // through the tanh head
    const int r = tid / kActDim, a = tid - r * kActDim;
    float g = 0.0f;
    if (r < nr) {
      const size_t o = static_cast<size_t>(b0 + r) * kActDim + a;
      const float t = w.aA[o];
      g = da[r * kQLd + a] * (1.0f - t * t);
      w.dpreA[o] = g;
    }
    dps[r * kQLd + a] = g;
  }
  __syncthreads();
  head_bwd<M, kTcMode<M>, R>(dps, kActDim, A + LA.wh, hl, dh, ldz);
  torso_bwd_once<M, R>(T, LA, A, 0, w.zA, dh, dzs, ldz, ring, c,
                       BwdSave{w.dzA, w.dyA, w.dyxhA}, b0, nr, B, 0,
                       nullptr);
  CP_MARK(9);  // the actor's backward
}

// The K-update phase: the body of ddpg_update_kernel (the narrow items)
// and, kWide, of ddpg_update_kernel_wide (the stages that rp.wide marks in
// wide items).
template <int M, bool kWide>
__device__ __forceinline__ void ddpg_update(
    const LearnerDims& d, const LearnerConsts& c, const Workspace& w,
    const Groups& gr, const Batches& bt, float* __restrict__ closs,
    float* __restrict__ aloss, const int t0, const RowPlan& rp) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int B = d.batch, F = d.obs_dim;
  if (blockIdx.x == 0 && threadIdx.x == 0 && d.instance != nullptr)
    *d.instance = kMmInstance<M, kTcMode<M>>;
  int* const tab = reinterpret_cast<int*>(smem + rp.region);
  const Torso T = stage_table(d.torso, table_ints(d), tab);
  const NetLayout LA = layout_on(d.actor, d.torso, T);
  const NetLayout LC = layout_on(d.critic, d.torso, T);
  const NetPtr nets[2] = {{gr.g[0], gr.g[2], gr.g[4], gr.g[5]},
                          {gr.g[1], gr.g[3], gr.g[6], gr.g[7]}};
  auto bufs_of = [&](int item) {
    return rp.spill ? w.tiles + rp.tile_floats * item : smem + kFixed;
  };
  // Stage s: the forward items of passes p0 .. p0 + np - 1 over tiles of
  // `narrow` rows, or the backward items of kinds q0 .. q0 + nq - 1 over
  // tiles of kRowsB: (pass or kind, tile), dealt round-robin; in wide items
  // where the plan marks the stage (stage_rows).
  auto forward = [&](int s, auto narrow, int k, int p0, int np) {
    stage_rows<kWide, decltype(narrow)::value>(rp, s, [&](auto rows) {
      constexpr int R = decltype(rows)::value;
      const int tiles = (B + R - 1) / R;
      for (int item = blockIdx.x; item < np * tiles; item += gridDim.x)
        fwd_item<M, R>(d, c, w, rp, T, LA, LC, gr, bt, k, (item % tiles) * R,
                       p0 + item / tiles, smem, bufs_of(item));
    });
  };
  auto backward = [&](int s, int k, int q0, int nq) {
    stage_rows<kWide, kRowsB>(rp, s, [&](auto rows) {
      constexpr int R = decltype(rows)::value;
      const int tiles = (B + R - 1) / R;
      for (int item = blockIdx.x; item < nq * tiles; item += gridDim.x)
        bwd_item<M, R>(d, c, w, rp, T, LA, LC, gr, bt, k, (item % tiles) * R,
                       q0 + item / tiles, smem, bufs_of(item));
    });
  };

  for (int k = 0; k < d.k_updates; ++k) {
    const float* obs = bt.obs + static_cast<size_t>(k) * B * F;
    const float tk = static_cast<float>(t0 + k + 1);
    AdamStep as;
    as.bc1 = 1.0f - expf(tk * c.log_b1);
    as.bc2 = 1.0f - expf(tk * c.log_b2);
    const float frac =
        c.sched ? fminf((tk - 1.0f) / c.sched_steps, 1.0f) : 0.0f;
    as.lr[0] = c.sched ? c.actor_lr + frac * c.actor_lr_delta : c.actor_lr;
    as.lr[1] = c.sched ? c.critic_lr + frac * c.critic_lr_delta : c.critic_lr;
    // The two networks' gradient lists: the critic (net 1), the actor.
    const NetGrads g[2] = {
        {1, kActDim, 1, 1, c.inv_batch, closs + k, obs, w.dzC, w.dyC,
         w.dyxhC, w.hinC, w.dqC, w.hlastC, w.td, LC},
        {0, 0, kActDim, 0, c.neg_inv_batch, aloss + k, obs, w.dzA, w.dyA,
         w.dyxhA, w.hinA, w.dpreA, w.hlastA, w.qA, LA}};

    if (d.merged) {  // "pre": the actor's chain beside the critic's
      forward(0, Rows<kRowsF>{}, k, kPassTarget, 5);
      grid.sync();
      backward(1, k, kBwdCritic, 2);
      grid.sync();
      grad_stage_once<M>(g, 2, T, F, B, nets, as, c, smem);
    } else {  // "updated": critic Adam before the actor's chain
      forward(0, Rows<kRowsF>{}, k, kPassTarget, 3);
      grid.sync();
      backward(1, k, kBwdCritic, 1);
      grid.sync();
      grad_stage_once<M>(g, 1, T, F, B, nets, as, c, smem);
      grid.sync();
      forward(2, Rows<kRowsA>{}, k, kPassActor, 2);
      grid.sync();
      backward(3, k, kBwdActor, 1);
      grid.sync();
      grad_stage_once<M>(g + 1, 1, T, F, B, nets, as, c, smem);
    }
    grid.sync();
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads, 1) ddpg_update_kernel(
    const LearnerDims d, const LearnerConsts c, const Workspace w,
    const Groups gr, const Batches bt, float* __restrict__ closs,
    float* __restrict__ aloss, const int t0, const RowPlan rp) {
  ddpg_update<M, false>(d, c, w, gr, bt, closs, aloss, t0, rp);
}

// The dims as the host checks them against its copy of the widths; *sum
// and *hmax get the widths' sum and max.
bool dims_ok(const LearnerDims& d, const int* widths, long long* sum,
             int* hmax) {
  return d.obs_dim >= 1 && d.batch >= 1 && d.k_updates >= 1 &&
         (d.merged == 0 || d.merged == 1) && (d.spill == 0 || d.spill == 1) &&
         d.route >= 0 && d.route <= 2 && mm_ok(d.mm) &&
         d.torso.tab != nullptr && d.actor.lay != nullptr &&
         d.critic.lay != nullptr &&
         widths_ok(widths, d.torso.L, 2, sum, hmax, 0);
}

// The items of each stage of an update, stage s in wide items where bit s
// of `wide` is set (else kRowsF, kRowsB, kRowsA rows): at "updated" the
// critic's forward (3 passes), its backward, the actor's forward (2
// passes), its backward; at "pre" the five passes' forward and both
// chains' backward. Returns the number of stages.
int ddpg_stages(const LearnerDims& d, int wide, int* items) {
  auto tiles = [&](int s, int rows) {
    const int r = (wide >> s & 1) ? kRowsW : rows;
    return (d.batch + r - 1) / r;
  };
  if (d.merged) {
    items[0] = 5 * tiles(0, kRowsF);
    items[1] = 2 * tiles(1, kRowsB);
    return 2;
  }
  items[0] = 3 * tiles(0, kRowsF);
  items[1] = tiles(1, kRowsB);
  items[2] = 2 * tiles(2, kRowsA);
  items[3] = tiles(3, kRowsB);
  return 4;
}

// The items' plan: the stages that take wide items (float32 alone, by
// d.route and the rule over the device's SMs), and the spill route when
// d.spill asks for it or an item's buffers do not fit in shared memory
// beside the ring and the table.
RowPlan ddpg_row_plan(const LearnerDims& d, int hmax) {
  const int wmax = d.obs_dim > hmax ? d.obs_dim : hmax;
  int items[4];
  const int n = ddpg_stages(d, ~0, items);
  const int wide =
      d.mm == kMmF32 ? wide_stages(items, n, d.route) : 0;
  return row_plan(d.obs_dim, hmax, table_ints(d), d.spill, kRowsF,
                  fwd_extra(kRowsF), bwd_extra(wmax, kRowsB), wide,
                  fwd_extra(kRowsW), bwd_extra(wmax, kRowsW), d.route);
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
  int hmax;
  dims_ok(d, widths, &sum, &hmax);
  const RowPlan rp = ddpg_row_plan(d, hmax);
  const long long B = d.batch;
  const long long hl = widths[d.torso.L - 1];
  const long long ins = sum - hl;   // the layer inputs H_0 .. H_{L-2}
  int items[4];
  long long n_items = 0;  // the largest stage's
  for (int s = 0, n = ddpg_stages(d, rp.wide, items); s < n; ++s)
    n_items = items[s] > n_items ? items[s] : n_items;
  *w = Workspace{};
  w->zC = take(B * sum);
  w->hinC = take(B * (ins + kActDim));
  w->dzC = take(B * sum);
  w->dyC = take(B * sum);
  w->dyxhC = take(B * sum);
  w->hlastC = take(B * hl);
  w->zTm = take(B * widths[1]);
  w->aN = take(B * kActDim);
  w->qC = take(B);
  w->td = take(B);
  w->dqC = take(B);
  w->zA = take(B * sum);
  w->hinA = take(B * ins);
  w->zQ = take(B * sum);
  w->zQm = take(B * widths[1]);
  w->dzA = take(B * sum);
  w->dyA = take(B * sum);
  w->dyxhA = take(B * sum);
  w->hlastA = take(B * hl);
  w->aA = take(B * kActDim);
  w->qA = take(B);
  w->dpreA = take(B * kActDim);
  w->tiles = rp.spill ? take(n_items * rp.tile_floats) : nullptr;
  return off;
}

}  // namespace

// The X3 and X6 instances of the kernel (ddpg_update_x3x6.cu) and the F64
// and F16 ones (ddpg_update_f64f16.cu), each made in a translation unit that
// includes this source with CP_MM_PRESET_UNIT defined; null for another
// mode.
const void* cp_ddpg_x3x6_kernel(int m);
const void* cp_ddpg_f64f16_kernel(int m);
const void* cp_ddpg_wide_kernel();

// The float32 kernel with the wide items (a plan with rp.wide set), a
// kernel of its own: beside the narrow items' code in one kernel, their
// registers spilled the narrow items' and slowed them. It is made in
// ddpg_update_wide.cu, this source with CP_MM_PRESET_UNIT 3, so that it
// builds beside the others (in a stage-clock build, which compiles
// this source alone, here); the launcher takes it from
// cp_ddpg_wide_kernel.
#if CP_MM_PRESET_UNIT == 3 || \
    (CP_MM_PRESET_UNIT == 0 && defined(CP_STAGE_CLOCK))
__global__ void __launch_bounds__(kThreads, 1) ddpg_update_kernel_wide(
    const LearnerDims d, const LearnerConsts c, const Workspace w,
    const Groups gr, const Batches bt, float* __restrict__ closs,
    float* __restrict__ aloss, const int t0, const RowPlan rp) {
  ddpg_update<kMmF32, true>(d, c, w, gr, bt, closs, aloss, t0, rp);
}

const void* cp_ddpg_wide_kernel() {
  return reinterpret_cast<const void*>(ddpg_update_kernel_wide);
}
#endif

#if CP_MM_PRESET_UNIT == 1
const void* cp_ddpg_x3x6_kernel(int m) {
  if (m == kMmX3)
    return reinterpret_cast<const void*>(ddpg_update_kernel<kMmX3>);
  if (m == kMmX6)
    return reinterpret_cast<const void*>(ddpg_update_kernel<kMmX6>);
  return nullptr;
}
#elif CP_MM_PRESET_UNIT == 2
const void* cp_ddpg_f64f16_kernel(int m) {
  if (m == kMmF64)
    return reinterpret_cast<const void*>(ddpg_update_kernel<kMmF64>);
  if (m == kMmF16)
    return reinterpret_cast<const void*>(ddpg_update_kernel<kMmF16>);
  return nullptr;
}
#elif CP_MM_PRESET_UNIT == 0
extern "C" {

// Floats of workspace cp_ddpg_update_phase needs for these dims (0 when the
// dims are outside what the kernel takes). widths: the host's copy of the
// torso's widths (dims->torso.L ints).
long long cp_ddpg_workspace_floats(const LearnerDims* dims,
                                   const int* widths) {
  long long sum;
  int hmax;
  if (!dims_ok(*dims, widths, &sum, &hmax)) return 0;
  Workspace w;
  return carve(*dims, widths, nullptr, &w);
}

// The K-update phase in one cooperative launch on `stream`. widths: as
// above; dims->torso.tab and the layouts' tables: the device table
// (ops/learner_kernel.py::_learner_table). groups: the 8 group buffers
// (updated in place); batches: obs (K, B, F), act (K, B, 2), rew (K, B),
// nobs (K, B, F), done (K, B) bool; closs/aloss (K,); workspace:
// cp_ddpg_workspace_floats(dims, widths) floats; t0: the Adam count before
// the phase; dims->mm picks the kernel's instance; wide, when not null,
// gets the stages the launch took in wide items (RowPlan.wide). Returns a
// cudaError_t.
int cp_ddpg_update_phase(const LearnerDims* dims, const int* widths,
                         const LearnerConsts* consts, float* actor,
                         float* critic, float* actor_t, float* critic_t,
                         float* m_a, float* v_a, float* m_c, float* v_c,
                         const float* obs, const float* act, const float* rew,
                         const float* nobs, const bool* done, float* closs,
                         float* aloss, float* workspace, int t0,
                         void* stream, int* wide) {
  LearnerDims d = *dims;
  LearnerConsts c = *consts;
  long long sum;
  int hmax;
  if (!dims_ok(d, widths, &sum, &hmax))
    return static_cast<int>(cudaErrorInvalidValue);
  Workspace w;
  carve(d, widths, workspace, &w);
  Groups gr = {{actor, critic, actor_t, critic_t, m_a, v_a, m_c, v_c}};
  Batches bt = {obs, act, rew, nobs, done};
  RowPlan rp = ddpg_row_plan(d, hmax);
  const size_t smem = plan_smem(rp, table_ints(d));
  // Each instance keeps its own block count; the wide kernel (a float32
  // plan with wide stages) the last.
  static int blocks[kMmModes + 1] = {};
  static size_t blocks_smem[kMmModes + 1] = {};
  const void* kernels[kMmModes] =
      CP_MM_INSTANCES(ddpg_update_kernel, cp_ddpg_x3x6_kernel,
                      cp_ddpg_f64f16_kernel);
  const int slot = rp.wide != 0 ? kMmModes : d.mm;
  const void* kernel = rp.wide != 0 ? cp_ddpg_wide_kernel() : kernels[d.mm];
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&d, &c, &w, &gr, &bt, &closs, &aloss, &t0, &rp};
  const cudaError_t err = launch_cooperative(
      kernel, smem, args, static_cast<cudaStream_t>(stream), blocks[slot],
      blocks_smem[slot]);
  if (err == cudaSuccess && wide != nullptr) *wide = rp.wide;
  return static_cast<int>(err);
}

}  // extern "C"
#endif  // CP_MM_PRESET_UNIT
