// The network tile of the policy-in-the-loop rollouts B2, B4, B6 and B8
// (policy_rollout.cu, q_rollout.cu): a torso of any depth and width,
// [Dense + LayerNorm + relu] x L, over a tile of 32 envs in one 256-thread
// block, on Hopper, then a head of 5 (B4, B8) or 2 (B2, B6) outputs and
// the env step; one kernel body (tile_rollout_kernel), the head and the
// exploration rule a compile-time mode.
//
// Layout. Activations are env-minor: element (k, e) of a layer sits at
// k * kLd + e, kLd = 36, so that 4 or 8 neighbouring envs of one feature
// are one 16-byte load, a warp's float4 stores of neighbouring features
// spread over the banks, and lane e reading feature k of env e is
// conflict-free. Two such buffers ping-pong between layers, in shared
// memory, or, when a tile's activations do not fit there beside the
// weight slots (width above 528 at obs 42), in the block's slice of a
// workspace in device memory.
//
// Products. Every thread computes a register tile of RE envs x RC output
// columns from RE + RC floats loaded per k (16-byte loads): 8 x 8 in a
// full 256-column panel, the rows of each weight chunk split between the
// block's two halves and their sums added in a fixed order; 4 x 4 or
// 2 x 4 in narrower panels, so that all 256 threads still have work.
// Explicit __fmaf_rn (the library is built with --fmad=false so that the
// physics keeps its twin-exact order). Every sum runs in a fixed order,
// so a launch repeats its bits.
//
// Weights. The packed torso weights (ops/q_rollout.py::pack_tile_net: W_l
// as (in, Np_l) row-major, Np_l the width rounded up to 4, zero-padded)
// are copied into shared memory once per launch when they fit
// ("resident": B8's (64, 64) is 29 KB). Otherwise they are streamed every
// env-step in chunks of 32 rows x up to 256 columns through two
// shared-memory slots by cp.async, the next chunk in flight while the
// current one is multiplied; the chunk after the last torso chunk is the
// first of the next env-step.
//
// Head and env step. The head's sums are spread over all 8 warps (a slice
// of its features each, added in warp order by the env's owner), B8's
// Gumbel draws over one thread per (env, action) pair beside them; then
// lane e of warp 0 runs env e's action rule, force, physics and reset,
// its env state (and B2's OU noise) in registers for all T steps.
#pragma once

#include "policy_tile.cuh"

// Mirror of ops/_native.py::QDims: the torso's depth, the obs width, the
// widest layer (max(obs_dim, hidden...)) and the floats of the padded
// torso weights; the widths themselves are a device int32 array.
// (Outside the unnamed namespace: the exported launchers take it.)
struct QDims {
  int num_layers, obs_dim, width, wfloats;
};

namespace {

constexpr int kMaxSmem = 232448;  // ops/_native.py::MAX_SMEM
constexpr int kLd = 36;           // activation row stride (envs, padded)
constexpr int kChunkRows = 32;    // k rows of a streamed weight chunk
constexpr int kPanel = 256;       // output columns of a panel / chunk
constexpr int kSlot = kChunkRows * kPanel;
constexpr int kDrawLd = 8;        // per-env stride of B8's 5 Gumbel draws
constexpr int kHeadLd = 8;        // padded head width in pack_tile_net
// Per-warp partial sums of LayerNorm (2 x 8 x 32) and the head (8 x 8 x
// 32), in one region.
constexpr int kPartFloats = kWarps * kHeadLd * kTile;

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// Shared-memory plan of one launch, in floats (each region a multiple of
// 4, so every region starts 16-byte aligned).
struct QPlan {
  int num_layers, obs_dim, width, wfloats;
  int ldo;        // obs row stride (odd: lane-per-env rows conflict-free)
  int resident;   // torso weights held for the whole launch
  int spill;      // activations in the workspace
  int obs_off, draw_off, part_off, act_off, w_off, floats;
};

__host__ inline QPlan make_plan(const QDims& d) {
  QPlan p{};
  p.num_layers = d.num_layers;
  p.obs_dim = d.obs_dim;
  p.width = d.width;
  p.wfloats = d.wfloats;
  p.ldo = d.obs_dim | 1;
  p.obs_off = 0;
  p.draw_off = pad4(kTile * p.ldo);
  p.part_off = p.draw_off + kTile * kDrawLd;
  p.act_off = p.part_off + kPartFloats;
  const long acts = 2L * kLd * d.width;
  const long cap = kMaxSmem / 4;
  p.spill = p.act_off + acts + 2 * kSlot > cap;
  p.w_off = p.act_off + (p.spill ? 0 : static_cast<int>(acts));
  p.resident = p.w_off + static_cast<long>(d.wfloats) <= cap;
  p.floats = p.w_off + (p.resident ? d.wfloats : 2 * kSlot);
  return p;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The next streamed chunk to issue: torso layer l, rows k0.., columns
// col0.. of its (K, Np) weight block at float offset woff; slot = the
// shared-memory slot it goes to.
struct WeightStream {
  int slot, l, k0, col0, K, Np;
  long woff;
};

__device__ __forceinline__ WeightStream stream_start(const int* hidden,
                                                     int F) {
  return WeightStream{0, 0, 0, 0, F, pad4(__ldg(hidden)), 0};
}

// Issue chunk s into its slot (all threads), then advance s by one chunk
// in the order the torso consumes them, wrapping to the next env-step.
__device__ __forceinline__ void stream_issue(WeightStream& s,
                                             const float* __restrict__ W,
                                             float* slots,
                                             const int* __restrict__ hidden,
                                             int L, int F) {
  const int kc = min(kChunkRows, s.K - s.k0);
  const int pw4 = min(kPanel, s.Np - s.col0) / 4;
  float* dst = slots + s.slot * kSlot;
  const float* src = W + s.woff + static_cast<long>(s.k0) * s.Np + s.col0;
  for (int i = threadIdx.x; i < kc * pw4; i += kThreads) {
    const int r = i / pw4, c = i - r * pw4;
    cp_async16(dst + r * pw4 * 4 + c * 4, src + static_cast<long>(r) * s.Np +
                                              c * 4);
  }
  cp_async_commit();
  s.slot ^= 1;
  s.k0 += kChunkRows;
  if (s.k0 < s.K) return;
  s.k0 = 0;
  s.col0 += kPanel;
  if (s.col0 < s.Np) return;
  s.col0 = 0;
  s.woff += static_cast<long>(s.K) * s.Np;
  if (++s.l == L) {
    s.l = 0;
    s.woff = 0;
    s.K = F;
  } else {
    s.K = __ldg(hidden + s.l - 1);
  }
  s.Np = pad4(__ldg(hidden + s.l));
}

// Where a layer's weights come from: the resident copy, or the stream.
struct WeightSource {
  const float* W;       // packed weights in device memory
  float* wsm;           // resident copy or the two slots
  const int* hidden;
  int L, F, resident;
  WeightStream s;
};

// N consecutive floats from 16-byte aligned p (N = 2, 4 or 8).
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x;
    v[1] = a.y;
  } else {
#pragma unroll
    for (int h = 0; h < N / 4; ++h) {
      const float4 a = reinterpret_cast<const float4*>(p)[h];
      v[4 * h] = a.x;
      v[4 * h + 1] = a.y;
      v[4 * h + 2] = a.z;
      v[4 * h + 3] = a.w;
    }
  }
}

// One panel of a dense layer: out[c][e] = sum_k in[k][e] W[k][c] + b[c]
// for columns col0 .. col0 + pw of the layer's Np. A unit is RE envs x
// RC columns; unit u takes env group u % (32 / RE) and column group
// u / (32 / RE), so a warp's lanes share weights and spread over envs.
// KS = 2 splits every chunk's rows between the two halves of the block
// (the 8 x 8 units of a 256-column panel are 128); the second half's sums
// then go through `out` and are added to the first's, in that order.
template <int RE, int RC, int KS>
__device__ __forceinline__ void dense_panel(WeightSource& ws, long woff,
                                            const float* in, float* out,
                                            int K, int N, int Np, int col0,
                                            int pw,
                                            const float* __restrict__ bias) {
  constexpr int kPer = kThreads / KS;           // threads per row share
  constexpr int kGroups = kTile / RE;
  constexpr int kNu = kTile * kPanel / (RE * RC) > kPer ? 2 : 1;
  const int units = kGroups * (pw / RC);
  const int ks = threadIdx.x / kPer;
  int eg[kNu], cg[kNu];
  bool on[kNu];
  float acc[kNu][RE][RC];
#pragma unroll
  for (int u = 0; u < kNu; ++u) {
    const int id = threadIdx.x % kPer + u * kPer;
    on[u] = id < units;
    eg[u] = id % kGroups;
    cg[u] = id / kGroups;
#pragma unroll
    for (int i = 0; i < RE; ++i)
#pragma unroll
      for (int j = 0; j < RC; ++j) acc[u][i][j] = 0.0f;
  }
  const int kstep = ws.resident ? K : kChunkRows;
  for (int k0 = 0; k0 < K; k0 += kstep) {
    const int kc = min(kstep, K - k0);
    const float* w;
    int ldw;
    if (ws.resident) {
      w = ws.wsm + woff + static_cast<long>(k0) * Np + col0;
      ldw = Np;
    } else {
      cp_async_wait_all();
      __syncthreads();
      const int cur = ws.s.slot ^ 1;
      stream_issue(ws.s, ws.W, ws.wsm, ws.hidden, ws.L, ws.F);
      w = ws.wsm + cur * kSlot;
      ldw = pw;
    }
    const int half = KS == 1 ? kc : (kc + 1) / 2;
    const int ka = ks * half, kb = KS == 1 ? kc : min(kc, ka + half);
#pragma unroll
    for (int u = 0; u < kNu; ++u) {
      if (!on[u]) continue;
      const float* ip = in + static_cast<long>(k0) * kLd + eg[u] * RE;
      const float* wp = w + cg[u] * RC;
#pragma unroll 4
      for (int k = ka; k < kb; ++k) {
        float x[RE], y[RC];
        load_vec<RE>(ip + k * kLd, x);
        load_vec<RC>(wp + k * ldw, y);
#pragma unroll
        for (int i = 0; i < RE; ++i)
#pragma unroll
          for (int j = 0; j < RC; ++j)
            acc[u][i][j] = __fmaf_rn(x[i], y[j], acc[u][i][j]);
      }
    }
  }
  if constexpr (KS == 2) {
    // Every unit is on (pw = 256). The second half's sums pass through
    // the panel's own, not yet written, part of `out`, value-major so
    // that both sides are conflict-free; the first half adds them to its
    // own before anything is stored there.
    float* part = out + static_cast<long>(col0) * kLd;
    const int t = threadIdx.x % kPer;
    if (ks == 1) {
#pragma unroll
      for (int i = 0; i < RE; ++i)
#pragma unroll
        for (int j = 0; j < RC; ++j)
          part[(i * RC + j) * kPer + t] = acc[0][i][j];
    }
    __syncthreads();
    if (ks == 0) {
#pragma unroll
      for (int i = 0; i < RE; ++i)
#pragma unroll
        for (int j = 0; j < RC; ++j)
          acc[0][i][j] = acc[0][i][j] + part[(i * RC + j) * kPer + t];
    }
    __syncthreads();
    if (ks == 1) return;
  }
#pragma unroll
  for (int u = 0; u < kNu; ++u) {
    if (!on[u]) continue;
    float b[RC];
#pragma unroll
    for (int j = 0; j < RC; ++j)
      b[j] = __ldg(bias + min(col0 + cg[u] * RC + j, N - 1));
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      const int c = col0 + cg[u] * RC + j;
      if (c >= N) break;
      float* op = out + static_cast<long>(c) * kLd + eg[u] * RE;
      float v[RE];
#pragma unroll
      for (int i = 0; i < RE; ++i) v[i] = acc[u][i][j] + b[j];
      if constexpr (RE == 2) {
        *reinterpret_cast<float2*>(op) = make_float2(v[0], v[1]);
      } else {
#pragma unroll
        for (int h = 0; h < RE / 4; ++h)
          reinterpret_cast<float4*>(op)[h] =
              make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
      }
    }
  }
}

// A dense layer (K -> N) over the tile, panel by panel.
__device__ __forceinline__ void dense_layer(WeightSource& ws, long woff,
                                            const float* in, float* out,
                                            int K, int N,
                                            const float* __restrict__ bias) {
  const int Np = pad4(N);
  for (int col0 = 0; col0 < Np; col0 += kPanel) {
    const int pw = min(kPanel, Np - col0);
    if (pw == kPanel)
      dense_panel<8, 8, 2>(ws, woff, in, out, K, N, Np, col0, pw, bias);
    else if (pw >= 128)
      dense_panel<4, 4, 1>(ws, woff, in, out, K, N, Np, col0, pw, bias);
    else
      dense_panel<2, 4, 1>(ws, woff, in, out, K, N, Np, col0, pw, bias);
  }
}

// flax LayerNorm (one-pass variance, ops' LayerNorm) then relu, in place
// over the tile's N features. Warp w sums features w, w + 8, ... for env
// = lane; the 8 partials are added in warp order by every thread of its
// env. Ends with a barrier.
__device__ __forceinline__ void layer_norm_relu_tile(
    float* h, int N, const float* __restrict__ scale,
    const float* __restrict__ bias, float* part) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float s = 0.0f, s2 = 0.0f;
#pragma unroll 4
  for (int k = warp; k < N; k += kWarps) {
    const float v = h[static_cast<long>(k) * kLd + lane];
    s = s + v;
    s2 = __fmaf_rn(v, v, s2);
  }
  part[warp * kTile + lane] = s;
  part[(kWarps + warp) * kTile + lane] = s2;
  __syncthreads();
  s = part[lane];
  s2 = part[kWarps * kTile + lane];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    s = s + part[w * kTile + lane];
    s2 = s2 + part[(kWarps + w) * kTile + lane];
  }
  const float mean = s / static_cast<float>(N);
  const float mean2 = s2 / static_cast<float>(N);
  const float var = fmaxf(mean2 - mean * mean, 0.0f);
  const float inv = 1.0f / sqrtf(var + kLnEps);
  // Four features at a time, every load before the first store.
  for (int k0 = warp; k0 < N; k0 += 4 * kWarps) {
    float v[4], sc[4], bi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = min(k0 + j * kWarps, N - 1);
      v[j] = h[static_cast<long>(k) * kLd + lane];
      sc[j] = __ldg(scale + k);
      bi[j] = __ldg(bias + k);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + j * kWarps;
      if (k < N)
        h[static_cast<long>(k) * kLd + lane] =
            fmaxf((v[j] - mean) * (inv * sc[j]) + bi[j], 0.0f);
    }
  }
  __syncthreads();
}

// The torso over the tile whose obs (F features) are in buf0, ping-
// ponging with buf1; vec: the layers' [bias, LN scale, LN bias] vectors.
// Returns the buffer holding the last layer's activations.
__device__ __forceinline__ const float* torso_tile(WeightSource& ws,
                                                   const float* vec,
                                                   float* buf0, float* buf1,
                                                   float* part) {
  float* in = buf0;
  float* out = buf1;
  int K = ws.F;
  long woff = 0;
  for (int l = 0; l < ws.L; ++l) {
    const int N = __ldg(ws.hidden + l);
    dense_layer(ws, woff, in, out, K, N, vec);
    __syncthreads();
    layer_norm_relu_tile(out, N, vec + N, vec + 2 * N, part);
    woff += static_cast<long>(K) * pad4(N);
    vec += 3 * N;
    float* tmp = in;
    in = out;
    out = tmp;
    K = N;
  }
  return in;
}


constexpr int kNumActions = 5;  // ops/q_rollout.py::NUM_ACTIONS (B4, B8)
constexpr int kActDim = 2;      // the continuous action (B2, B6)

// The modes of tile_rollout_kernel: the exploration rule and the head.
enum : int {
  kModeDqn = 0,   // B4: epsilon-greedy argmax of 5 Q values
  kModePg = 1,    // B8: Gumbel-max sample of the 5-way softmax
  kModeDdpg = 2,  // B2: tanh head + OU noise (tags 0x41/0x42)
  kModeNaf = 3,   // B6: tanh head + sigma * normal (tags 0x45/0x46)
};

// The exploration scalars of a launch (each mode reads its own).
struct Explore {
  float eps;       // B4
  float ou_theta;  // B2
  float sigma;     // B2, B6
};

// -log(-log(u)), u = uniform(hash(seed, t, 0x47, a, 0xB2)) in [2^-24, 1):
// utils/prng.py::gumbel with ops/pg_rollout.py::TAG_PG_GUMBEL.
__device__ __forceinline__ float gumbel(uint32_t seed, uint32_t t, int a) {
  const float u = cp::uniform_from_bits(
      cp::hash_words(seed, t, 0x47u, static_cast<uint32_t>(a), 0xB2u),
      cp::kTwoM24, 1.0f - cp::kTwoM24);
  return -logf(-logf(u));
}

// The head's partial sums: warp w sums features w, w + 8, ... of env
// `lane` for all NA outputs into part[(w * 8 + a) * 32 + lane].
template <int NA>
__device__ __forceinline__ void head_partials(const float* h, int H,
                                              const float* __restrict__ W,
                                              float* part, int warp,
                                              int lane) {
  float acc[NA] = {};
#pragma unroll 4
  for (int k = warp; k < H; k += kWarps) {
    const float x = h[k * kLd + lane];
    if constexpr (NA == kNumActions) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(W + k * kHeadLd));
      acc[0] = __fmaf_rn(x, w.x, acc[0]);
      acc[1] = __fmaf_rn(x, w.y, acc[1]);
      acc[2] = __fmaf_rn(x, w.z, acc[2]);
      acc[3] = __fmaf_rn(x, w.w, acc[3]);
      acc[4] = __fmaf_rn(x, __ldg(W + k * kHeadLd + 4), acc[4]);
    } else {
      const float2 w = __ldg(reinterpret_cast<const float2*>(W + k * kHeadLd));
      acc[0] = __fmaf_rn(x, w.x, acc[0]);
      acc[1] = __fmaf_rn(x, w.y, acc[1]);
    }
  }
#pragma unroll
  for (int a = 0; a < NA; ++a)
    part[(warp * kHeadLd + a) * kTile + lane] = acc[a];
}

// Output a of the head for env `lane`: the 8 warps' partials in warp
// order, plus the bias.
__device__ __forceinline__ float head_out(const float* part, int a, int lane,
                                          const float* __restrict__ bias) {
  float v = part[a * kTile + lane];
#pragma unroll
  for (int w = 1; w < kWarps; ++w)
    v = v + part[(w * kHeadLd + a) * kTile + lane];
  return v + __ldg(bias + a);
}

// T env-steps of a 32-env tile with the network in the loop. kSpill: the
// activations live in the block's slice of `work`. traj_act is int32 (T,
// B) in the discrete modes, float (T, B, 2) in the continuous ones;
// noise_in/noise_out (B, 2) are B2's OU state (unused otherwise).
template <int kMode, bool kSpill>
__global__ void __launch_bounds__(kThreads, 1) tile_rollout_kernel(
    const EnvConsts c, const QPlan p, const float* __restrict__ params,
    const int* __restrict__ hidden, float* __restrict__ work,
    const Explore x, const int t0, const int B, const int T,
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ s, const float* __restrict__ sd,
    const int* __restrict__ steps_in, const int* __restrict__ episode_in,
    const int64_t* __restrict__ seed_in, const float* __restrict__ noise_in,
    const float* __restrict__ obs_in, float* __restrict__ traj_obs,
    void* __restrict__ traj_act, float* __restrict__ traj_rew,
    bool* __restrict__ traj_done, float* __restrict__ pos_out,
    float* __restrict__ vel_out, float* __restrict__ s_out,
    float* __restrict__ sd_out, int* __restrict__ steps_out,
    int* __restrict__ episode_out, float* __restrict__ noise_out,
    float* __restrict__ obs_out) {
  constexpr bool kDiscrete = kMode == kModeDqn || kMode == kModePg;
  constexpr int kOut = kDiscrete ? kNumActions : kActDim;
  extern __shared__ __align__(16) float smem[];
  const int F = p.obs_dim, ldo = p.ldo, L = p.num_layers;
  float* const obsb = smem + p.obs_off;      // (kTile, ldo) env-major obs
  float* const draws = smem + p.draw_off;   // (kTile, 8) Gumbel draws
  float* const part = smem + p.part_off;     // LayerNorm / head partials
  float* buf0;
  if constexpr (kSpill)
    buf0 = work + static_cast<long>(blockIdx.x) * 2 * kLd * p.width;
  else
    buf0 = smem + p.act_off;
  float* const buf1 = buf0 + static_cast<long>(kLd) * p.width;
  const int env0 = blockIdx.x * kTile;
  const int n_env = min(kTile, B - env0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // The head's weights (H, 8) follow the torso's; then the layers'
  // [bias, LN scale, LN bias] vectors and the head's bias.
  const int H = __ldg(hidden + L - 1);
  const float* const head_w = params + p.wfloats;
  const float* const vec = head_w + static_cast<long>(H) * kHeadLd;
  const float* head_b = vec;
  for (int l = 0; l < L; ++l) head_b += 3 * __ldg(hidden + l);

  WeightSource ws{params, smem + p.w_off, hidden, L, F, p.resident,
                  stream_start(hidden, F)};
  if (p.resident) {
    for (int i = tid; i < p.wfloats / 4; i += kThreads)
      cp_async16(ws.wsm + 4 * i, params + 4 * i);
    cp_async_commit();
  } else {
    stream_issue(ws.s, params, ws.wsm, hidden, L, F);
  }

  for (int i = tid; i < kTile * ldo; i += kThreads) {
    const int e = i / ldo, k = i - e * ldo;
    obsb[i] = (e < n_env && k < F)
                  ? obs_in[static_cast<long>(env0 + e) * F + k]
                  : 0.0f;
  }
  // Lane e of every warp holds env e's seed (B8's draws); lane e of
  // warp 0 owns env e's state (and B2's noise) for the whole rollout.
  const int g = env0 + lane;
  const bool live = lane < n_env;
  const uint32_t seed = live ? static_cast<uint32_t>(seed_in[g]) : 0u;
  const bool owner = warp == 0 && live;
  cp::Phys st{};
  int steps = 0, episode = 0;
  float nx = 0.0f, ny = 0.0f;
  if (owner) {
    st = load_phys(pos, vel, s, sd, g);
    steps = steps_in[g];
    episode = episode_in[g];
    if constexpr (kMode == kModeDdpg) {
      nx = noise_in[2 * g];
      ny = noise_in[2 * g + 1];
    }
  }
  if (p.resident) cp_async_wait_all();
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // Trajectory obs = the pre-step observation; the tile's obs go
    // feature-major into buf0 for the first layer.
    float* const dst = traj_obs + (static_cast<long>(t) * B + env0) * F;
    for (int e = warp; e < n_env; e += kWarps)
      for (int k = lane; k < F; k += 32) dst[e * F + k] = obsb[e * ldo + k];
    for (int i = tid; i < F * kTile; i += kThreads) {
      const int k = i / kTile, e = i - k * kTile;
      buf0[k * kLd + e] = obsb[e * ldo + k];
    }
    __syncthreads();

    const float* h = torso_tile(ws, vec, buf0, buf1, part);
    // The head's partial sums over all warps; beside them warps 0-4 draw
    // B8's Gumbel noise, one (env, action) pair a thread.
    head_partials<kOut>(h, H, head_w, part, warp, lane);
    const uint32_t tg = static_cast<uint32_t>(t0 + t);
    if constexpr (kMode == kModePg) {
      if (warp < kNumActions)
        draws[lane * kDrawLd + warp] = gumbel(seed, tg, warp);
    }
    __syncthreads();

    // The action (B4/B8: first-max argmax of the outputs, plus B8's
    // draws, then B4's epsilon gate; B2/B6: tanh plus the noise,
    // clipped), force, physics, reward, reset; next obs into obsb.
    if (owner) {
      const long tb = static_cast<long>(t) * B + g;
      float fx, fy;
      if constexpr (kDiscrete) {
        int action = 0;
        float best = 0.0f;
#pragma unroll
        for (int a = 0; a < kNumActions; ++a) {
          float v = head_out(part, a, lane, head_b);
          if constexpr (kMode == kModePg) v = v + draws[lane * kDrawLd + a];
          if (a == 0 || v > best) {  // strict: the first maximum wins ties
            best = v;
            action = a;
          }
        }
        if constexpr (kMode == kModeDqn) {
          const bool explore =
              cp::uniform_from_bits(cp::hash_words(seed, tg, 0x43u), 0.0f,
                                    1.0f) < x.eps;
          if (explore)
            action = static_cast<int>(cp::hash_words(seed, tg, 0x44u) %
                                      static_cast<uint32_t>(kNumActions));
        }
        static_cast<int*>(traj_act)[tb] = action;
        fx = (action == 1 ? 1.0f : (action == 2 ? -1.0f : 0.0f)) *
             c.action_force;
        fy = (action == 3 ? 1.0f : (action == 4 ? -1.0f : 0.0f)) *
             c.action_force;
      } else {
        const float mu0 = tanhf(head_out(part, 0, lane, head_b));
        const float mu1 = tanhf(head_out(part, 1, lane, head_b));
        if constexpr (kMode == kModeNaf) {
          nx = cp::normal(seed, tg, 0x45u) * x.sigma;
          ny = cp::normal(seed, tg, 0x46u) * x.sigma;
        } else {
          const float eps_x = cp::normal(seed, tg, 0x41u);
          const float eps_y = cp::normal(seed, tg, 0x42u);
          nx = nx + x.ou_theta * (0.0f - nx) + x.sigma * eps_x;
          ny = ny + x.ou_theta * (0.0f - ny) + x.sigma * eps_y;
        }
        const float ax = cp::clampf(mu0 + nx, -1.0f, 1.0f);
        const float ay = cp::clampf(mu1 + ny, -1.0f, 1.0f);
        static_cast<float*>(traj_act)[2 * tb] = ax;
        static_cast<float*>(traj_act)[2 * tb + 1] = ay;
        fx = ax * c.action_force;
        fy = ay * c.action_force;
      }
      float reward;
      bool done;
      step_into_row(c, st, steps, episode, seed, fx, fy, obsb + lane * ldo,
                    reward, done);
      if constexpr (kMode == kModeDdpg) {
        if (done) {  // the OU state of a finished episode restarts at 0
          nx = 0.0f;
          ny = 0.0f;
        }
      }
      traj_rew[tb] = reward;
      traj_done[tb] = done;
    }
    __syncthreads();
  }

  if (owner) {
    store_phys(st, pos_out, vel_out, s_out, sd_out, g);
    steps_out[g] = steps;
    episode_out[g] = episode;
    if constexpr (kMode == kModeDdpg) {
      noise_out[2 * g] = nx;
      noise_out[2 * g + 1] = ny;
    }
  }
  float* const fin = obs_out + static_cast<long>(env0) * F;
  for (int e = warp; e < n_env; e += kWarps)
    for (int k = lane; k < F; k += 32) fin[e * F + k] = obsb[e * ldo + k];
  cp_async_wait_all();  // the stream's prefetch of a next step's chunk
}

// Checks the dims against the env and the mode, and launches mode kMode
// on the stream. Returns a cudaError_t.
template <int kMode>
int launch_tile_rollout(
    const EnvConsts* consts, const QDims* dims, const float* params,
    const int* hidden, float* work, Explore x, int t0, int B, int T,
    const float* pos, const float* vel, const float* s, const float* sd,
    const int* steps, const int* episode, const int64_t* seed,
    const float* noise, const float* obs, float* traj_obs, void* traj_act,
    float* traj_rew, bool* traj_done, float* pos_out, float* vel_out,
    float* s_out, float* sd_out, int* steps_out, int* episode_out,
    float* noise_out, float* obs_out, void* stream) {
  constexpr bool kDiscrete = kMode == kModeDqn || kMode == kModePg;
  const EnvConsts& c = *consts;
  const QDims& d = *dims;
  if (B <= 0 || T < 0 || d.num_layers < 1 ||
      d.obs_dim != c.action_repeats * cp::kFrame || d.width < d.obs_dim ||
      d.wfloats <= 0 || d.wfloats % 4 != 0 ||
      (c.discrete_actions != 0) != kDiscrete ||
      (kMode == kModeDdpg && (noise == nullptr || noise_out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const QPlan p = make_plan(d);
  if (p.spill && work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(p.floats);
  auto kernel = p.spill ? tile_rollout_kernel<kMode, true>
                        : tile_rollout_kernel<kMode, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kTile - 1) / kTile;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      c, p, params, hidden, work, x, t0, B, T, pos, vel, s, sd, steps,
      episode, seed, noise, obs, traj_obs, traj_act, traj_rew, traj_done,
      pos_out, vel_out, s_out, sd_out, steps_out, episode_out, noise_out,
      obs_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
