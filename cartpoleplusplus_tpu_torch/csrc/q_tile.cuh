// The network tile of kernels B4 and B8 (q_rollout.cu): a torso of any
// depth and width, [Dense + LayerNorm + relu] x L, over a tile of 32 envs
// in one 256-thread block, on Hopper.
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
// Weights. The packed torso weights (pack_qnet: W_l as (in, Np_l)
// row-major, Np_l the width rounded up to 4, zero-padded) are copied into
// shared memory once per launch when they fit ("resident": B8's (64, 64)
// is 29 KB). Otherwise they are streamed every env-step in chunks of 32
// rows x up to 256 columns through two shared-memory slots by cp.async,
// the next chunk in flight while the current one is multiplied; the
// chunk after the last torso chunk is the first of the next env-step.
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
constexpr int kHeadLd = 8;        // padded head width in pack_qnet
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

}  // namespace
