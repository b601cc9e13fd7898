// Device code shared by the policy-in-the-loop rollouts: kernels B2 and
// B6 (policy_rollout.cu, the DDPG actor and NAF's mu) use all of it; B4
// and B8 (q_rollout.cu, on q_tile.cuh) its tile constants and env-state
// helpers. B2 and B6 run one 256-thread block per tile of 32 envs: the tile's
// activations live in shared memory (two 32 x width float buffers), the
// weights are read from global memory and stay resident in L2, each thread
// owns one output column of a layer with the tile's 32 sums in registers,
// LayerNorm and the heads reduce with warp shuffles, and after the network
// one thread per env runs the env step with its state held in registers
// across all T steps.
#pragma once

#include "cartpole_env.cuh"

constexpr int kMaxLayers = 4;   // ops/_native.py::MAX_LAYERS

// Mirror of ops/_native.py::ActorDims. width = max(obs_dim, hidden...), the
// row stride of the shared-memory activation buffers. (Outside the unnamed
// namespace: the exported launchers take it.)
struct ActorDims {
  int num_layers, obs_dim, width;
  int hidden[kMaxLayers];
};

namespace {

constexpr int kTile = 32;       // envs per block
constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr float kLnEps = 1e-6f;  // flax.linen.LayerNorm default

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[e][j] = sum_k in[e][k] * W[k][j] + b[j] for the tile's kTile rows.
// W is (n_in, n_out) row-major, rows of in/out are ld floats apart.
__device__ __forceinline__ void dense(const float* __restrict__ W,
                                      const float* __restrict__ b,
                                      const float* in, int n_in, float* out,
                                      int n_out, int ld) {
  for (int j = threadIdx.x; j < n_out; j += kThreads) {
    float acc[kTile];
#pragma unroll
    for (int e = 0; e < kTile; ++e) acc[e] = 0.0f;
    for (int k = 0; k < n_in; ++k) {
      const float w = __ldg(W + static_cast<size_t>(k) * n_out + j);
#pragma unroll
      for (int e = 0; e < kTile; ++e) acc[e] = acc[e] + in[e * ld + k] * w;
    }
    const float bj = __ldg(b + j);
#pragma unroll
    for (int e = 0; e < kTile; ++e) out[e * ld + j] = acc[e] + bj;
  }
}

// flax LayerNorm (one-pass variance) then relu, in place, one warp per row.
__device__ __forceinline__ void layer_norm_relu(float* h, int n, int ld,
                                                const float* __restrict__ scale,
                                                const float* __restrict__ bias) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int e = warp; e < kTile; e += kWarps) {
    float* row = h + e * ld;
    float s = 0.0f, s2 = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float v = row[j];
      s = s + v;
      s2 = s2 + v * v;
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mean = s / static_cast<float>(n);
    const float mean2 = s2 / static_cast<float>(n);
    const float var = fmaxf(mean2 - mean * mean, 0.0f);
    const float inv = 1.0f / sqrtf(var + kLnEps);
    for (int j = lane; j < n; j += 32) {
      const float y = (row[j] - mean) * (inv * __ldg(scale + j)) + __ldg(bias + j);
      row[j] = fmaxf(y, 0.0f);
    }
  }
}

// The torso [Dense + LayerNorm + relu] x L over the tile whose inputs are
// in buf0, ping-ponging with buf1. params: per layer W (in, out) row-major,
// bias, LayerNorm scale, LayerNorm bias. Returns the buffer holding the
// last layer's activations and the head's parameters (past the torso's).
// The dims come by value and the pointers go back by value: taking the
// kernel's parameter struct by reference and returning the head pointer
// through an out-parameter gave the same bits and registers but made B2
// 1.4x slower on the H100.
struct TorsoOut {
  const float* h;
  const float* head;
};

__device__ __forceinline__ TorsoOut torso_forward(const ActorDims d,
                                                  const float* params,
                                                  float* buf0, float* buf1) {
  const float* p = params;
  float* in = buf0;
  float* out = buf1;
  int n_in = d.obs_dim;
  const int ld = d.width;
  for (int l = 0; l < d.num_layers; ++l) {
    const int h = d.hidden[l];
    const float* W = p;
    const float* b = W + n_in * h;
    const float* scale = b + h;
    const float* bias = scale + h;
    p = bias + h;
    dense(W, b, in, n_in, out, h, ld);
    __syncthreads();
    layer_norm_relu(out, h, ld, scale, bias);
    __syncthreads();
    float* tmp = in;
    in = out;
    out = tmp;
    n_in = h;
  }
  return TorsoOut{in, p};
}

// The tile's rows of obs (B, F) -> buf0 (kTile x ld), zero past F and
// past the last env.
__device__ __forceinline__ void load_obs_tile(float* buf0,
                                              const float* __restrict__ obs,
                                              int env0, int n_env, int F,
                                              int ld) {
  for (int idx = threadIdx.x; idx < kTile * ld; idx += kThreads) {
    const int e = idx / ld, k = idx % ld;
    buf0[idx] = (e < n_env && k < F)
                    ? obs[static_cast<size_t>(env0 + e) * F + k]
                    : 0.0f;
  }
}

// buf0's n_env obs rows -> dst (n_env x F, contiguous).
__device__ __forceinline__ void store_obs_tile(float* dst, const float* buf0,
                                               int n_env, int F, int ld) {
  for (int idx = threadIdx.x; idx < n_env * F; idx += kThreads)
    dst[idx] = buf0[(idx / F) * ld + idx % F];
}

__device__ __forceinline__ cp::Phys load_phys(const float* __restrict__ pos,
                                              const float* __restrict__ vel,
                                              const float* __restrict__ s,
                                              const float* __restrict__ sd,
                                              int g) {
  return cp::Phys{pos[3 * g],  pos[3 * g + 1], pos[3 * g + 2], vel[3 * g],
                  vel[3 * g + 1], vel[3 * g + 2], s[2 * g], s[2 * g + 1],
                  sd[2 * g],   sd[2 * g + 1]};
}

__device__ __forceinline__ void store_phys(const cp::Phys& st, float* pos,
                                           float* vel, float* s, float* sd,
                                           int g) {
  pos[3 * g] = st.x;
  pos[3 * g + 1] = st.y;
  pos[3 * g + 2] = st.z;
  vel[3 * g] = st.vx;
  vel[3 * g + 1] = st.vy;
  vel[3 * g + 2] = st.vz;
  s[2 * g] = st.sx;
  s[2 * g + 1] = st.sy;
  sd[2 * g] = st.sdx;
  sd[2 * g + 1] = st.sdy;
}

// One env.step of a thread-owned env under the forces (fx, fy): the R
// repeats' pose frames become the env's next obs in `row`, or, when the
// episode ended, the fresh episode's initial pose repeated R times.
__device__ __forceinline__ void step_into_row(const EnvConsts& c,
                                              cp::Phys& st, int& steps,
                                              int& episode, uint32_t seed,
                                              float fx, float fy, float* row,
                                              float& reward, bool& done) {
  cp::env_step(
      c, st, steps, episode, seed, fx, fy,
      [&](int r, const cp::Phys& ph) {
        cp::frame_components(c, ph, row + r * cp::kFrame);
      },
      reward, done);
  if (done) {
    float fresh[cp::kFrame];
    cp::frame_components(c, st, fresh);
    for (int r = 0; r < c.action_repeats; ++r)
      for (int k = 0; k < cp::kFrame; ++k) row[r * cp::kFrame + k] = fresh[k];
  }
}

}  // namespace
