// Kernel B2: the DDPG actor inside the env loop, on Hopper.
//
// Replaces cartpoleplusplus_tpu/ops/policy_rollout.py::_policy_rollout_kernel
// (the Pallas TPU kernel). T env-steps with the actor in the loop:
//   obs (B, F) -> [Dense + LayerNorm + relu] x L -> tanh head (2)
//   -> + OU noise (counter normals keyed by (env seed, global step), scaled
//   by sigma) -> clip -> force -> R x S substeps -> termination, reward,
//   masked auto-reset -> next obs;
// the trajectory (obs, action, reward, done) streams out per step, the
// final env state, noise and obs at the end.
//
// Bound on the H100: the actor's matrix products, ~153 kFLOP per env-step
// at hidden (256, 256), i.e. ~5 GFLOP per 4096-env x 8-step rollout; the
// physics is ~1 kFLOP per env-step. Design (simple and exact first): one
// 256-thread block per tile of 32 envs (4096 envs -> 128 blocks on 132
// SMs). The tile's activations live in shared memory (two 32 x width
// float buffers, 64 KB at width 256, so the launcher opts in to more than
// 48 KB of dynamic shared memory). The weights are read from global memory
// and stay resident in the 50 MB L2 (~300 KB at hidden 256). Each thread
// owns one output column of a layer and keeps the tile's 32 sums in
// registers; the activation reads are shared-memory broadcasts. LayerNorm
// and the head reduce with warp shuffles. After the actor, one thread per
// env runs OU, clip, physics and reset with its env state held in
// registers across all T steps. All matrix products stay inside this
// kernel; wgmma and TMA are later work.
#include "cartpole_env.cuh"

constexpr int kMaxLayers = 4;   // ops/_native.py::MAX_LAYERS

// Mirror of ops/_native.py::ActorDims. width = max(obs_dim, hidden...), the
// row stride of the shared-memory activation buffers. (Outside the unnamed
// namespace: the exported launcher takes it.)
struct ActorDims {
  int num_layers, obs_dim, width;
  int hidden[kMaxLayers];
};

namespace {

constexpr int kTile = 32;       // envs per block
constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kActDim = 2;
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

// mu[e][a] = tanh(sum_k h[e][k] * W[k][a] + b[a]), one warp per row.
__device__ __forceinline__ void head_tanh(const float* __restrict__ W,
                                          const float* __restrict__ b,
                                          const float* h, int n, int ld,
                                          float* mu) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int e = warp; e < kTile; e += kWarps) {
    for (int a = 0; a < kActDim; ++a) {
      float s = 0.0f;
      for (int k = lane; k < n; k += 32)
        s = s + h[e * ld + k] * __ldg(W + k * kActDim + a);
      s = warp_sum(s);
      if (lane == 0) mu[e * kActDim + a] = tanhf(s + __ldg(b + a));
    }
  }
}

__global__ void __launch_bounds__(kThreads) policy_rollout_kernel(
    const EnvConsts c, const ActorDims d, const float* __restrict__ params,
    const float ou_theta, const float sigma, const int t0, const int B,
    const int T, const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ s, const float* __restrict__ sd,
    const int* __restrict__ steps_in, const int* __restrict__ episode_in,
    const int64_t* __restrict__ seed_in, const float* __restrict__ noise_in,
    const float* __restrict__ obs_in, float* __restrict__ traj_obs,
    float* __restrict__ traj_act, float* __restrict__ traj_rew,
    bool* __restrict__ traj_done, float* __restrict__ pos_out,
    float* __restrict__ vel_out, float* __restrict__ s_out,
    float* __restrict__ sd_out, int* __restrict__ steps_out,
    int* __restrict__ episode_out, float* __restrict__ noise_out,
    float* __restrict__ obs_out) {
  extern __shared__ float smem[];
  const int ld = d.width;
  const int F = d.obs_dim;
  float* const buf0 = smem;               // obs tile, then even layers
  float* const buf1 = smem + kTile * ld;  // odd layers
  float* const mu = buf1 + kTile * ld;    // (kTile, 2) actor output
  const int env0 = blockIdx.x * kTile;
  const int n_env = min(kTile, B - env0);

  for (int idx = threadIdx.x; idx < kTile * ld; idx += kThreads) {
    const int e = idx / ld, k = idx % ld;
    buf0[idx] = (e < n_env && k < F)
                    ? obs_in[static_cast<size_t>(env0 + e) * F + k]
                    : 0.0f;
  }
  // Thread e < n_env owns env env0 + e for the whole rollout.
  const int e = threadIdx.x;
  const bool owner = e < n_env;
  const int g = env0 + e;
  cp::Phys st{};
  int steps = 0, episode = 0;
  uint32_t seed = 0;
  float nx = 0.0f, ny = 0.0f;
  if (owner) {
    st = cp::Phys{pos[3 * g],  pos[3 * g + 1], pos[3 * g + 2], vel[3 * g],
                  vel[3 * g + 1], vel[3 * g + 2], s[2 * g], s[2 * g + 1],
                  sd[2 * g],   sd[2 * g + 1]};
    steps = steps_in[g];
    episode = episode_in[g];
    seed = static_cast<uint32_t>(seed_in[g]);
    nx = noise_in[2 * g];
    ny = noise_in[2 * g + 1];
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // Trajectory obs = the pre-step observation (contiguous for the tile).
    float* tobs = traj_obs + (static_cast<size_t>(t) * B + env0) * F;
    for (int idx = threadIdx.x; idx < n_env * F; idx += kThreads)
      tobs[idx] = buf0[(idx / F) * ld + idx % F];

    // Actor forward over the tile.
    const float* p = params;
    float* in = buf0;
    float* out = buf1;
    int n_in = F;
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
    head_tanh(p, p + n_in * kActDim, in, n_in, ld, mu);
    __syncthreads();

    // OU exploration, clip, physics, reward, reset; next obs into buf0.
    if (owner) {
      const uint32_t tg = static_cast<uint32_t>(t0 + t);
      const float eps_x = cp::normal(seed, tg, 0x41u);
      const float eps_y = cp::normal(seed, tg, 0x42u);
      nx = nx + ou_theta * (0.0f - nx) + sigma * eps_x;
      ny = ny + ou_theta * (0.0f - ny) + sigma * eps_y;
      const float ax = cp::clampf(mu[e * kActDim] + nx, -1.0f, 1.0f);
      const float ay = cp::clampf(mu[e * kActDim + 1] + ny, -1.0f, 1.0f);
      const size_t tb = static_cast<size_t>(t) * B + g;
      traj_act[2 * tb] = ax;
      traj_act[2 * tb + 1] = ay;
      float* row = buf0 + e * ld;
      float reward;
      bool done;
      cp::env_step(
          c, st, steps, episode, seed, ax * c.action_force,
          ay * c.action_force,
          [&](int r, const cp::Phys& ph) {
            cp::frame_components(c, ph, row + r * cp::kFrame);
          },
          reward, done);
      if (done) {  // a fresh episode observes its initial pose R times
        float fresh[cp::kFrame];
        cp::frame_components(c, st, fresh);
        for (int r = 0; r < c.action_repeats; ++r)
          for (int k = 0; k < cp::kFrame; ++k) row[r * cp::kFrame + k] = fresh[k];
        nx = 0.0f;
        ny = 0.0f;
      }
      traj_rew[tb] = reward;
      traj_done[tb] = done;
    }
    __syncthreads();
  }

  if (owner) {
    pos_out[3 * g] = st.x;
    pos_out[3 * g + 1] = st.y;
    pos_out[3 * g + 2] = st.z;
    vel_out[3 * g] = st.vx;
    vel_out[3 * g + 1] = st.vy;
    vel_out[3 * g + 2] = st.vz;
    s_out[2 * g] = st.sx;
    s_out[2 * g + 1] = st.sy;
    sd_out[2 * g] = st.sdx;
    sd_out[2 * g + 1] = st.sdy;
    steps_out[g] = steps;
    episode_out[g] = episode;
    noise_out[2 * g] = nx;
    noise_out[2 * g + 1] = ny;
  }
  float* oout = obs_out + static_cast<size_t>(env0) * F;
  for (int idx = threadIdx.x; idx < n_env * F; idx += kThreads)
    oout[idx] = buf0[(idx / F) * ld + idx % F];
}

}  // namespace

extern "C" {

// params: the actor packed as [W_l (in, out) row-major, b_l, scale_l,
// bias_l] per torso layer, then W_head (H, 2), b_head (2); float32.
// Trajectory outputs are time-major: obs (T, B, F), act (T, B, 2), rew and
// done (T, B). State arrays as in cp_fused_rollout; noise (B, 2), obs (B, F).
int cp_policy_rollout(const EnvConsts* consts, const ActorDims* dims,
                      const float* params, float ou_theta, float sigma, int t0,
                      int B, int T, const float* pos, const float* vel,
                      const float* s, const float* sd, const int* steps,
                      const int* episode, const int64_t* seed,
                      const float* noise, const float* obs, float* traj_obs,
                      float* traj_act, float* traj_rew, bool* traj_done,
                      float* pos_out, float* vel_out, float* s_out,
                      float* sd_out, int* steps_out, int* episode_out,
                      float* noise_out, float* obs_out, void* stream) {
  const ActorDims d = *dims;
  if (B <= 0 || T < 0 || d.num_layers < 1 || d.num_layers > kMaxLayers ||
      d.obs_dim != consts->action_repeats * cp::kFrame || d.width < d.obs_dim)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < d.num_layers; ++l)
    if (d.hidden[l] < 1 || d.hidden[l] > d.width)
      return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (2 * kTile * d.width + kTile * kActDim);
  cudaError_t err = cudaFuncSetAttribute(
      policy_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kTile - 1) / kTile;
  policy_rollout_kernel<<<blocks, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      *consts, d, params, ou_theta, sigma, t0, B, T, pos, vel, s, sd, steps,
      episode, seed, noise, obs, traj_obs, traj_act, traj_rew, traj_done,
      pos_out, vel_out, s_out, sd_out, steps_out, episode_out, noise_out,
      obs_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
