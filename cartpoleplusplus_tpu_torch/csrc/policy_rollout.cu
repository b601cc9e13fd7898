// Kernels B2 and B6: a 2-wide tanh policy head inside the continuous env
// loop, on Hopper. B2 is the DDPG actor with Ornstein-Uhlenbeck
// exploration, B6 the NAF mu head with Gaussian exploration; one kernel
// body, the exploration rule a compile-time mode.
//
// Replaces cartpoleplusplus_tpu/ops/policy_rollout.py::_policy_rollout_kernel
// (B2, the Pallas TPU kernel) and ::_q_rollout_kernel in its mode `naf`
// (B6, built by naf_policy_rollout; the reference runs it as a mode of its
// DQN rollout because neither carries noise, but the port's DQN kernel
// takes the discrete env only). T env-steps with the network in the loop:
//   obs (B, F) -> [Dense + LayerNorm + relu] x L -> tanh head (2)
//   -> B2: + OU noise (counter normals keyed by (env seed, global step,
//      0x41/0x42), scaled by sigma; the OU state of a finished episode
//      restarts at 0);
//      B6: + sigma * normal(env seed, global step, 0x45/0x46), no noise
//      state between steps
//   -> clip -> force -> R x S substeps -> termination, reward,
//   masked auto-reset -> next obs;
// the trajectory (obs, action, reward, done) streams out per step, the
// final env state (and B2's noise) and obs at the end. The plain twins are
// ops/policy_rollout.py::reference_policy_rollout and
// ops/naf_rollout.py::reference_naf_rollout.
//
// Bound on the H100: the network's matrix products, ~153 kFLOP per
// env-step at hidden (256, 256), i.e. ~5 GFLOP per 4096-env x 8-step
// rollout; the physics is ~1 kFLOP per env-step. Design (simple and exact
// first): one 256-thread block per tile of 32 envs (4096 envs -> 128
// blocks on 132 SMs), with the tile machinery of policy_tile.cuh (shared
// with B4 and B8): the tile's activations in shared memory (64 KB at width
// 256, so the launcher opts in to more than 48 KB of dynamic shared
// memory), the weights (~300 KB at hidden 256) resident in the 50 MB L2,
// one thread per output column with the tile's 32 sums in registers,
// warp-shuffle LayerNorm. After the network, one thread per env runs the
// exploration, clip, physics and reset with its env state held in
// registers across all T steps. All matrix products stay inside this
// kernel; wgmma and TMA are later work.
#include "policy_tile.cuh"

namespace {

constexpr int kActDim = 2;

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

// kNaf: B6's exploration (ou_theta, noise_in and noise_out unused);
// otherwise B2's.
template <bool kNaf>
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

  load_obs_tile(buf0, obs_in, env0, n_env, F, ld);
  // Thread e < n_env owns env env0 + e for the whole rollout.
  const int e = threadIdx.x;
  const bool owner = e < n_env;
  const int g = env0 + e;
  cp::Phys st{};
  int steps = 0, episode = 0;
  uint32_t seed = 0;
  float nx = 0.0f, ny = 0.0f;
  if (owner) {
    st = load_phys(pos, vel, s, sd, g);
    steps = steps_in[g];
    episode = episode_in[g];
    seed = static_cast<uint32_t>(seed_in[g]);
    if constexpr (!kNaf) {
      nx = noise_in[2 * g];
      ny = noise_in[2 * g + 1];
    }
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // Trajectory obs = the pre-step observation (contiguous for the tile).
    store_obs_tile(traj_obs + (static_cast<size_t>(t) * B + env0) * F, buf0,
                   n_env, F, ld);

    // Actor forward over the tile.
    const TorsoOut tor = torso_forward(d, params, buf0, buf1);
    const float* h = tor.h;
    const float* p = tor.head;
    const int n_in = d.hidden[d.num_layers - 1];
    head_tanh(p, p + n_in * kActDim, h, n_in, ld, mu);
    __syncthreads();

    // Exploration, clip, physics, reward, reset; next obs into buf0.
    if (owner) {
      const uint32_t tg = static_cast<uint32_t>(t0 + t);
      if constexpr (kNaf) {
        nx = cp::normal(seed, tg, 0x45u) * sigma;
        ny = cp::normal(seed, tg, 0x46u) * sigma;
      } else {
        const float eps_x = cp::normal(seed, tg, 0x41u);
        const float eps_y = cp::normal(seed, tg, 0x42u);
        nx = nx + ou_theta * (0.0f - nx) + sigma * eps_x;
        ny = ny + ou_theta * (0.0f - ny) + sigma * eps_y;
      }
      const float ax = cp::clampf(mu[e * kActDim] + nx, -1.0f, 1.0f);
      const float ay = cp::clampf(mu[e * kActDim + 1] + ny, -1.0f, 1.0f);
      const size_t tb = static_cast<size_t>(t) * B + g;
      traj_act[2 * tb] = ax;
      traj_act[2 * tb + 1] = ay;
      float reward;
      bool done;
      step_into_row(c, st, steps, episode, seed, ax * c.action_force,
                    ay * c.action_force, buf0 + e * ld, reward, done);
      if (!kNaf && done) {  // the OU state of a finished episode restarts
        nx = 0.0f;        // at 0
        ny = 0.0f;
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
    if constexpr (!kNaf) {
      noise_out[2 * g] = nx;
      noise_out[2 * g + 1] = ny;
    }
  }
  store_obs_tile(obs_out + static_cast<size_t>(env0) * F, buf0, n_env, F,
                 ld);
}

// Checks the dims and launches mode kNaf on the stream.
template <bool kNaf>
int launch_rollout(const EnvConsts* consts, const ActorDims* dims,
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
  if (kNaf && consts->discrete_actions)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < d.num_layers; ++l)
    if (d.hidden[l] < 1 || d.hidden[l] > d.width)
      return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (2 * kTile * d.width + kTile * kActDim);
  cudaError_t err = cudaFuncSetAttribute(
      policy_rollout_kernel<kNaf>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kTile - 1) / kTile;
  policy_rollout_kernel<kNaf><<<blocks, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      *consts, d, params, ou_theta, sigma, t0, B, T, pos, vel, s, sd, steps,
      episode, seed, noise, obs, traj_obs, traj_act, traj_rew, traj_done,
      pos_out, vel_out, s_out, sd_out, steps_out, episode_out, noise_out,
      obs_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// params: the network packed as [W_l (in, out) row-major, b_l, scale_l,
// bias_l] per torso layer, then W_head (H, 2), b_head (2); float32.
// Trajectory outputs are time-major: obs (T, B, F), act (T, B, 2), rew and
// done (T, B). State arrays as in cp_fused_rollout; noise (B, 2), obs (B, F).
// B2: the DDPG actor with OU noise.
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
  return launch_rollout<false>(consts, dims, params, ou_theta, sigma, t0, B,
                               T, pos, vel, s, sd, steps, episode, seed,
                               noise, obs, traj_obs, traj_act, traj_rew,
                               traj_done, pos_out, vel_out, s_out, sd_out,
                               steps_out, episode_out, noise_out, obs_out,
                               stream);
}

// B6: NAF's mu head (the torso and head rows mu0, mu1 in the layout above)
// with sigma-scaled counter normals. Same arguments as cp_policy_rollout
// without ou_theta and the noise in and out.
int cp_naf_rollout(const EnvConsts* consts, const ActorDims* dims,
                   const float* params, float sigma, int t0, int B, int T,
                   const float* pos, const float* vel, const float* s,
                   const float* sd, const int* steps, const int* episode,
                   const int64_t* seed, const float* obs, float* traj_obs,
                   float* traj_act, float* traj_rew, bool* traj_done,
                   float* pos_out, float* vel_out, float* s_out, float* sd_out,
                   int* steps_out, int* episode_out, float* obs_out,
                   void* stream) {
  return launch_rollout<true>(consts, dims, params, 0.0f, sigma, t0, B, T,
                              pos, vel, s, sd, steps, episode, seed, nullptr,
                              obs, traj_obs, traj_act, traj_rew, traj_done,
                              pos_out, vel_out, s_out, sd_out, steps_out,
                              episode_out, nullptr, obs_out, stream);
}

}  // extern "C"
