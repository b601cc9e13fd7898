// Kernels B4 and B8: a 5-action policy network inside the env loop, on
// Hopper. B4 is the DQN Q-net with epsilon-greedy exploration, B8 the LRPG
// softmax policy sampled by Gumbel-max; one kernel body, the exploration
// rule a compile-time mode.
//
// Replaces cartpoleplusplus_tpu/ops/policy_rollout.py::_q_rollout_kernel in
// its modes `dqn` (B4) and `lrpg` (B8) (the Pallas TPU kernel built by
// q_policy_rollout and pg_policy_rollout; its mode `naf`, which needs the
// continuous env, is kernel B6, a mode of B2's kernel in policy_rollout.cu).
// T env-steps with the network in the loop:
//   obs (B, F) -> [Dense + LayerNorm + relu] x L -> linear head (5)
//   -> B4: first-max argmax (a strict >, jnp.argmax's tie rule), then the
//      epsilon gate: uniform(env seed, global step, 0x43) < eps takes the
//      random action hash(env seed, global step, 0x44) % 5;
//      B8: first-max argmax of logits[a] + gumbel(env seed, global step,
//      0x47, a), an exact softmax sample
//   -> force table (noop, +x, -x, +y, -y) x action_force -> R x S
//   substeps -> termination, reward, masked auto-reset -> next obs;
// the trajectory (obs, action int32, reward, done) streams out per step,
// the final env state and obs at the end. The plain twins are
// ops/q_rollout.py::reference_q_rollout and
// ops/pg_rollout.py::reference_pg_rollout.
//
// Bound on the H100: the network's matrix products. B4 at hidden (256,
// 256): ~157 kFLOP per env-step, ~5 GFLOP per 4096-env x 8-step rollout,
// as in B2. B8 at hidden (64, 64): ~14 kFLOP per env-step, ~1.9 GFLOP per
// 4096 x 32 rollout, plus the physics substeps and 5 Gumbel draws (5
// hashes, 10 accurate logf) per env-step. Design: B2's (policy_tile.cuh,
// the same device code): one 256-thread block per tile of 32 envs,
// activations in shared memory, weights resident in L2, one thread per env
// holding its state in registers for all T steps. Exploration keeps no
// state between steps, so unlike B2 there is no noise carry.
#include "policy_tile.cuh"

namespace {

constexpr int kNumActions = 5;  // ops/q_rollout.py::NUM_ACTIONS

// -log(-log(u)), u = uniform(hash(seed, t, 0x47, a, 0xB2)) in [2^-24, 1):
// utils/prng.py::gumbel with ops/pg_rollout.py::TAG_PG_GUMBEL.
__device__ __forceinline__ float gumbel(uint32_t seed, uint32_t t, int a) {
  const float u = cp::uniform_from_bits(
      cp::hash_words(seed, t, 0x47u, static_cast<uint32_t>(a), 0xB2u),
      cp::kTwoM24, 1.0f - cp::kTwoM24);
  return -logf(-logf(u));
}

// q[e][a] = sum_k h[e][k] * W[k][a] + b[a], one warp per row.
__device__ __forceinline__ void head_linear(const float* __restrict__ W,
                                            const float* __restrict__ b,
                                            const float* h, int n, int ld,
                                            float* q) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int e = warp; e < kTile; e += kWarps) {
    for (int a = 0; a < kNumActions; ++a) {
      float s = 0.0f;
      for (int k = lane; k < n; k += 32)
        s = s + h[e * ld + k] * __ldg(W + k * kNumActions + a);
      s = warp_sum(s);
      if (lane == 0) q[e * kNumActions + a] = s + __ldg(b + a);
    }
  }
}

// kGumbel: B8's exploration (eps unused); otherwise B4's.
template <bool kGumbel>
__global__ void __launch_bounds__(kThreads) q_rollout_kernel(
    const EnvConsts c, const ActorDims d, const float* __restrict__ params,
    const float eps, const int t0, const int B, const int T,
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ s, const float* __restrict__ sd,
    const int* __restrict__ steps_in, const int* __restrict__ episode_in,
    const int64_t* __restrict__ seed_in, const float* __restrict__ obs_in,
    float* __restrict__ traj_obs, int* __restrict__ traj_act,
    float* __restrict__ traj_rew, bool* __restrict__ traj_done,
    float* __restrict__ pos_out, float* __restrict__ vel_out,
    float* __restrict__ s_out, float* __restrict__ sd_out,
    int* __restrict__ steps_out, int* __restrict__ episode_out,
    float* __restrict__ obs_out) {
  extern __shared__ float smem[];
  const int ld = d.width;
  const int F = d.obs_dim;
  float* const buf0 = smem;               // obs tile, then even layers
  float* const buf1 = smem + kTile * ld;  // odd layers
  float* const qv = buf1 + kTile * ld;    // (kTile, 5) Q values
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
  if (owner) {
    st = load_phys(pos, vel, s, sd, g);
    steps = steps_in[g];
    episode = episode_in[g];
    seed = static_cast<uint32_t>(seed_in[g]);
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // Trajectory obs = the pre-step observation (contiguous for the tile).
    store_obs_tile(traj_obs + (static_cast<size_t>(t) * B + env0) * F, buf0,
                   n_env, F, ld);

    // Q-net forward over the tile.
    const TorsoOut tor = torso_forward(d, params, buf0, buf1);
    const float* h = tor.h;
    const float* p = tor.head;
    const int n_in = d.hidden[d.num_layers - 1];
    head_linear(p, p + n_in * kNumActions, h, n_in, ld, qv);
    __syncthreads();

    // The action (epsilon-greedy or Gumbel-max), force, physics, reward,
    // reset; next obs into buf0.
    if (owner) {
      const float* q = qv + e * kNumActions;
      const uint32_t tg = static_cast<uint32_t>(t0 + t);
      int action;
      if constexpr (kGumbel) {
        action = 0;
        float best = q[0] + gumbel(seed, tg, 0);
        for (int a = 1; a < kNumActions; ++a) {
          const float v = q[a] + gumbel(seed, tg, a);
          if (v > best) {  // strict: the first maximum wins ties
            best = v;
            action = a;
          }
        }
      } else {
        int greedy = 0;
        float best = q[0];
        for (int a = 1; a < kNumActions; ++a) {
          if (q[a] > best) {  // strict: the first maximum wins ties
            best = q[a];
            greedy = a;
          }
        }
        const bool explore =
            cp::uniform_from_bits(cp::hash_words(seed, tg, 0x43u), 0.0f,
                                  1.0f) < eps;
        action = explore ? static_cast<int>(cp::hash_words(seed, tg, 0x44u) %
                                            static_cast<uint32_t>(kNumActions))
                         : greedy;
      }
      const float dir_x = action == 1 ? 1.0f : (action == 2 ? -1.0f : 0.0f);
      const float dir_y = action == 3 ? 1.0f : (action == 4 ? -1.0f : 0.0f);
      const size_t tb = static_cast<size_t>(t) * B + g;
      traj_act[tb] = action;
      float reward;
      bool done;
      step_into_row(c, st, steps, episode, seed, dir_x * c.action_force,
                    dir_y * c.action_force, buf0 + e * ld, reward, done);
      traj_rew[tb] = reward;
      traj_done[tb] = done;
    }
    __syncthreads();
  }

  if (owner) {
    store_phys(st, pos_out, vel_out, s_out, sd_out, g);
    steps_out[g] = steps;
    episode_out[g] = episode;
  }
  store_obs_tile(obs_out + static_cast<size_t>(env0) * F, buf0, n_env, F,
                 ld);
}

// Checks the dims and launches mode kGumbel on the stream.
template <bool kGumbel>
int launch_rollout(const EnvConsts* consts, const ActorDims* dims,
                   const float* params, float eps, int t0, int B, int T,
                   const float* pos, const float* vel, const float* s,
                   const float* sd, const int* steps, const int* episode,
                   const int64_t* seed, const float* obs, float* traj_obs,
                   int* traj_act, float* traj_rew, bool* traj_done,
                   float* pos_out, float* vel_out, float* s_out,
                   float* sd_out, int* steps_out, int* episode_out,
                   float* obs_out, void* stream) {
  const ActorDims d = *dims;
  if (B <= 0 || T < 0 || d.num_layers < 1 || d.num_layers > kMaxLayers ||
      d.obs_dim != consts->action_repeats * cp::kFrame ||
      d.width < d.obs_dim || !consts->discrete_actions)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < d.num_layers; ++l)
    if (d.hidden[l] < 1 || d.hidden[l] > d.width)
      return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (2 * kTile * d.width + kTile * kNumActions);
  cudaError_t err = cudaFuncSetAttribute(
      q_rollout_kernel<kGumbel>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kTile - 1) / kTile;
  q_rollout_kernel<kGumbel><<<blocks, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      *consts, d, params, eps, t0, B, T, pos, vel, s, sd, steps, episode,
      seed, obs, traj_obs, traj_act, traj_rew, traj_done, pos_out, vel_out,
      s_out, sd_out, steps_out, episode_out, obs_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// params: the network packed as [W_l (in, out) row-major, b_l, scale_l,
// bias_l] per torso layer, then W_head (H, 5), b_head (5); float32.
// Trajectory outputs are time-major: obs (T, B, F), act (T, B) int32, rew
// and done (T, B). State arrays as in cp_fused_rollout; obs (B, F).
// B4: epsilon-greedy over the Q values.
int cp_q_rollout(const EnvConsts* consts, const ActorDims* dims,
                 const float* params, float eps, int t0, int B, int T,
                 const float* pos, const float* vel, const float* s,
                 const float* sd, const int* steps, const int* episode,
                 const int64_t* seed, const float* obs, float* traj_obs,
                 int* traj_act, float* traj_rew, bool* traj_done,
                 float* pos_out, float* vel_out, float* s_out, float* sd_out,
                 int* steps_out, int* episode_out, float* obs_out,
                 void* stream) {
  return launch_rollout<false>(consts, dims, params, eps, t0, B, T, pos, vel,
                               s, sd, steps, episode, seed, obs, traj_obs,
                               traj_act, traj_rew, traj_done, pos_out,
                               vel_out, s_out, sd_out, steps_out, episode_out,
                               obs_out, stream);
}

// B8: a Gumbel-max sample of the softmax over the logits. Same arguments
// as cp_q_rollout without eps.
int cp_pg_rollout(const EnvConsts* consts, const ActorDims* dims,
                  const float* params, int t0, int B, int T,
                  const float* pos, const float* vel, const float* s,
                  const float* sd, const int* steps, const int* episode,
                  const int64_t* seed, const float* obs, float* traj_obs,
                  int* traj_act, float* traj_rew, bool* traj_done,
                  float* pos_out, float* vel_out, float* s_out,
                  float* sd_out, int* steps_out, int* episode_out,
                  float* obs_out, void* stream) {
  return launch_rollout<true>(consts, dims, params, 0.0f, t0, B, T, pos, vel,
                              s, sd, steps, episode, seed, obs, traj_obs,
                              traj_act, traj_rew, traj_done, pos_out, vel_out,
                              s_out, sd_out, steps_out, episode_out, obs_out,
                              stream);
}

}  // extern "C"
