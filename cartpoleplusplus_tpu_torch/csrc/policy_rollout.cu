// Kernels B2 and B6: a 2-wide tanh policy head inside the continuous env
// loop, on Hopper. B2 is the DDPG actor with Ornstein-Uhlenbeck
// exploration, B6 the NAF mu head with Gaussian exploration; modes
// kModeDdpg and kModeNaf of the rollout body in q_tile.cuh, which B4 and
// B8 (q_rollout.cu) share.
//
// Replaces cartpoleplusplus_tpu/ops/policy_rollout.py::_policy_rollout_kernel
// (B2, the Pallas TPU kernel) and ::_q_rollout_kernel in its mode `naf`
// (B6, built by naf_policy_rollout; the reference runs it as a mode of its
// DQN rollout because neither carries noise; here all four rollouts share
// one body). T env-steps with the network in the loop:
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
// ops/naf_rollout.py::reference_naf_rollout. Any depth >= 1, any width,
// any batch (the last tile masked), as the reference's kernel takes.
//
// Bound on the H100. By operations: the network's products, ~76 k
// multiply-adds per env-step at hidden (256, 256), ~2.4 M per 32-env tile,
// ~11 us per env-step on one SM at its float32 FMA peak; below that the
// physics floor the ops bound does not see (one dependent chain per env,
// one thread per env, ~7.8 us per env-step at one warp per SM, kernel B1's
// rate). Design (q_tile.cuh): one 256-thread block per 32 envs; every
// thread works in the register-tiled products (weights resident in shared
// memory or streamed by cp.async, activations wider than shared memory
// holds in a workspace); the head's two sums are spread over all 8 warps
// and added in warp order by the env's owner, lane e of warp 0, which then
// runs the tanh, the noise, the clip and the env step.
#include "q_tile.cuh"

extern "C" {

// params (ops/q_rollout.py::pack_tile_net): per torso layer W (in, Np)
// row-major, Np = the width rounded up to 4 (zero columns); the head's W
// (H, 8) (zero columns past 2); then per layer bias, LayerNorm scale,
// LayerNorm bias; then the head's bias (2); float32. hidden: the L widths,
// int32 on the device. work: cp_q_workspace_floats floats, or null when
// that is 0. Trajectory outputs are time-major: obs (T, B, F), act (T, B,
// 2), rew and done (T, B). State arrays as in cp_fused_rollout; noise (B,
// 2), obs (B, F). B2: the DDPG actor with OU noise.
int cp_policy_rollout(const EnvConsts* consts, const QDims* dims,
                      const float* params, const int* hidden, float* work,
                      float ou_theta, float sigma, int t0, int B, int T,
                      const float* pos, const float* vel, const float* s,
                      const float* sd, const int* steps, const int* episode,
                      const int64_t* seed, const float* noise,
                      const float* obs, float* traj_obs, float* traj_act,
                      float* traj_rew, bool* traj_done, float* pos_out,
                      float* vel_out, float* s_out, float* sd_out,
                      int* steps_out, int* episode_out, float* noise_out,
                      float* obs_out, void* stream) {
  return launch_tile_rollout<kModeDdpg>(
      consts, dims, params, hidden, work, Explore{0.0f, ou_theta, sigma}, t0,
      B, T, pos, vel, s, sd, steps, episode, seed, noise, obs, traj_obs,
      traj_act, traj_rew, traj_done, pos_out, vel_out, s_out, sd_out,
      steps_out, episode_out, noise_out, obs_out, stream);
}

// B6: NAF's mu head (the torso and head rows mu0, mu1 in the layout above)
// with sigma-scaled counter normals. Same arguments as cp_policy_rollout
// without ou_theta and the noise in and out.
int cp_naf_rollout(const EnvConsts* consts, const QDims* dims,
                   const float* params, const int* hidden, float* work,
                   float sigma, int t0, int B, int T, const float* pos,
                   const float* vel, const float* s, const float* sd,
                   const int* steps, const int* episode, const int64_t* seed,
                   const float* obs, float* traj_obs, float* traj_act,
                   float* traj_rew, bool* traj_done, float* pos_out,
                   float* vel_out, float* s_out, float* sd_out,
                   int* steps_out, int* episode_out, float* obs_out,
                   void* stream) {
  return launch_tile_rollout<kModeNaf>(
      consts, dims, params, hidden, work, Explore{0.0f, 0.0f, sigma}, t0, B,
      T, pos, vel, s, sd, steps, episode, seed, nullptr, obs, traj_obs,
      traj_act, traj_rew, traj_done, pos_out, vel_out, s_out, sd_out,
      steps_out, episode_out, nullptr, obs_out, stream);
}

}  // extern "C"
