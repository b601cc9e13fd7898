// Kernels B4 and B8: a 5-action policy network inside the env loop, on
// Hopper. B4 is the DQN Q-net with epsilon-greedy exploration, B8 the LRPG
// softmax policy sampled by Gumbel-max; modes kModeDqn and kModePg of the
// rollout body in q_tile.cuh, which B2 and B6 (policy_rollout.cu) share.
//
// Replaces cartpoleplusplus_tpu/ops/policy_rollout.py::_q_rollout_kernel in
// its modes `dqn` (B4) and `lrpg` (B8) (the Pallas TPU kernel built by
// q_policy_rollout and pg_policy_rollout; its mode `naf`, which needs the
// continuous env, is kernel B6, entry cp_naf_rollout of policy_rollout.cu).
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
// ops/pg_rollout.py::reference_pg_rollout. Any depth >= 1, any width, any
// batch (the last tile masked), as the reference's kernel takes.
//
// Bound on the H100. By operations: B4 at hidden (256, 256) does ~78 k
// multiply-adds per env-step, ~2.5 M per 32-env tile, ~11 us per step on
// one SM at its float32 FMA peak; B8 at (64, 64) ~7 k, ~1 us. Below that
// sits a floor the ops bound does not see: the physics is one dependent
// chain per env (R x S substeps), one thread per env, ~7.8 us per env-step
// at one warp per SM (kernel B1's rate). Design (q_tile.cuh): one 256-
// thread block per 32 envs; every thread works in the products (register
// tiles, weights resident in shared memory or streamed by cp.async); the
// head's sums are spread over all 8 warps (a slice of its features each)
// and B8's Gumbel draws over one thread per (env, action) pair beside
// them; then warp 0 runs the physics, one thread per env, its state in
// registers for all T steps.
#include "q_tile.cuh"

extern "C" {

// Floats of the workspace a launch of B envs needs (B2, B4, B6 and B8): 0
// when a tile's activations fit in shared memory, else two (width x 36)
// buffers a block.
long long cp_q_workspace_floats(const QDims* dims, int B) {
  const QPlan p = make_plan(*dims);
  if (!p.spill) return 0;
  return static_cast<long long>((B + kTile - 1) / kTile) * 2 * kLd *
         dims->width;
}

// params (ops/q_rollout.py::pack_tile_net): per torso layer W (in, Np)
// row-major, Np = the width rounded up to 4 (zero columns); the head's W
// (H, 8) (zero columns past 5); then per layer bias, LayerNorm scale,
// LayerNorm bias; then the head's bias (5); float32. hidden: the L widths,
// int32 on the device. work: cp_q_workspace_floats floats, or null when
// that is 0. Trajectory outputs are time-major: obs (T, B, F), act (T, B)
// int32, rew and done (T, B). State arrays as in cp_fused_rollout; obs
// (B, F). B4: epsilon-greedy over the Q values.
int cp_q_rollout(const EnvConsts* consts, const QDims* dims,
                 const float* params, const int* hidden, float* work,
                 float eps, int t0, int B, int T, const float* pos,
                 const float* vel, const float* s, const float* sd,
                 const int* steps, const int* episode, const int64_t* seed,
                 const float* obs, float* traj_obs, int* traj_act,
                 float* traj_rew, bool* traj_done, float* pos_out,
                 float* vel_out, float* s_out, float* sd_out, int* steps_out,
                 int* episode_out, float* obs_out, void* stream) {
  return launch_tile_rollout<kModeDqn>(
      consts, dims, params, hidden, work, Explore{eps, 0.0f, 0.0f}, t0, B, T,
      pos, vel, s, sd, steps, episode, seed, nullptr, obs, traj_obs,
      traj_act, traj_rew, traj_done, pos_out, vel_out, s_out, sd_out,
      steps_out, episode_out, nullptr, obs_out, stream);
}

// B8: a Gumbel-max sample of the softmax over the logits. Same arguments
// as cp_q_rollout without eps.
int cp_pg_rollout(const EnvConsts* consts, const QDims* dims,
                  const float* params, const int* hidden, float* work,
                  int t0, int B, int T, const float* pos, const float* vel,
                  const float* s, const float* sd, const int* steps,
                  const int* episode, const int64_t* seed, const float* obs,
                  float* traj_obs, int* traj_act, float* traj_rew,
                  bool* traj_done, float* pos_out, float* vel_out,
                  float* s_out, float* sd_out, int* steps_out,
                  int* episode_out, float* obs_out, void* stream) {
  return launch_tile_rollout<kModePg>(
      consts, dims, params, hidden, work, Explore{}, t0, B, T, pos, vel, s,
      sd, steps, episode, seed, nullptr, obs, traj_obs, traj_act, traj_rew,
      traj_done, pos_out, vel_out, s_out, sd_out, steps_out, episode_out,
      nullptr, obs_out, stream);
}

}  // extern "C"
