// Device code shared by the policy-in-the-loop rollouts B2, B4, B6 and B8
// (q_tile.cuh's tile_rollout_kernel, built by policy_rollout.cu and
// q_rollout.cu): the tile constants (32 envs in one 256-thread block), the
// LayerNorm epsilon, and the env-state helpers of the thread that owns an
// env (its state loaded into registers, stored back, and one env.step
// written into its obs row).
#pragma once

#include "cartpole_env.cuh"

namespace {

constexpr int kTile = 32;       // envs per block
constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr float kLnEps = 1e-6f;  // flax.linen.LayerNorm default

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
