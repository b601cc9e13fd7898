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

// The head's partial sums: warp w sums features w, w + 8, ... of env
// `lane` for all 5 outputs into part[(w * 8 + a) * 32 + lane].
__device__ __forceinline__ void head_partials(const float* h, int H,
                                              const float* __restrict__ W,
                                              float* part, int warp,
                                              int lane) {
  float acc[kNumActions] = {};
#pragma unroll 4
  for (int k = warp; k < H; k += kWarps) {
    const float x = h[k * kLd + lane];
    const float4 w = __ldg(reinterpret_cast<const float4*>(W + k * kHeadLd));
    acc[0] = __fmaf_rn(x, w.x, acc[0]);
    acc[1] = __fmaf_rn(x, w.y, acc[1]);
    acc[2] = __fmaf_rn(x, w.z, acc[2]);
    acc[3] = __fmaf_rn(x, w.w, acc[3]);
    acc[4] = __fmaf_rn(x, __ldg(W + k * kHeadLd + 4), acc[4]);
  }
#pragma unroll
  for (int a = 0; a < kNumActions; ++a)
    part[(warp * kHeadLd + a) * kTile + lane] = acc[a];
}

// kGumbel: B8's exploration (eps unused); otherwise B4's. kSpill: the
// activations live in the block's slice of `work`.
template <bool kGumbel, bool kSpill>
__global__ void __launch_bounds__(kThreads, 1) q_rollout_kernel(
    const EnvConsts c, const QPlan p, const float* __restrict__ params,
    const int* __restrict__ hidden, float* __restrict__ work,
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
  // warp 0 owns env e's state for the whole rollout.
  const int g = env0 + lane;
  const bool live = lane < n_env;
  const uint32_t seed = live ? static_cast<uint32_t>(seed_in[g]) : 0u;
  const bool owner = warp == 0 && live;
  cp::Phys st{};
  int steps = 0, episode = 0;
  if (owner) {
    st = load_phys(pos, vel, s, sd, g);
    steps = steps_in[g];
    episode = episode_in[g];
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
    head_partials(h, H, head_w, part, warp, lane);
    const uint32_t tg = static_cast<uint32_t>(t0 + t);
    if constexpr (kGumbel) {
      if (warp < kNumActions)
        draws[lane * kDrawLd + warp] = gumbel(seed, tg, warp);
    }
    __syncthreads();

    // The action (first-max argmax of the outputs, plus B8's draws, then
    // B4's epsilon gate), force, physics, reward, reset; next obs into
    // obsb.
    if (owner) {
      int action = 0;
      float best = 0.0f;
#pragma unroll
      for (int a = 0; a < kNumActions; ++a) {
        float v = part[a * kTile + lane];
#pragma unroll
        for (int w = 1; w < kWarps; ++w)
          v = v + part[(w * kHeadLd + a) * kTile + lane];
        v = v + __ldg(head_b + a);
        if constexpr (kGumbel) v = v + draws[lane * kDrawLd + a];
        if (a == 0 || v > best) {  // strict: the first maximum wins ties
          best = v;
          action = a;
        }
      }
      if constexpr (!kGumbel) {
        const bool explore =
            cp::uniform_from_bits(cp::hash_words(seed, tg, 0x43u), 0.0f,
                                  1.0f) < eps;
        if (explore)
          action = static_cast<int>(cp::hash_words(seed, tg, 0x44u) %
                                    static_cast<uint32_t>(kNumActions));
      }
      const float dir_x = action == 1 ? 1.0f : (action == 2 ? -1.0f : 0.0f);
      const float dir_y = action == 3 ? 1.0f : (action == 4 ? -1.0f : 0.0f);
      const long tb = static_cast<long>(t) * B + g;
      traj_act[tb] = action;
      float reward;
      bool done;
      step_into_row(c, st, steps, episode, seed, dir_x * c.action_force,
                    dir_y * c.action_force, obsb + lane * ldo, reward, done);
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
  float* const fin = obs_out + static_cast<long>(env0) * F;
  for (int e = warp; e < n_env; e += kWarps)
    for (int k = lane; k < F; k += 32) fin[e * F + k] = obsb[e * ldo + k];
  cp_async_wait_all();  // the stream's prefetch of a next step's chunk
}

bool dims_ok(const EnvConsts& c, const QDims& d) {
  return d.num_layers >= 1 && d.obs_dim == c.action_repeats * cp::kFrame &&
         d.width >= d.obs_dim && d.wfloats > 0 && d.wfloats % 4 == 0 &&
         c.discrete_actions;
}

// Checks the dims and launches mode kGumbel on the stream.
template <bool kGumbel>
int launch_rollout(const EnvConsts* consts, const QDims* dims,
                   const float* params, const int* hidden, float* work,
                   float eps, int t0, int B, int T, const float* pos,
                   const float* vel, const float* s, const float* sd,
                   const int* steps, const int* episode, const int64_t* seed,
                   const float* obs, float* traj_obs, int* traj_act,
                   float* traj_rew, bool* traj_done, float* pos_out,
                   float* vel_out, float* s_out, float* sd_out,
                   int* steps_out, int* episode_out, float* obs_out,
                   void* stream) {
  if (B <= 0 || T < 0 || !dims_ok(*consts, *dims))
    return static_cast<int>(cudaErrorInvalidValue);
  const QPlan p = make_plan(*dims);
  if (p.spill && work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(p.floats);
  auto kernel = p.spill ? q_rollout_kernel<kGumbel, true>
                        : q_rollout_kernel<kGumbel, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kTile - 1) / kTile;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      *consts, p, params, hidden, work, eps, t0, B, T, pos, vel, s, sd, steps,
      episode, seed, obs, traj_obs, traj_act, traj_rew, traj_done, pos_out,
      vel_out, s_out, sd_out, steps_out, episode_out, obs_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Floats of the workspace a launch of B envs needs: 0 when a tile's
// activations fit in shared memory, else two (width x 36) buffers a block.
long long cp_q_workspace_floats(const QDims* dims, int B) {
  const QPlan p = make_plan(*dims);
  if (!p.spill) return 0;
  return static_cast<long long>((B + kTile - 1) / kTile) * 2 * kLd *
         dims->width;
}

// params (ops/q_rollout.py::pack_qnet): per torso layer W (in, Np)
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
  return launch_rollout<false>(consts, dims, params, hidden, work, eps, t0, B,
                               T, pos, vel, s, sd, steps, episode, seed, obs,
                               traj_obs, traj_act, traj_rew, traj_done,
                               pos_out, vel_out, s_out, sd_out, steps_out,
                               episode_out, obs_out, stream);
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
  return launch_rollout<true>(consts, dims, params, hidden, work, 0.0f, t0, B,
                              T, pos, vel, s, sd, steps, episode, seed, obs,
                              traj_obs, traj_act, traj_rew, traj_done,
                              pos_out, vel_out, s_out, sd_out, steps_out,
                              episode_out, obs_out, stream);
}

}  // extern "C"
