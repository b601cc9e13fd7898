// Kernel B1: the physics-only benchmark rollout on Hopper.
//
// Replaces cartpoleplusplus_tpu/ops/fused_rollout.py::_rollout_kernel (the
// Pallas TPU kernel). T env-steps for B envs: the counter-PRNG benchmark
// action, R x S substeps with pushes, the pose-frame checksum, termination,
// reward and masked auto-reset; final state and a scalar checksum out.
//
// Bound on the H100: each env is one serial chain of R x S substeps per
// env-step (375 for 25 steps at the defaults), so the kernel is bound by
// that chain's dependent latency, not by operations or bytes (4096 chains
// fill 128 warps: one per SM, whichever layout). More lanes per env or
// envs per SM do not shorten a chain; fewer cycles per substep do, and
// cp::env_step's exact fast forms (csrc/cartpole_env.cuh) give them.
//
// Design: one thread per env keeps its 13 state words in registers across
// all T steps (the TPU kernel kept them in VMEM); 32-thread blocks spread
// 4096 envs over 128 of the 132 SMs. One launch: each thread sums its
// steps in double, each block its threads in a fixed tree into a partial,
// and the block that finishes last (an integer ticket in the launch's own
// workspace, no float atomics) sums the partials in a fixed order (256
// strided sums, then a tree), so the checksum is deterministic.
#include "cartpole_env.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kSumWidth = 256;  // the checksum's fixed reduction tree

__device__ __forceinline__ void bench_action_force(const EnvConsts& c,
                                                   uint32_t seed, uint32_t t,
                                                   float& fx, float& fy) {
  if (c.discrete_actions) {
    const uint32_t idx = cp::hash_words(seed, t, 0x31u) % 5u;
    fx = (idx == 1u ? 1.0f : 0.0f) - (idx == 2u ? 1.0f : 0.0f);
    fy = (idx == 3u ? 1.0f : 0.0f) - (idx == 4u ? 1.0f : 0.0f);
    fx = fx * c.action_force;
    fy = fy * c.action_force;
  } else {
    fx = cp::uniform_from_bits(cp::hash_words(seed, t, 0x31u), -1.0f, 2.0f) *
         c.action_force;
    fy = cp::uniform_from_bits(cp::hash_words(seed, t, 0x32u), -1.0f, 2.0f) *
         c.action_force;
  }
}

// The checksum: this block's partial from its threads' sums (a fixed
// tree), and in the block that takes the last ticket the sum of all
// partials in a fixed order: kSumWidth strided sums, then a tree.
__device__ __forceinline__ void fold_checksum(double acc,
                                              double* __restrict__ partials,
                                              unsigned int* __restrict__ ticket,
                                              float* __restrict__ checksum) {
  __shared__ double red[kSumWidth];
  __shared__ bool last;
  const int tid = threadIdx.x;
  red[tid] = acc;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  if (tid == 0) {
    partials[blockIdx.x] = red[0];
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int n = gridDim.x;
  for (int v = tid; v < kSumWidth; v += kThreads) {
    double a = 0.0;
    for (int k = v; k < n; k += kSumWidth) a += __ldcg(partials + k);
    red[v] = a;
  }
  __syncthreads();
  for (int w = kSumWidth / 2; w > 0; w >>= 1) {
    for (int v = tid; v < w; v += kThreads) red[v] += red[v + w];
    __syncthreads();
  }
  if (tid == 0) *checksum = static_cast<float>(red[0]);
}

__global__ void __launch_bounds__(kThreads) fused_rollout_kernel(
    const EnvConsts c, const int B, const int T,
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ s, const float* __restrict__ sd,
    const int* __restrict__ steps_in, const int* __restrict__ episode_in,
    const int64_t* __restrict__ seed_in, float* __restrict__ pos_out,
    float* __restrict__ vel_out, float* __restrict__ s_out,
    float* __restrict__ sd_out, int* __restrict__ steps_out,
    int* __restrict__ episode_out, double* __restrict__ partials,
    unsigned int* __restrict__ ticket, float* __restrict__ checksum) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  double acc = 0.0;
  if (i < B) {
    cp::Phys st{pos[3 * i],     pos[3 * i + 1], pos[3 * i + 2],
                vel[3 * i],     vel[3 * i + 1], vel[3 * i + 2],
                s[2 * i],       s[2 * i + 1],   sd[2 * i],
                sd[2 * i + 1]};
    int steps = steps_in[i];
    int episode = episode_in[i];
    const uint32_t seed = static_cast<uint32_t>(seed_in[i]);
    for (int t = 0; t < T; ++t) {
      float fx, fy;
      bench_action_force(c, seed, static_cast<uint32_t>(t), fx, fy);
      float frames = 0.0f;
      float reward;
      bool done;
      cp::env_step(
          c, st, steps, episode, seed, fx, fy,
          [&](int, const cp::Phys& ph) {
            float f[cp::kFrame];
            cp::frame_components(c, ph, f);
            float sum = f[0];
            for (int k = 1; k < cp::kFrame; ++k) sum = sum + f[k];
            frames = frames + sum;
          },
          reward, done);
      acc += static_cast<double>(frames) + static_cast<double>(reward);
    }
    pos_out[3 * i] = st.x;
    pos_out[3 * i + 1] = st.y;
    pos_out[3 * i + 2] = st.z;
    vel_out[3 * i] = st.vx;
    vel_out[3 * i + 1] = st.vy;
    vel_out[3 * i + 2] = st.vz;
    s_out[2 * i] = st.sx;
    s_out[2 * i + 1] = st.sy;
    sd_out[2 * i] = st.sdx;
    sd_out[2 * i + 1] = st.sdy;
    steps_out[i] = steps;
    episode_out[i] = episode;
  }
  fold_checksum(acc, partials, ticket, checksum);
}

}  // namespace

extern "C" {

const char* cp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Float64 words of a launch's workspace: one checksum partial per block,
// then one word whose low 4 bytes are the launch's block ticket.
int cp_fused_rollout_workspace(int B) {
  return (B + kThreads - 1) / kThreads + 1;
}

// State arrays are row-major: pos/vel (B, 3), s/sd (B, 2) float32;
// steps/episode (B,) int32; seed (B,) int64 holding uint32 values.
// `work` holds cp_fused_rollout_workspace(B) doubles, owned by this launch
// until it ends; its ticket is zeroed here, on the stream.
int cp_fused_rollout(const EnvConsts* consts, int B, int T, const float* pos,
                     const float* vel, const float* s, const float* sd,
                     const int* steps, const int* episode,
                     const int64_t* seed, float* pos_out, float* vel_out,
                     float* s_out, float* sd_out, int* steps_out,
                     int* episode_out, double* work, float* checksum,
                     void* stream) {
  if (B <= 0 || T < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = cp_fused_rollout_workspace(B) - 1;
  unsigned int* ticket = reinterpret_cast<unsigned int*>(work + blocks);
  cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_rollout_kernel<<<blocks, kThreads, 0, st>>>(
      *consts, B, T, pos, vel, s, sd, steps, episode, seed, pos_out, vel_out,
      s_out, sd_out, steps_out, episode_out, work, ticket, checksum);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
