// The shared pieces of the cooperative learner kernels B3 (ddpg_update.cu),
// B5 (dqn_update.cu) and B7 (naf_update.cu), whose row chains are
// row_chain.cuh, and of B9 (lrpg_update.cu): the stage clock of the
// instrumented build, the mirrors of the host's structures (NetLayout,
// Torso, LearnerConsts), the device table's copy in shared memory, the
// LayerNorm statistics, Adam and Polyak on a few elements, the gradient ops of
// a network (net_grad_op) and the loss's reduction, the clipped update's
// scale and Adam (adam_flat), and the cooperative launch.
//   * Every element of a gradient is one thread's sum over the batch in a
//     fixed order, then Adam and Polyak on that element in the same thread.
//     No float atomics anywhere, so two runs on the same inputs give the
//     same bits.
// Parameters, targets and moments are read and written in place in their
// group buffers (ops/learner_kernel.py documents the layout). The depth
// and the widths are data: a device int32 table made once per shape
// (ops/learner_kernel.py::_learner_table) holds the widths, their prefix
// sums (where a layer's rows sit in a per-layer region of the workspace)
// and every network's parameter offsets, so a kernel takes any depth; a
// block copies it into shared memory at the start of a launch. The library
// is built with --fmad=false; the matrix-product and batch-sum inner loops
// use explicit fmaf(), every elementwise formula follows the plain twins
// operation by operation.
#pragma once

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>

#ifdef CP_STAGE_CLOCK
// A separate build that measures how a kernel's time splits (chip_smoke.py's
// stage split; the library the wrappers load never defines this): thread 0
// of every block records clock64() when the kernel starts and when every
// grid barrier is reached and left (cg::grid_group below stands in for
// cooperative_groups' own), and where a kernel marks the end of one of its
// phases (CP_MARK(id), id 3 to 15, right after a block barrier; a kernel
// without a grid barrier marks its start with CP_MARK_START). One kernel
// source per library: the buffers and the readers are defined here.
namespace cp_clock {
constexpr int kBlocks = 512, kMarks = 2048;
enum : int { kRelease = 0, kArrive = 2 };
static __device__ long long marks[kBlocks * kMarks];
static __device__ int counts[kBlocks];

// The block's count of marks, in shared memory (set by start()).
__device__ __forceinline__ int& count() {
  __shared__ int n;
  return n;
}

// Mark (clock << 4 | kind) for this block, by thread 0: a shared-memory
// count and two stores, nothing that waits on device memory.
__device__ __forceinline__ void mark(int kind) {
  if (threadIdx.x != 0 || blockIdx.x >= kBlocks) return;
  const int n = count();
  if (n >= kMarks) return;
  marks[blockIdx.x * kMarks + n] = (clock64() << 4) | kind;
  counts[blockIdx.x] = n + 1;
  count() = n + 1;
}

// The kernel's start: the count reset, and a first mark.
__device__ __forceinline__ void start() {
  if (threadIdx.x == 0) count() = 0;
  mark(kRelease);
}

struct grid_group {
  cooperative_groups::grid_group g;
  __device__ void sync() {
    __syncthreads();
    mark(kArrive);
    g.sync();
    mark(kRelease);
  }
};

__device__ inline grid_group this_grid() {
  start();
  return grid_group{cooperative_groups::this_grid()};
}
}  // namespace cp_clock
namespace cg = cp_clock;
#define CP_MARK(id) cp_clock::mark(id)
#define CP_MARK_START() cp_clock::start()

// The marks of the last launch: counts (kBlocks ints) and marks (kBlocks x
// kMarks, block-major); reset zeroes the counts. Return a cudaError_t.
extern "C" int cp_stage_clock_read(long long* marks, int* counts) {
  cudaError_t err = cudaMemcpyFromSymbol(counts, cp_clock::counts,
                                         sizeof(cp_clock::counts));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(marks, cp_clock::marks,
                               sizeof(cp_clock::marks));
  return static_cast<int>(err);
}
extern "C" int cp_stage_clock_reset() {
  static const int zeros[cp_clock::kBlocks] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(cp_clock::counts, zeros, sizeof(zeros)));
}
#else
namespace cg = cooperative_groups;
#define CP_MARK(id)
#define CP_MARK_START()
#endif

// Mirror of ops/_native.py::NetLayout: element offsets of one network's
// parameters in its group buffer. lay (device): per torso layer l,
// lay[4 l .. 4 l + 3] = the offsets of W_l, b_l, LayerNorm scale_l and
// LayerNorm bias_l; wh, bh: the head's W and b; size: the group's floats.
struct NetLayout {
  const int* lay;
  int wh, bh, size;
  __device__ int w(int l) const { return lay[4 * l]; }
  __device__ int b(int l) const { return lay[4 * l + 1]; }
  __device__ int s(int l) const { return lay[4 * l + 2]; }
  __device__ int t(int l) const { return lay[4 * l + 3]; }
};

// Mirror of ops/_native.py::Torso: the torso's depth L and its widths on
// the device, tab[l] = H_l and tab[L + l] = H_0 + ... + H_{l-1} (layer l's
// offset, in rows of the batch, in a per-layer region of the workspace).
struct Torso {
  const int* tab;
  int L;
  __device__ int h(int l) const { return tab[l]; }
  __device__ int at(int l) const { return tab[L + l]; }
};

// Mirror of ops/_native.py::LearnerConsts: the float32 constants, folded
// on the host (ops/learner_kernel.py::_learner_consts). B5's single net is
// net 0 and takes actor_lr.
struct LearnerConsts {
  float gamma, tau, inv_batch, two_inv_batch, neg_inv_batch, b1, omb1, b2,
      omb2, eps, log_b1, log_b2, ln_eps, actor_lr, critic_lr, sched_steps,
      actor_lr_delta, critic_lr_delta;
  int sched;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNormParts = 256;         // slices of a flat gradient

enum : int { kGradW = 0, kGradV = 1, kGradLoss = 2 };

// One gradient of a network, reduced over the batch and applied with Adam
// (and Polyak) in place (row_chain.cuh's grad_stage). W: g (B, out), x (B,
// in) -> dW (out, in). V: sum over b of g (B, out). Loss: scale * sum over
// b of g (or g^2).
struct GradOp {
  int kind, net, out, in, off, sq;
  const float* g;
  const float* x;
  float scale;
  float* dst;
};

struct NetPtr {
  float *p, *tgt, *m, *v;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// The products' mode (ops/learner_kernel.py::mm_mode, the reference's
// learner_precision): a template parameter M of the product helpers and of
// every learner kernel, which the launchers instantiate per mode. Every
// product site computes acc = mm_fma<M>(mm_in<M>(a), mm_in<M>(b), acc) from
// acc = 0, k in order, and stores mm_out<M>(acc) where the dot's result
// goes on (ops/learner_kernel.py's docstring states the modes once):
//   kMmF32: float32 operands (the code as it was before the modes).
//   kMmBf16: each operand rounded to bfloat16, to nearest, ties to even.
//   kMmTf32: each operand rounded to TF32's 10 mantissa bits, to nearest,
//     ties away from zero (as cvt.rna.tf32.f32).
//   kMmX3, kMmX6 (BF16_BF16_F32_X3 and _X6): each operand split into
//     bfloat16 parts (mm_split), and the 3 or 6 part products added into
//     the float32 chain, the smallest first: X3 lo.hi, hi.lo, hi.hi; X6
//     mid.mid, lo.hi, hi.lo, mid.hi, hi.mid, hi.hi.
//   kMmF64: both operands widened to double, the products and their sum a
//     DFMA chain in double, rounded once to float32 by mm_out.
//   kMmF16 (F16_F16_F16): each operand rounded to float16 (to nearest
//     even, float16's range), products and sums in float32, the dot's
//     result rounded to float16 by mm_out.
// A product of two rounded operands or parts is exact in float32 (in
// double at kMmF64), so each step of the chain rounds once.
enum : int {
  kMmF32 = 0,
  kMmBf16 = 1,
  kMmTf32 = 2,
  kMmX3 = 3,
  kMmX6 = 4,
  kMmF64 = 5,
  kMmF16 = 6,
  kMmModes = 7
};

__host__ __device__ inline bool mm_ok(int m) { return m >= 0 && m < kMmModes; }

// Every mode's instance of a learner kernel template, indexed by mode. The
// last four are built two by two in translation units of their own (the
// source with CP_MM_PRESET_UNIT 1 or 2), so that they compile beside the
// others: x3x6(m) and f64f16(m) return them. A stage-clock build
// (chip_smoke.py's stage split, which times the float32 kernels)
// instantiates the float32 one alone.
#ifdef CP_STAGE_CLOCK
#define CP_MM_INSTANCES(kernel, x3x6, f64f16)                             \
  {                                                                       \
    reinterpret_cast<const void*>(kernel<kMmF32>), nullptr, nullptr,      \
        nullptr, nullptr, nullptr, nullptr                                \
  }
#else
#define CP_MM_INSTANCES(kernel, x3x6, f64f16)                             \
  {                                                                       \
    reinterpret_cast<const void*>(kernel<kMmF32>),                        \
        reinterpret_cast<const void*>(kernel<kMmBf16>),                   \
        reinterpret_cast<const void*>(kernel<kMmTf32>), x3x6(kMmX3),      \
        x3x6(kMmX6), f64f16(kMmF64), f64f16(kMmF16)                       \
  }
#endif

// X3's bfloat16 parts of an operand: hi = bf16(x), lo = bf16(x - hi).
struct MmX3 {
  float hi, lo;
};
// X6's: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid).
struct MmX6 {
  float hi, mid, lo;
};

// The type an operand enters a product as (mm_in), and the chain's.
template <int M>
struct MmTypes {
  using In = float;
  using Acc = float;
};
template <>
struct MmTypes<kMmX3> {
  using In = MmX3;
  using Acc = float;
};
template <>
struct MmTypes<kMmX6> {
  using In = MmX6;
  using Acc = float;
};
template <>
struct MmTypes<kMmF64> {
  using In = double;
  using Acc = double;
};
template <int M>
using mm_in_t = typename MmTypes<M>::In;
template <int M>
using mm_acc_t = typename MmTypes<M>::Acc;

// x rounded to bfloat16 by integer operations on its float32 bits (to
// nearest, ties to even; a NaN unchanged, an infinity to itself, a value
// past bfloat16's largest to the infinity).
__device__ __forceinline__ float bf16_rn(float x) {
  const unsigned u = __float_as_uint(x);
  const float r = __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) &
                                  0xffff0000u);
  return x != x ? x : r;
}

// The parts' residual: x - hi (exact in float32), or 0 where hi is not
// finite (x a NaN or an infinity, or rounded past bfloat16's largest), so
// that such an x goes whole into hi.
__device__ __forceinline__ float mm_rest(float x, float hi) {
  return fabsf(hi) < __uint_as_float(0x7f800000u) ? x - hi : 0.0f;
}

// x as mode M takes it into a product (ops/learner_kernel.py's
// round_operand and split_operand).
template <int M>
__device__ __forceinline__ mm_in_t<M> mm_in(float x) {
  if constexpr (M == kMmF32) {
    return x;
  } else if constexpr (M == kMmBf16) {
    return bf16_rn(x);
  } else if constexpr (M == kMmTf32) {
    const unsigned u = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    return x != x ? x : __uint_as_float(u);
  } else if constexpr (M == kMmF16) {
    return __half2float(__float2half_rn(x));
  } else if constexpr (M == kMmF64) {
    return static_cast<double>(x);
  } else if constexpr (M == kMmX3) {
    const float hi = bf16_rn(x);
    return MmX3{hi, bf16_rn(mm_rest(x, hi))};
  } else {
    const float hi = bf16_rn(x);
    const float r = mm_rest(x, hi);
    const float mid = bf16_rn(r);
    return MmX6{hi, mid, bf16_rn(r - mid)};
  }
}

// acc + a b as mode M forms it: one fmaf (one DFMA at kMmF64), or the part
// products added one by one, the smallest first.
template <int M>
__device__ __forceinline__ mm_acc_t<M> mm_fma(const mm_in_t<M>& a,
                                              const mm_in_t<M>& b,
                                              mm_acc_t<M> acc) {
  if constexpr (M == kMmX3) {
    acc = fmaf(a.lo, b.hi, acc);
    acc = fmaf(a.hi, b.lo, acc);
    return fmaf(a.hi, b.hi, acc);
  } else if constexpr (M == kMmX6) {
    acc = fmaf(a.mid, b.mid, acc);
    acc = fmaf(a.lo, b.hi, acc);
    acc = fmaf(a.hi, b.lo, acc);
    acc = fmaf(a.mid, b.hi, acc);
    acc = fmaf(a.hi, b.mid, acc);
    return fmaf(a.hi, b.hi, acc);
  } else if constexpr (M == kMmF64) {
    return fma(a, b, static_cast<double>(acc));
  } else {
    return fmaf(a, b, acc);
  }
}

// A dot's result as it goes on: float32 (kMmF64 rounds its double sum once;
// kMmF16 rounds to float16).
template <int M>
__device__ __forceinline__ float mm_out(mm_acc_t<M> acc) {
  if constexpr (M == kMmF16)
    return __half2float(__float2half_rn(acc));
  else
    return static_cast<float>(acc);
}

// --- the tensor cores' products ---------------------------------------------
//
// B9 at kMmBf16, kMmTf32, kMmF16, kMmX3 and kMmX6 (mm_tc), and B3 at
// kMmBf16, kMmX3 and kMmF16 (ddpg_update.cu's kTcMode), form every product
// with
// mma.sync instead of the fmaf chains above: m16n8k16 on bfloat16 or
// float16 operands, m16n8k8 on TF32 ones, float32 sums. The operands enter
// as mm_in rounds or splits them (mma_pack, tf32_bits: the same bits,
// packed two bfloat16 or float16 values a register), so every product is
// exact, as in the chains. A k-block is 16 terms (8 at TF32); at X3 and X6
// its part products are mmas in the twins' order, the smallest first
// (mm_part); B9 adds each into the running float32 sum in the tensor core
// (kAccChain), B3 adds each, made from zero, on the CUDA cores (kAccPass).
// The dot's result goes on as mm_out gives it (F16: rounded to float16).
// Bound at these modes (PERF.md §6): the products at the peak for their
// operand type (989 TFLOP/s bfloat16 and float16, 495 TF32) take B9's
// window ~5 us and B3's phase 6-89 us, so the float32 rest and, in B3,
// the row chain's weight streaming set the pace. The fragments follow
// PTX's layouts for mma.m16n8k16 and .m16n8k8 (lane l: g = l / 4, t = l %
// 4): A's registers hold rows g and g + 8 at k 2t, 2t + 1 (+ 8); B's, k 2t,
// 2t + 1 (+ 8) at column g; D's, rows g and g + 8 at columns 2t, 2t + 1.
// A zero outside the product pads every edge (mma_floats' functions).

// A build with CP_MM_FFMA defined keeps every mode on the fmaf chains (the
// instances as they were before the tensor cores): chip_smoke.py builds
// B3's and B9's sources so, apart, as phase 32's yardstick; the library
// the wrappers load never defines it.
#ifdef CP_MM_FFMA
template <int M>
inline constexpr bool mm_tc = false;
#else
template <int M>
inline constexpr bool mm_tc = M == kMmBf16 || M == kMmTf32 ||
                              M == kMmF16 || M == kMmX3 || M == kMmX6;
#endif
template <int M>
inline constexpr int kMmaK = M == kMmTf32 ? 8 : 16;   // k of one mma
template <int M>
inline constexpr int kMmaParts = M == kMmX3 ? 2 : M == kMmX6 ? 3 : 1;
// The id a learner kernel's instance writes where its dims ask for it
// (LearnerDims::instance in ddpg_update.cu, PgDims::instance in
// lrpg_update.cu): its mode, plus kMmTcId where its products run on the
// tensor cores (ops/learner_kernel.py::last_instance reads it).
constexpr int kMmTcId = 16;
template <int M, bool kTc>
inline constexpr int kMmInstance = M | (kTc ? kMmTcId : 0);

__host__ __device__ constexpr bool mm_tc_mode(int m) {
  return m == kMmBf16 ? mm_tc<kMmBf16>
         : m == kMmTf32 ? mm_tc<kMmTf32>
         : m == kMmF16  ? mm_tc<kMmF16>
         : m == kMmX3   ? mm_tc<kMmX3>
                        : m == kMmX6 && mm_tc<kMmX6>;
}
__host__ __device__ constexpr int mm_parts(int m) {
  return m == kMmX3 ? 2 : m == kMmX6 ? 3 : 1;
}

// The part of the left (side 0) or right (side 1) operand in pass p of
// mode m (ops/learner_kernel.py's _PASSES; parts 0 hi, 1 lo at X3 or mid
// at X6, 2 lo): X3 lo.hi, hi.lo, hi.hi; X6 mid.mid, lo.hi, hi.lo, mid.hi,
// hi.mid, hi.hi; one pass of part 0 at the other modes.
__host__ __device__ constexpr int mm_part(int m, int p, int side) {
  const int code = m == kMmX3   ? (side == 0 ? 0x001 : 0x010)
                   : m == kMmX6 ? (side == 0 ? 0x001021 : 0x010201)
                                : 0;
  return (code >> (4 * p)) & 15;
}
__host__ __device__ constexpr int mm_passes(int m) {
  return m == kMmX3 ? 3 : m == kMmX6 ? 6 : 1;
}

// bf16_rn(lo) and bf16_rn(hi) packed (lo in the low half) by one
// conversion (round to nearest even, as bf16_rn; a NaN quiet).
__device__ __forceinline__ unsigned cvt_bf16x2(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
// The float32 values of a packed pair's halves.
__device__ __forceinline__ float bf16_lo(unsigned p) {
  return __uint_as_float(p << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned p) {
  return __uint_as_float(p & 0xffff0000u);
}

// x as a TF32 operand's register (mm_in<kMmTf32>'s bits; a NaN quiet).
__device__ __forceinline__ unsigned tf32_bits(float x) {
  const float r = mm_in<kMmTf32>(x);
  return r != r ? 0x7fc00000u : __float_as_uint(r);
}

// Elements x0 (k) and x1 (k + 1) of an operand as mode M takes them, packed
// two 16-bit values a register (x0 low): p[i] = part i (kMmBf16, kMmF16:
// the rounded operand; X3: hi, lo; X6: hi, mid, lo).
// (Each part is what mm_in gives, by the hardware's conversions: a
// residual is taken where its part is finite, as mm_rest.)
template <int M>
__device__ __forceinline__ void mma_pack(float x0, float x1,
                                         unsigned (&p)[kMmaParts<M>]) {
  if constexpr (M == kMmF16) {
    const __half2 h = __floats2half2_rn(x0, x1);
    p[0] = *reinterpret_cast<const unsigned*>(&h);
  } else if constexpr (M == kMmBf16) {
    p[0] = cvt_bf16x2(x0, x1);
  } else if constexpr (M == kMmX3 || M == kMmX6) {
    p[0] = cvt_bf16x2(x0, x1);
    float r0 = mm_rest(x0, bf16_lo(p[0])), r1 = mm_rest(x1, bf16_hi(p[0]));
    p[1] = cvt_bf16x2(r0, r1);
    if constexpr (M == kMmX6) {
      r0 = r0 - bf16_lo(p[1]);
      r1 = r1 - bf16_hi(p[1]);
      p[2] = cvt_bf16x2(r0, r1);
    }
  }
}

// An operand given by its float32 elements: f(i, k) = element (i, k) of A
// (i a row), or element (k, i) of B (i a column), 0 outside the product;
// converted as the fragments are loaded. A source gives a b16 mode's pair
// of elements (i, k), (i, k + 1) (k even) as packed parts (pair), and
// TF32's as two registers (two).
template <int M, class F>
struct MmaFloats {
  F f;
  __device__ __forceinline__ void two(int i, int k, unsigned& lo,
                                      unsigned& hi) const {
    lo = tf32_bits(f(i, k));
    hi = tf32_bits(f(i, k + 1));
  }
  __device__ __forceinline__ void pair(int i, int k,
                                       unsigned (&p)[kMmaParts<M>]) const {
    mma_pack<M>(f(i, k), f(i, k + 1), p);
  }
};
template <int M, class F>
__device__ __forceinline__ MmaFloats<M, F> mma_floats(F f) {
  return MmaFloats<M, F>{f};
}

// As MmaFloats, where f2(i, k) (k even) gives elements k and k + 1 at once
// (one 8-byte load where they lie side by side); f(i, k) one element.
template <int M, class F, class F2>
struct MmaPairs {
  F f;
  F2 f2;
  __device__ __forceinline__ void two(int i, int k, unsigned& lo,
                                      unsigned& hi) const {
    const float2 v = f2(i, k);
    lo = tf32_bits(v.x);
    hi = tf32_bits(v.y);
  }
  __device__ __forceinline__ void pair(int i, int k,
                                       unsigned (&p)[kMmaParts<M>]) const {
    const float2 v = f2(i, k);
    mma_pack<M>(v.x, v.y, p);
  }
};
template <int M, class F, class F2>
__device__ __forceinline__ MmaPairs<M, F, F2> mma_pairs(F f, F2 f2) {
  return MmaPairs<M, F, F2>{f, f2};
}

// An operand packed in shared memory as mode M's parts, planes of `plane`
// words: a pair (i, k), (i, k + 1) one word at p[(k / 2) ld + i] (b16
// modes), an element (i, k) at p[k ld + i] (TF32).
template <int M>
struct MmaPacked {
  const unsigned* p;
  int ld, plane;
  __device__ __forceinline__ void two(int i, int k, unsigned& lo,
                                      unsigned& hi) const {
    lo = p[k * ld + i];
    hi = p[(k + 1) * ld + i];
  }
  __device__ __forceinline__ void pair(int i, int k,
                                       unsigned (&o)[kMmaParts<M>]) const {
#pragma unroll
    for (int q = 0; q < kMmaParts<M>; ++q)
      o[q] = p[q * plane + (k >> 1) * ld + i];
  }
};

// One k-block's fragments: A (16 x kMmaK) and B (kMmaK x 8), per part.
template <int M>
struct MmaA {
  unsigned r[kMmaParts<M>][4];
};
template <int M>
struct MmaB {
  unsigned r[kMmaParts<M>][2];
};

// A's fragment at rows m0 .., k k0 ..; s: a source (MmaFloats, or packed
// parts) of A's elements.
// At TF32 (m16n8k8) a lane's k slots t and t + 4 take the block's inputs
// 2t and 2t + 1, in A and in B alike (a block's sum does not depend on the
// order of its terms), so that the two lie side by side.
template <int M, class S>
__device__ __forceinline__ MmaA<M> mma_load_a(const S& s, int m0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  MmaA<M> a;
  if constexpr (M == kMmTf32) {
    s.two(m0 + g, k0 + 2 * t, a.r[0][0], a.r[0][2]);
    s.two(m0 + g + 8, k0 + 2 * t, a.r[0][1], a.r[0][3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      unsigned p[kMmaParts<M>];
      s.pair(m0 + g + (q & 1) * 8, k0 + 2 * t + (q >> 1) * 8, p);
#pragma unroll
      for (int i = 0; i < kMmaParts<M>; ++i) a.r[i][q] = p[i];
    }
  }
  return a;
}

// B's fragment at columns n0 .., k k0 ..; s(i, k): element (k, i) of B.
template <int M, class S>
__device__ __forceinline__ MmaB<M> mma_load_b(const S& s, int n0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  MmaB<M> b;
  if constexpr (M == kMmTf32) {
    s.two(n0 + g, k0 + 2 * t, b.r[0][0], b.r[0][1]);
  } else {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      unsigned p[kMmaParts<M>];
      s.pair(n0 + g, k0 + 2 * t + q * 8, p);
#pragma unroll
      for (int i = 0; i < kMmaParts<M>; ++i) b.r[i][q] = p[i];
    }
  }
  return b;
}

// d = a b + c, one mma.
template <int M>
__device__ __forceinline__ void mma_op(float (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2],
                                       const float (&c)[4]) {
  if constexpr (M == kMmTf32)
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %11, %12, %13};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
  else if constexpr (M == kMmF16)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %11, %12, %13};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %11, %12, %13};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// How a product's k-blocks reach its float32 sum (mma_add's kAcc; PERF.md
// §6 has the readings behind each kernel's choice):
//   kAccChain (B9): every mma takes the running sum as its C, so the
//     tensor core adds each block's products (at X3 and X6 each part
//     product, in turn) into the sum, aligning them to it and dropping
//     low bits.
//   kAccPass (B3, and the tensor-core probe): each part product of each
//     k-block one mma from zero, added on the CUDA cores (round to
//     nearest): the tensor core's own rounding stays within 16 products
//     (8 at TF32). With exact blocks its bits are mma_chain's, so the
//     probe holds the fragments, the parts and their order bit for bit.
enum : int { kAccChain = 0, kAccPass = 1 };

// acc += A B over one k-block: mode M's part products in order (mm_part)
// as kAcc adds them. kSwap: A holds the twin's right operand (B its left),
// so the passes take the parts the other way round.
template <int M, bool kSwap, int kAcc>
__device__ __forceinline__ void mma_add(const MmaA<M>& a, const MmaB<M>& b,
                                        float (&acc)[4]) {
  constexpr int kL = kSwap ? 1 : 0;
#pragma unroll
  for (int p = 0; p < mm_passes(M); ++p) {
    const unsigned(&ra)[4] = a.r[mm_part(M, p, kL)];
    const unsigned(&rb)[2] = b.r[mm_part(M, p, 1 - kL)];
    if constexpr (kAcc == kAccChain) {
      mma_op<M>(acc, ra, rb, acc);
    } else {
      const float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float d[4];
      mma_op<M>(d, ra, rb, z);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = acc[q] + d[q];
    }
  }
}

// LayerNorm statistics of one row (one-pass variance, as the twin).
__device__ __forceinline__ void ln_stats(const float* row, int n, float eps,
                                         int lane, float& mu, float& inv) {
  float s1 = 0.0f, s2 = 0.0f;
  for (int i = lane; i < n; i += 32) {
    const float v = row[i];
    s1 = s1 + v;
    s2 = s2 + v * v;
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  mu = s1 / static_cast<float>(n);
  const float var = s2 / static_cast<float>(n) - mu * mu;
  inv = 1.0f / sqrtf(var + eps);
}

// --- gradients --------------------------------------------------------------

struct AdamStep {
  float bc1, bc2, lr[2];   // lr per net: 0 actor, 1 critic
};

// Adam (optax.adam's update, operation by operation) and Polyak on N
// elements (off[i], gradient g[i]) of a network where ok[i]: every moment,
// parameter and target read first, so that the reads overlap.
template <int N>
__device__ __forceinline__ void adam_elems(const NetPtr& n, const int* off,
                                           const bool* ok, const float* g,
                                           float bc1, float bc2, float lr,
                                           const LearnerConsts& c) {
  float m[N], v[N], p[N], t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (!ok[i]) continue;
    m[i] = n.m[off[i]];
    v[i] = n.v[off[i]];
    p[i] = n.p[off[i]];
    t[i] = n.tgt[off[i]];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (!ok[i]) continue;
    const float mi = c.b1 * m[i] + c.omb1 * g[i];
    const float vi = c.b2 * v[i] + c.omb2 * (g[i] * g[i]);
    const float pi = p[i] - lr * (mi / bc1) / (sqrtf(vi / bc2) + c.eps);
    n.m[off[i]] = mi;
    n.v[off[i]] = vi;
    n.p[off[i]] = pi;
    n.tgt[off[i]] = t[i] + c.tau * (pi - t[i]);
  }
}

// The loss of a network's gradient list (kGradLoss): *dst = scale * the
// sum over the batch of g (or g^2 when sq), each thread summing a strided
// share, thread 0 the shares in order.
__device__ void loss_item(const GradOp& op, int B, float* sm) {
  const int tid = threadIdx.x;
  float s = 0.0f;
  for (int b = tid; b < B; b += kThreads) {
    const float v = op.g[b];
    s = s + (op.sq ? v * v : v);
  }
  sm[tid] = s;
  __syncthreads();
  if (tid == 0) {
    float total = 0.0f;
    for (int i = 0; i < kThreads; ++i) total = total + sm[i];
    *op.dst = op.scale * total;
  }
  __syncthreads();
}

// --- a clipped update (a global-norm clip) ---------------------------------

// optax.clip_by_global_norm then Adam and Polyak on every element of the
// flat gradient g[0, n) of `net`: the norm is the square root of the
// partials summed in order (the same bits in every block; read into shared
// memory by all threads first), the scale 1 below max_norm and max_norm /
// norm at or above it.
static_assert(kNormParts == kThreads, "a partial a thread");
__device__ void adam_flat(const float* g, int n, const float* parts,
                          float max_norm, const NetPtr& net,
                          const AdamStep& as, float lr,
                          const LearnerConsts& c, float* sm) {
  sm[threadIdx.x] = parts[threadIdx.x];
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int i = 0; i < kNormParts; ++i) total = total + sm[i];
    const float norm = sqrtf(total);
    sm[kNormParts] = norm < max_norm ? 1.0f : max_norm / norm;
  }
  __syncthreads();
  CP_MARK(7);  // the norm
  const float scale = sm[kNormParts];
  constexpr int kU = 4;  // elements a thread takes at once
  const int stride = gridDim.x * kThreads;
  for (int e0 = blockIdx.x * kThreads + threadIdx.x; e0 < n;
       e0 += kU * stride) {
    int off[kU];
    bool ok[kU];
    float gs[kU];
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      off[i] = e0 + i * stride;
      ok[i] = off[i] < n;
      gs[i] = ok[i] ? g[off[i]] * scale : 0.0f;
    }
    adam_elems<kU>(net, off, ok, gs, as.bc1, as.bc2, lr, c);
  }
  CP_MARK(8);  // Adam and Polyak
}

__device__ GradOp grad_op(int kind, int net, const float* g, int out,
                          const float* x, int in, int off) {
  GradOp op = {};
  op.kind = kind;
  op.net = net;
  op.g = g;
  op.out = out;
  op.x = x;
  op.in = in;
  op.off = off;
  return op;
}

// The gradients of one network: its 4L + 3 ops (net_grad_op) read the
// per-layer rows of dz, dy and dy * xhat, the layer inputs (x0 at layer
// 0, then `hin`, a region of (batch, H_{l-1} + (l == 1 ? join : 0))
// pieces: the critic's action joins at layer 1), the head's upstream
// gradient (batch, n_head) and the last layer's activations, and the loss
// rows (summed, or squared when sq, times scale into *dst).
struct NetGrads {
  int net, join, n_head, sq;
  float scale;
  float* dst;
  const float *x0, *dz, *dy, *dyxh, *hin, *dhead, *hlast, *loss;
  NetLayout lay;
};

// Layer l's rows in a per-layer region of (batch, H_l) pieces.
template <typename P>
__device__ __forceinline__ P* layer_rows(P* base, const Torso& T, int l,
                                         int B) {
  return base + static_cast<size_t>(B) * T.at(l);
}

// Layer l's input rows (l >= 1) in a region of (batch, H_{l-1} + (l == 1 ?
// join : 0)) pieces.
template <typename P>
__device__ __forceinline__ P* input_rows(P* base, const Torso& T, int l,
                                         int join, int B) {
  return base + static_cast<size_t>(B) * (T.at(l - 1) + (l >= 2 ? join : 0));
}

// Op i of a network's gradient list: per torso layer l, W_l, b_l,
// LayerNorm scale_l and bias_l; then the head's W and b; then the loss.
__device__ GradOp net_grad_op(const NetGrads& g, int i, const Torso& T,
                              int F, int B) {
  const int L = T.L;
  if (i < 4 * L) {
    const int l = i / 4, h = T.h(l);
    const float* rows =
        layer_rows(i % 4 == 2 ? g.dyxh : i % 4 == 3 ? g.dy : g.dz, T, l, B);
    switch (i % 4) {
      case 0: {
        const int in = l == 0 ? F : T.h(l - 1) + (l == 1 ? g.join : 0);
        const float* x = l == 0 ? g.x0 : input_rows(g.hin, T, l, g.join, B);
        return grad_op(kGradW, g.net, rows, h, x, in, g.lay.w(l));
      }
      case 1:
        return grad_op(kGradV, g.net, rows, h, nullptr, 0, g.lay.b(l));
      case 2:
        return grad_op(kGradV, g.net, rows, h, nullptr, 0, g.lay.s(l));
      default:
        return grad_op(kGradV, g.net, rows, h, nullptr, 0, g.lay.t(l));
    }
  }
  if (i == 4 * L)
    return grad_op(kGradW, g.net, g.dhead, g.n_head, g.hlast, T.h(L - 1),
                   g.lay.wh);
  if (i == 4 * L + 1)
    return grad_op(kGradV, g.net, g.dhead, g.n_head, nullptr, 0, g.lay.bh);
  GradOp loss = grad_op(kGradLoss, g.net, g.loss, 1, nullptr, 0, 0);
  loss.sq = g.sq;
  loss.scale = g.scale;
  loss.dst = g.dst;
  return loss;
}

// The device table (n ints from t.tab, which every NetLayout points into)
// copied into shared memory after the block's region, so that the items
// read widths and offsets there; returns the torso pointing at the copy.
// Ends with a barrier.
__device__ Torso stage_table(const Torso& t, int n, int* dst) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = t.tab[i];
  __syncthreads();
  return Torso{dst, t.L};
}

// A network's layout moved onto the shared copy of its table.
__device__ NetLayout layout_on(const NetLayout& n, const Torso& from,
                               const Torso& to) {
  NetLayout m = n;
  m.lay = to.tab + (n.lay - from.tab);
  return m;
}

// The host's copy of the torso's widths: true when there are at least
// min_layers of them, each >= 1; *sum, *widest (when not null) get their
// sum and max(first, widths...).
inline bool widths_ok(const int* widths, int L, int min_layers,
                      long long* sum, int* widest, int first) {
  if (widths == nullptr || L < min_layers) return false;
  long long s = 0;
  int m = first;
  for (int l = 0; l < L; ++l) {
    if (widths[l] < 1) return false;
    s += widths[l];
    m = widths[l] > m ? widths[l] : m;
  }
  if (sum != nullptr) *sum = s;
  if (widest != nullptr) *widest = m;
  return true;
}

// Launches `kernel` cooperatively on `stream` with as many blocks as fit,
// up to 2 per SM, at `smem` bytes of dynamic shared memory; the count is
// cached in `blocks`/`blocks_smem` across calls.
inline cudaError_t launch_cooperative(const void* kernel, size_t smem,
                                      void** args, cudaStream_t stream,
                                      int& blocks, size_t& blocks_smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (blocks == 0 || blocks_smem != smem) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, smem)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    blocks = sms * (per_sm < 2 ? per_sm : 2);
    blocks_smem = smem;
  }
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
