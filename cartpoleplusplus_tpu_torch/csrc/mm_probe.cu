// The product probe: learner_stages.cuh's product helpers (mm_in, mm_fma,
// mm_out) alone, at every mode, on C = A B for A (rows, k) and B (k, cols),
// row-major float32: one thread an element of C, k in order from zero, as
// every product site of B3, B5, B7 and B9 forms its sums. It tells the
// modes apart on the card against the exact emulation of each mode's chain
// (ops/learner_kernel.py::mm_chain, the probe's plain version), and shows
// the operands' parts (mm_split). At the tensor cores' modes (mm_tc) it
// also runs B3's and B9's fragment helpers alone (mma_load_a, mma_load_b,
// mma_add at kAccPass: one warp a 16 x 8 tile, each k-block's part
// products from zero, added in order), held on the CPU to its plain
// version (ops/learner_kernel.py::mma_chain) bit for bit on operands whose
// block sums are exact: the fragments' layouts, the parts and the passes'
// order. Not on any learner's path.
#include "learner_stages.cuh"

namespace {

template <int M>
__global__ void __launch_bounds__(kThreads) mm_probe_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    float* __restrict__ C, int rows, int k, int cols) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= rows * cols) return;
  const int r = i / cols, c = i - r * cols;
  mm_acc_t<M> acc = 0.0f;
  for (int q = 0; q < k; ++q)
    acc = mm_fma<M>(mm_in<M>(A[static_cast<size_t>(r) * k + q]),
                    mm_in<M>(B[static_cast<size_t>(q) * cols + c]), acc);
  C[i] = mm_out<M>(acc);
}

// parts[3 i .. 3 i + 2] = x[i] as mode M takes it into a product: X3's
// (hi, lo, 0), X6's (hi, mid, lo), else (the operand rounded to float32, 0,
// 0).
template <int M>
__global__ void __launch_bounds__(kThreads) mm_split_kernel(
    const float* __restrict__ x, float* __restrict__ parts, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const mm_in_t<M> v = mm_in<M>(x[i]);
  float out[3] = {0.0f, 0.0f, 0.0f};
  if constexpr (M == kMmX3) {
    out[0] = v.hi;
    out[1] = v.lo;
  } else if constexpr (M == kMmX6) {
    out[0] = v.hi;
    out[1] = v.mid;
    out[2] = v.lo;
  } else {
    out[0] = static_cast<float>(v);
  }
  for (int j = 0; j < 3; ++j) parts[3 * static_cast<size_t>(i) + j] = out[j];
}

// C = A B through the tensor cores' helpers at mode M: warp w of the grid
// takes the tile (w / (cols / 8), w % (cols / 8)) of 16 rows x 8 columns
// (rows a multiple of 16, cols of 8; k padded with zeros).
template <int M>
__global__ void __launch_bounds__(kThreads) mma_probe_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    float* __restrict__ C, int rows, int k, int cols) {
  if constexpr (mm_tc<M>) {
    const int w = (blockIdx.x * kThreads + threadIdx.x) >> 5;
    const int nt = cols / 8;
    if (w >= rows / 16 * nt) return;
    const int m0 = (w / nt) * 16, n0 = (w % nt) * 8;
    const auto a = mma_floats<M>([=](int i, int q) {
      return q < k ? A[static_cast<size_t>(i) * k + q] : 0.0f;
    });
    const auto b = mma_floats<M>([=](int j, int q) {
      return q < k ? B[static_cast<size_t>(q) * cols + j] : 0.0f;
    });
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < k; k0 += kMmaK<M>)
      mma_add<M, false, kAccPass>(mma_load_a<M>(a, m0, k0),
                                  mma_load_b<M>(b, n0, k0), acc);
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      C[static_cast<size_t>(m0 + g + (q >> 1) * 8) * cols + n0 + 2 * t +
        (q & 1)] = mm_out<M>(acc[q]);
  }
}

// parts[3 i .. 3 i + 2] = x[i] as the tensor cores' helpers take it at mode
// M (mma_pack, tf32_bits: the hardware's conversions), each part's bits as
// a float32: X3's (hi, lo, 0), X6's (hi, mid, lo), else (the rounded
// operand, 0, 0); held to mm_split's (the fmaf chains' and the twins')
// bits.
template <int M>
__global__ void __launch_bounds__(kThreads) mma_split_kernel(
    const float* __restrict__ x, float* __restrict__ parts, int n) {
  if constexpr (mm_tc<M>) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    float out[3] = {0.0f, 0.0f, 0.0f};
    if constexpr (M == kMmTf32) {
      out[0] = __uint_as_float(tf32_bits(x[i]));
    } else {
      unsigned p[kMmaParts<M>];
      mma_pack<M>(x[i], 0.0f, p);
#pragma unroll
      for (int q = 0; q < kMmaParts<M>; ++q) {
        if constexpr (M == kMmF16) {
          out[q] = __half2float(
              __ushort_as_half(static_cast<unsigned short>(p[q] & 0xffffu)));
        } else {
          out[q] = bf16_lo(p[q]);
        }
      }
    }
    for (int j = 0; j < 3; ++j) parts[3 * static_cast<size_t>(i) + j] = out[j];
  }
}

template <int M>
cudaError_t launch(int what, const float* a, const float* b, float* c,
                   int rows, int k, int cols, cudaStream_t s) {
  if (what == 0) {
    const int n = rows * cols;
    mm_probe_kernel<M><<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        a, b, c, rows, k, cols);
  } else if (what == 1) {
    mm_split_kernel<M><<<(rows + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        a, c, rows);
  } else if (what == 3) {
    if (!mm_tc<M>) return cudaErrorInvalidValue;
    mma_split_kernel<M><<<(rows + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        a, c, rows);
  } else {
    if (!mm_tc<M> || rows % 16 != 0 || cols % 8 != 0)
      return cudaErrorInvalidValue;
    const int warps = rows / 16 * (cols / 8);
    mma_probe_kernel<M><<<(warps + kWarps - 1) / kWarps, kThreads, 0, s>>>(
        a, b, c, rows, k, cols);
  }
  return cudaGetLastError();
}

cudaError_t dispatch(int mode, int what, const float* a, const float* b,
                     float* c, int rows, int k, int cols, cudaStream_t s) {
  switch (mode) {
    case kMmF32:
      return launch<kMmF32>(what, a, b, c, rows, k, cols, s);
    case kMmBf16:
      return launch<kMmBf16>(what, a, b, c, rows, k, cols, s);
    case kMmTf32:
      return launch<kMmTf32>(what, a, b, c, rows, k, cols, s);
    case kMmX3:
      return launch<kMmX3>(what, a, b, c, rows, k, cols, s);
    case kMmX6:
      return launch<kMmX6>(what, a, b, c, rows, k, cols, s);
    case kMmF64:
      return launch<kMmF64>(what, a, b, c, rows, k, cols, s);
    case kMmF16:
      return launch<kMmF16>(what, a, b, c, rows, k, cols, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// C (rows, cols) = A (rows, k) B (k, cols) at product mode `mode` on
// `stream`. Returns a cudaError_t.
int cp_mm_probe(int mode, const float* a, const float* b, float* c, int rows,
                int k, int cols, void* stream) {
  if (rows < 1 || k < 1 || cols < 1 ||
      static_cast<long long>(rows) * cols > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(mode, 0, a, b, c, rows, k, cols,
                                   static_cast<cudaStream_t>(stream)));
}

// C (rows, cols) = A (rows, k) B (k, cols) through the tensor cores'
// fragment helpers at a mode of theirs (rows a multiple of 16, cols of 8)
// on `stream`. Returns a cudaError_t.
int cp_mma_probe(int mode, const float* a, const float* b, float* c,
                 int rows, int k, int cols, void* stream) {
  if (rows < 16 || k < 1 || cols < 8 ||
      static_cast<long long>(rows) * cols > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(mode, 2, a, b, c, rows, k, cols,
                                   static_cast<cudaStream_t>(stream)));
}

// parts (n, 3): each of x's n elements as the tensor cores' helpers take it
// at a mode of theirs (mma_split_kernel). Returns a cudaError_t.
int cp_mma_split(int mode, const float* x, float* parts, int n,
                 void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(mode, 3, x, nullptr, parts, n, 0, 0,
                                   static_cast<cudaStream_t>(stream)));
}

// parts (n, 3): each of x's n elements as mode `mode` takes it into a
// product (mm_split_kernel). Returns a cudaError_t.
int cp_mm_split(int mode, const float* x, float* parts, int n,
                void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(mode, 1, x, nullptr, parts, n, 0, 0,
                                   static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
