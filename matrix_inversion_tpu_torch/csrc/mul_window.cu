// mul_window.cu -- the base-2 windowed multiply on 64-bit magnitudes.
//
// Replaces matrix_inversion_tpu/ops/pallas_kernels.py::_mul_window_kernel
// (K4, pair_math.mul_window), the opt-in multiply of the JAX package's
// op-by-op path.  Per element: one cropped partial product per digit of a,
// described by a row (a_shift, b_shift, b_mask, out_shift) of the table
// that ops/packed.py::mul_window_consts gives for the operands' formats,
// summed in a uint64_t that wraps mod 2**64, then masked to the output
// window.  At base 2 a digit is 0 or 1, so each partial product is a mask,
// not a multiply.  The sum equals the algebraic truncated multiply bit for
// bit (ops/packed.py::mul_trunc_packed).
//
// The table changes with every call's formats, so it is a runtime
// argument, passed by value as a kernel parameter (at most 62 rows, about
// 1.3 KB, in the constant bank); the row loop is unrolled to the table's
// capacity and stops at its row count, so every row is read at a constant
// offset.  One thread per element.
//
// Bound: bytes.  An element moves 24 bytes, and its function, a truncated
// multiply, is known in about 81 32-bit instructions, which the card issues
// in a third of the time the bytes take.  This kernel is not there: by its
// SASS it issues 20 instructions a row (a row's four table words are read
// at run time and its shifts are run-time shifts), 831 an element at the
// High dot product's 40 rows, and takes about five times its bound
// (PERF.md has the times).
//
// Built with nvcc for sm_90a into a library with a plain C interface
// (ops/long_division.py).  Without __CUDACC__ the file compiles as host
// C++ with a loop in place of the launch, which is how the CPU tests run
// it.

#include "qfloat_cell.cuh"

constexpr int kMaxRows = 62;

// Mirrors ops/long_division.py::MulWindowTable.
struct MulWindowTable {
  uint64_t b_mask[kMaxRows];
  uint64_t out_mask;
  int32_t a_shift[kMaxRows];
  int32_t b_shift[kMaxRows];
  int32_t out_shift[kMaxRows];
  int32_t rows;
};

QI_FN uint64_t mul_window(uint64_t a, uint64_t b, const MulWindowTable& t) {
  uint64_t acc = 0;
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    if (i >= t.rows) break;
    const uint64_t digit = (a >> t.a_shift[i]) & 1;
    const uint64_t window = ((b >> t.b_shift[i]) & t.b_mask[i]) << t.out_shift[i];
    acc += window & (uint64_t(0) - digit);
  }
  return acc & t.out_mask;
}

#ifdef __CUDACC__

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
mul_window_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
                  uint64_t* __restrict__ out, int64_t n, const MulWindowTable table) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) out[i] = mul_window(a[i], b[i], table);
}

// n int64 magnitudes a and b in, n products out, on `stream`.  Returns the
// launch's cudaError_t.
extern "C" int mul_window_launch(const void* a, const void* b, void* out, int64_t n,
                                 const MulWindowTable* table, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  mul_window_kernel<<<unsigned(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(a), static_cast<const uint64_t*>(b),
      static_cast<uint64_t*>(out), n, *table);
  return int(cudaGetLastError());
}

#else

// Host form of the launch: the same per-element function over n.
extern "C" int mul_window_host(const void* a, const void* b, void* out, int64_t n,
                               const MulWindowTable* table) {
  for (int64_t i = 0; i < n; ++i) {
    static_cast<uint64_t*>(out)[i] = mul_window(
        static_cast<const uint64_t*>(a)[i], static_cast<const uint64_t*>(b)[i], *table);
  }
  return 0;
}

#endif  // __CUDACC__
