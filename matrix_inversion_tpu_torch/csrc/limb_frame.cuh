// limb_frame.cuh -- the frame of the limb backend's kernels, K6 and K7.
//
// Both kernels walk the digits of one number in one thread, as the JAX
// package's lax.scan chains walk the digit axis with the batch in the lanes
// (matrix_inversion_tpu/ops/limbs.py:37-45).  A number is a row of int32
// digits, most significant first, in a batch-major (N, L) array.  An
// element function is an object with `void operator()(int64_t i) const`
// that does all the work of number i; this frame runs it for i < n: on the
// card one thread a number, kThreads a block, on the stream given; without
// __CUDACC__ as one loop, which is how the CPU tests run the same element
// functions.  K6's form with its window in global scratch runs in it, and
// K7 for rows too wide for its staged kernel.
//
// The staged kernels of K6 and K7 read and write a block's rows through
// shared memory instead (stage below): a block's numbers are one contiguous
// run of digits, copied with neighbouring threads on neighbouring words,
// into rows padded to an odd stride so that a warp's threads, one a row,
// fall in 32 banks.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define LIMB_FN __device__ __forceinline__
#define LIMB_HOST_FN __host__ __device__ __forceinline__
#else
#define LIMB_FN inline
#define LIMB_HOST_FN inline
#endif

namespace limbframe {

#ifdef __CUDACC__

constexpr int kThreads = 128;

template <class Op>
__global__ void __launch_bounds__(kThreads) per_number(int64_t n, Op op) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) op(i);
}

#endif  // __CUDACC__

// op(i) for every i < n: one launch on `stream` of the card, returning its
// cudaError_t, or a loop on the host, returning 0.
template <class Op>
int run(int64_t n, Op op, void* stream) {
  if (n <= 0) return 0;
#ifdef __CUDACC__
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  per_number<<<unsigned(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(n, op);
  return int(cudaGetLastError());
#else
  (void)stream;
  for (int64_t i = 0; i < n; ++i) op(i);
  return 0;
#endif
}

// Thread t of a block of `threads`' share of the copy between `rows` rows
// of `len` int32 digits, contiguous at `flat`, and the padded buffer of
// Slots (row r at r * stride): word k of the run goes to or from buffer
// slot (k / len) * stride + k % len, the row and column stepped without a
// division.
template <class Slot>
LIMB_FN void stage(int32_t* flat, Slot* buf, int rows, int len, int stride, int t, int threads,
                   bool into_buffer) {
  const int step_r = threads / len, step_c = threads - step_r * len;
  int r = t / len, c = t - r * len;
  for (int k = t; k < rows * len; k += threads) {
    Slot* slot = buf + r * stride + c;
    if (into_buffer) {
      *slot = Slot(flat[k]);
    } else {
      flat[k] = int32_t(*slot);
    }
    r += step_r;
    c += step_c;
    if (c >= len) {
      c -= len;
      r += 1;
    }
  }
}

}  // namespace limbframe

// The C entry points: name_launch(..., stream) on the card, name_host(...)
// in the host build.
#ifdef __CUDACC__
#define LIMB_ENTRY(name) name##_launch
#define LIMB_STREAM_PARAM , void* stream
#define LIMB_STREAM stream
#else
#define LIMB_ENTRY(name) name##_host
#define LIMB_STREAM_PARAM
#define LIMB_STREAM nullptr
#endif

// What an entry point returns for arguments it does not take
// (cudaErrorInvalidValue); the wrappers check them first.
constexpr int kLimbInvalidValue = 1;
