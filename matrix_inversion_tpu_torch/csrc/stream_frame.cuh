// stream_frame.cuh -- the streaming frame of the op-by-op kernels.
//
// K2 and K3 (long_division.cu) and K4 (mul_window.cu) are element-wise
// functions of two 64-bit words: out[i] = op(x[i * x_stride], y[i]).  Each
// element moves 24 bytes (16 where x is one broadcast word), which the
// card's memory takes longer over than its issue slots take over the
// element functions (about a hundred 32-bit instructions each).  So the
// kernels share one frame, built to move bytes: a thread takes PAIRS pairs
// of neighbouring elements, each pair with one 128-bit load per operand and
// one 128-bit store, all marked streaming (nothing is read twice, nothing
// is staged in shared memory), and its 2 * PAIRS element functions are
// independent chains that interleave.  An odd last element, and every
// element when a pointer is not 16-byte aligned, goes through a
// one-element-per-thread kernel with 64-bit accesses.  x has an element
// stride of 0 or 1: a reciprocal's constant dividend, or a broadcast
// multiplier, is read from one address.
//
// The element function is an object with `uint64_t operator()(uint64_t x,
// uint64_t y) const`, passed to the kernel by value.  Without __CUDACC__ the
// frame is one loop over the elements (host_stream), which is how the CPU
// tests run the same element functions.
#pragma once

#include <stdint.h>

namespace sframe {

#ifdef __CUDACC__

constexpr int kThreads = 256;
constexpr int kPairs = 2;  // 128-bit pairs per thread: 4 elements in flight

typedef unsigned long long ull;

__device__ __forceinline__ uint64_t load1(const uint64_t* p) {
  return __ldcs(reinterpret_cast<const ull*>(p));
}

// out[i] = op(x[i * x_stride], y[i]) for i < 2 * n_pairs, through 128-bit
// accesses: y, out and a strided x are 16-byte aligned.  Pair j of a thread
// is pair (block's first + j * kThreads + thread) of the array, so a warp's
// accesses are contiguous.
template <int PAIRS, class Op>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const uint64_t* __restrict__ x, int x_stride, const uint64_t* __restrict__ y,
              uint64_t* __restrict__ out, int64_t n_pairs, Op op) {
  const int64_t first = int64_t(blockIdx.x) * (kThreads * PAIRS) + threadIdx.x;
  const uint64_t x_one = x_stride ? 0 : load1(x);
  uint64_t xx[2 * PAIRS], yy[2 * PAIRS];
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) {
    const int64_t pair = first + int64_t(j) * kThreads;
    ulonglong2 yp = make_ulonglong2(1, 1), xp = make_ulonglong2(x_one, x_one);
    if (pair < n_pairs) {
      yp = __ldcs(reinterpret_cast<const ulonglong2*>(y) + pair);
      if (x_stride) xp = __ldcs(reinterpret_cast<const ulonglong2*>(x) + pair);
    }
    yy[2 * j] = yp.x, yy[2 * j + 1] = yp.y;
    xx[2 * j] = xp.x, xx[2 * j + 1] = xp.y;
  }
  uint64_t oo[2 * PAIRS];
#pragma unroll
  for (int e = 0; e < 2 * PAIRS; ++e) oo[e] = op(xx[e], yy[e]);
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) {
    const int64_t pair = first + int64_t(j) * kThreads;
    if (pair < n_pairs) {
      __stcs(reinterpret_cast<ulonglong2*>(out) + pair, make_ulonglong2(oo[2 * j], oo[2 * j + 1]));
    }
  }
}

// The same, one element per thread through 64-bit accesses: the odd last
// element, and every element when a pointer is not 16-byte aligned.
template <class Op>
__global__ void __launch_bounds__(kThreads)
scalar_kernel(const uint64_t* __restrict__ x, int x_stride, const uint64_t* __restrict__ y,
              uint64_t* __restrict__ out, int64_t n, Op op) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) __stcs(reinterpret_cast<ull*>(out + i), ull(op(load1(x + i * x_stride), load1(y + i))));
}

template <class Op>
int launch_scalar(Op op, const uint64_t* x, int x_stride, const uint64_t* y, uint64_t* out,
                  int64_t n, cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  scalar_kernel<<<unsigned(blocks), kThreads, 0, stream>>>(x, x_stride, y, out, n, op);
  return int(cudaGetLastError());
}

// The launches of one call on `stream`: the pairs through stream_kernel
// and an odd last element through scalar_kernel, or, unaligned, all
// through scalar_kernel.  Returns the first cudaError_t that is not 0.
template <int PAIRS, class Op>
int launch_stream(Op op, const void* x_, int x_stride, const void* y_, void* out_, int64_t n,
                  void* stream_) {
  const uint64_t* x = static_cast<const uint64_t*>(x_);
  const uint64_t* y = static_cast<const uint64_t*>(y_);
  uint64_t* out = static_cast<uint64_t*>(out_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (n <= 0) return 0;
  const uintptr_t addresses = reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(out) |
                              (x_stride ? reinterpret_cast<uintptr_t>(x) : 0);
  if (addresses % 16 != 0) return launch_scalar(op, x, x_stride, y, out, n, stream);
  const int64_t n_pairs = n / 2;
  if (n_pairs > 0) {
    const int64_t blocks = (n_pairs + kThreads * PAIRS - 1) / (kThreads * PAIRS);
    stream_kernel<PAIRS><<<unsigned(blocks), kThreads, 0, stream>>>(x, x_stride, y, out, n_pairs, op);
    const int err = int(cudaGetLastError());
    if (err != 0 || n % 2 == 0) return err;
  }
  return launch_scalar(op, x + (n - 1) * x_stride, x_stride, y + n - 1, out + n - 1, 1, stream);
}

#endif  // __CUDACC__

// The host form of the frame: the same element function over n.
template <class Op>
int host_stream(Op op, const void* x, int x_stride, const void* y, void* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    static_cast<uint64_t*>(out)[i] =
        op(static_cast<const uint64_t*>(x)[i * x_stride], static_cast<const uint64_t*>(y)[i]);
  }
  return 0;
}

// The arguments of one call, applied to an element function: on `stream`
// of the card, or on the host.
struct Call {
  const void* x;
  const void* y;
  void* out;
  int64_t n;
  int x_stride;
  void* stream;
  template <class Op>
  int operator()(Op op) const {
#ifdef __CUDACC__
    return launch_stream<kPairs>(op, x, x_stride, y, out, n, stream);
#else
    return host_stream(op, x, x_stride, y, out, n);
#endif
  }
};

}  // namespace sframe

// The C entry points of a library in the frame: name_launch(..., stream) on
// the card, name_host(...) in the host build.  The card's functions return
// the launch's cudaError_t.
#ifdef __CUDACC__
#define SF_ENTRY(name) name##_launch
#define SF_STREAM_PARAM , void* stream
#define SF_STREAM stream
#else
#define SF_ENTRY(name) name##_host
#define SF_STREAM_PARAM
#define SF_STREAM nullptr
#endif
