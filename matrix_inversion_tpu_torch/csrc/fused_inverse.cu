// fused_inverse.cu -- the whole batched QFloat matrix inversion in one kernel.
//
// Replaces matrix_inversion_tpu/ops/fused_inverse.py::_fused_kernel (the
// Pallas TPU kernel, launched by _fused_call).  One thread inverts one
// matrix: it loads the n*n cells, runs the inversion circuit with every
// cell held in registers as a uint64_t magnitude and an int sign, and
// stores the n*n result cells.  The layout is cell-major (n*n, B), so
// neighbouring threads read and write neighbouring words.  A ragged batch
// is handled by the bounds check; nothing is padded.
//
// What is written by hand: the primitives (qfloat_cell.cuh), this
// skeleton (indexing, loads and stores, bounds) and the launch.  The body,
// fused_body(), is emitted per configuration by ops/emit.py from the
// circuit in models/qfloat_lu.py and reaches this file as fused_body.inc
// from the build directory.
//
// Bound: integer issue, not bytes.  Each inversion reads and writes about
// 0.5 KB (n=4: 16 cells of int64 magnitude and int64 sign, each way)
// against thousands of integer operations: 128-bit products for the
// multiplies and 64-bit divisions for the true divisions and reciprocals.
// 64-bit `/` is a long software sequence on this card and is the first
// suspect for later tuning, which could carry over the estimate-and-fixup
// division of matrix_inversion_tpu/ops/pair_math.py::div_float.
//
// The tracked variant (the Pallas kernel with track=True) is the same
// file built with a body emitted under tracking, which defines FUSED_TRACK
// as 1: every multiply takes the windowed form, every op ORs its overflow
// flag into one int per matrix, and that flag is a third output, (batch,)
// int32, under its own launch symbol.  The windowed multiply (one
// shift-mask-add per digit of a, ~40 at High) replaces the truncated one
// and doubles the integer instructions; the variant is still bound by
// integer issue but issues at about a quarter of the untracked kernel's
// rate, likely on the serial carry chain of each windowed sum (PERF.md).
//
// Built with nvcc for sm_90a into a library with a plain C interface
// (ops/fused_inverse.py).  Without __CUDACC__ the same file compiles as
// host C++ with a loop in place of the launch, which is how the CPU tests
// run the emitted body and this skeleton.

#include "qfloat_cell.cuh"
#include "fused_body.inc"

#ifndef FUSED_TRACK
#define FUSED_TRACK 0
#endif

namespace qcell {

// Inverts matrix b of the batch; returns its overflow flag (0 untracked).
QI_FN int fused_one(int64_t b, int64_t batch, const int64_t* __restrict__ mags,
                    const int64_t* __restrict__ signs, int64_t* __restrict__ omags,
                    int64_t* __restrict__ osigns) {
  uint64_t m[FUSED_N2], om[FUSED_N2];
  int s[FUSED_N2], os[FUSED_N2];
#pragma unroll
  for (int i = 0; i < FUSED_N2; ++i) {
    m[i] = uint64_t(mags[i * batch + b]);
    s[i] = int(signs[i * batch + b]);
  }
#if FUSED_TRACK
  const int ovf = fused_body(m, s, om, os);
#else
  fused_body(m, s, om, os);
  const int ovf = 0;
#endif
#pragma unroll
  for (int i = 0; i < FUSED_N2; ++i) {
    omags[i * batch + b] = int64_t(om[i]);
    osigns[i * batch + b] = os[i];
  }
  return ovf;
}

}  // namespace qcell

#ifdef __CUDACC__

constexpr int kThreads = 128;

#if FUSED_TRACK

__global__ void __launch_bounds__(kThreads)
fused_inverse_tracked_kernel(const int64_t* __restrict__ mags,
                             const int64_t* __restrict__ signs,
                             int64_t* __restrict__ omags, int64_t* __restrict__ osigns,
                             int32_t* __restrict__ oflags, int64_t batch) {
  const int64_t b = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (b < batch) oflags[b] = qcell::fused_one(b, batch, mags, signs, omags, osigns);
}

// As fused_inverse_launch, plus the (batch,) int32 overflow flags.
extern "C" int fused_inverse_tracked_launch(const void* mags, const void* signs,
                                            void* omags, void* osigns, void* oflags,
                                            int64_t batch, void* stream) {
  if (batch <= 0) return 0;
  const int64_t blocks = (batch + kThreads - 1) / kThreads;
  fused_inverse_tracked_kernel<<<unsigned(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(mags), static_cast<const int64_t*>(signs),
      static_cast<int64_t*>(omags), static_cast<int64_t*>(osigns),
      static_cast<int32_t*>(oflags), batch);
  return int(cudaGetLastError());
}

#else

__global__ void __launch_bounds__(kThreads)
fused_inverse_kernel(const int64_t* __restrict__ mags, const int64_t* __restrict__ signs,
                     int64_t* __restrict__ omags, int64_t* __restrict__ osigns,
                     int64_t batch) {
  const int64_t b = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (b < batch) qcell::fused_one(b, batch, mags, signs, omags, osigns);
}

// (n*n, batch) int64 magnitudes and signs in, the same out, on `stream`.
// Returns the launch's cudaError_t.
extern "C" int fused_inverse_launch(const void* mags, const void* signs, void* omags,
                                    void* osigns, int64_t batch, void* stream) {
  if (batch <= 0) return 0;
  const int64_t blocks = (batch + kThreads - 1) / kThreads;
  fused_inverse_kernel<<<unsigned(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(mags), static_cast<const int64_t*>(signs),
      static_cast<int64_t*>(omags), static_cast<int64_t*>(osigns), batch);
  return int(cudaGetLastError());
}

#endif  // FUSED_TRACK

#else

#if FUSED_TRACK

// Host form of the tracked launch.
extern "C" int fused_inverse_tracked_host(const void* mags, const void* signs,
                                          void* omags, void* osigns, void* oflags,
                                          int64_t batch) {
  for (int64_t b = 0; b < batch; ++b) {
    static_cast<int32_t*>(oflags)[b] = qcell::fused_one(
        b, batch, static_cast<const int64_t*>(mags), static_cast<const int64_t*>(signs),
        static_cast<int64_t*>(omags), static_cast<int64_t*>(osigns));
  }
  return 0;
}

#else

// Host form of the launch: the same per-matrix function over the batch.
extern "C" int fused_inverse_host(const void* mags, const void* signs, void* omags,
                                  void* osigns, int64_t batch) {
  for (int64_t b = 0; b < batch; ++b) {
    qcell::fused_one(b, batch, static_cast<const int64_t*>(mags),
                     static_cast<const int64_t*>(signs), static_cast<int64_t*>(omags),
                     static_cast<int64_t*>(osigns));
  }
  return 0;
}

#endif  // FUSED_TRACK

#endif  // __CUDACC__
