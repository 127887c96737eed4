// fused_inverse.cu -- the whole batched QFloat matrix inversion in one kernel.
//
// Replaces matrix_inversion_tpu/ops/fused_inverse.py::_fused_kernel (the
// Pallas TPU kernel, launched by _fused_call).  One thread inverts one
// matrix: it takes the n*n cells, runs the inversion circuit with every
// cell held in registers as a uint64_t magnitude and an int sign, and hands
// back the n*n result cells.
//
// Layout.  The kernel takes the callers' row-major (B, n*n) arrays.  A
// thread's cells are n*n consecutive words, so its neighbours' words lie
// n*n apart.  A block of kThreads threads owns kThreads consecutive
// matrices, one flat run of kThreads * n*n words per array.  The block
// copies the run into shared memory with coalesced 64-bit accesses (a
// warp's request is 256 consecutive bytes; 128-bit accesses were measured
// and were slower, PERF.md, and 64-bit ones take any int64 array as it
// lies), then each thread takes its own row; the outputs go back the same
// way through the same buffer, magnitudes and signs one after the other.
// A row of the buffer is padded to an odd count of 8-byte words (n*n | 1):
// a half-warp's 8-byte accesses to one cell of sixteen rows then fall into
// sixteen different bank pairs (at n = 4 the unpadded stride of 16 words
// would put them all into one).  A thread reads and writes only its own
// row of the buffer, so a barrier is needed only between a copy and a
// take.  The block size shrinks with n so that the buffer stays within the
// 48 KB a kernel gets without opting in.  Nothing is transposed in device
// memory: a call moves its own bytes once.  A ragged batch is handled by
// bounds checks; nothing is padded.  A view that is not contiguous is the
// wrapper's business (ops/fused_inverse.py).
//
// What is written by hand: the primitives (qfloat_cell.cuh), this
// skeleton (indexing, staging, loads and stores, bounds) and the launch.
// The body, fused_body(), is emitted per configuration by ops/emit.py from
// the circuit in models/qfloat_lu.py and reaches this file as
// fused_body.inc from the build directory.
//
// Bound: integer issue, not bytes.  Each inversion reads and writes about
// 0.5 KB (n=4: 16 cells of int64 magnitude and int64 sign, each way)
// against thousands of integer instructions (PERF.md has the counts: the
// least known for the function, and what this code issues).  The 64-bit
// `/` of divide and invert is the card's own routine, one subroutine
// called from each division; in a streaming frame it is as fast as either
// division kernel of long_division.cu, so it is not where the time goes.
// The multiplies are: 50 of the 182 primitives at HIGH n=4 and most of the
// instructions.
//
// The tracked variant (the Pallas kernel with track=True) is the same
// file built with a body emitted under tracking, which defines FUSED_TRACK
// as 1: every multiply takes the windowed form (one masked window of b per
// digit of a, 40 at High, summed), every op ORs its overflow flag into one
// int per matrix, and that flag is a third output, (batch,) int32, under
// its own launch symbols.  The body is straight-line code, so a primitive
// inlined at each use is copied as often as it is used.  PERF.md records
// what that cost the tracked kernel as first ported (3.5 times its present
// time), and what each step away from it bought: mul_window_t compiled
// once per format and called (all of it), the sum split over accumulators
// and a row in two operations (nothing: the compiler makes one code of
// them, qfloat_cell.cuh), more blocks an SM.  The untracked body calls its
// mul too.
//
// Built with nvcc for sm_90a into a library with a plain C interface
// (ops/fused_inverse.py).  Without __CUDACC__ the same file compiles as
// host C++: a loop over the blocks and, inside, over the threads of a
// block, with the same staging functions on a heap buffer, which is how
// the CPU tests run the emitted body, this skeleton and its index
// arithmetic.

#include "qfloat_cell.cuh"
#include "fused_body.inc"

#ifndef __CUDACC__
#include <vector>
#endif

#ifndef FUSED_TRACK
#define FUSED_TRACK 0
#endif

namespace qcell {

// 8-byte words of one row of the staging buffer: odd, see above.
constexpr int kStride = FUSED_N2 | 1;
constexpr int kTileBytes = 48 * 1024;

// Threads of a block, which is also the matrices of a tile: the most of
// 128, 64, 32 whose buffer fits kTileBytes.
constexpr int kThreads = 128 * kStride * 8 <= kTileBytes ? 128
                         : 64 * kStride * 8 <= kTileBytes ? 64 : 32;
static_assert(kThreads * kStride * 8 <= kTileBytes, "the staging buffer is over 48 KB");

// A block asks for its signs together with its magnitudes, so that it
// waits for device memory once, not twice (measured: 2-3% of the kernel's
// time at four blocks an SM, 15% at two); the signs wait in registers, n*n
// words a thread, for their turn in the buffer.  Past n = 6 that is more
// registers than the wait is worth, against a body that grows as n^3.
constexpr bool kSignsWithMags = FUSED_N2 <= 36;

// Blocks that must fit an SM at once (the second argument of
// __launch_bounds__, which caps the registers).  Up to n = 5 four blocks of
// 128 threads, 128 registers: measured faster than one, two, three or five
// at n = 4 and 5 for both variants, and no slower at n = 2 and 3.  This
// design serves n below LANES_MIN_N (ops/fused_inverse.py); from there
// fused_inverse_lanes.cu does, and this one is built past n = 5 only to be
// timed beside it (one block of all 255 registers, PERF.md).
constexpr int kMinBlocks = FUSED_N2 <= 25 ? 4 : 1;

#ifdef __CUDACC__
#define QD_FN __device__ __forceinline__
typedef unsigned long long ull;
QD_FN uint64_t load_word(const int64_t* p) { return __ldcs(reinterpret_cast<const ull*>(p)); }
QD_FN void store_word(int64_t* p, uint64_t v) { __stcs(reinterpret_cast<ull*>(p), ull(v)); }
#else
#define QD_FN inline
QD_FN uint64_t load_word(const int64_t* p) { return uint64_t(*p); }
QD_FN void store_word(int64_t* p, uint64_t v) { *p = int64_t(v); }
#endif

// Runs the circuit on one matrix's cells; returns its overflow flag (0
// untracked).
QI_FN int run_body(const uint64_t* m, const int* s, uint64_t* om, int* os) {
#if FUSED_TRACK
  return fused_body(m, s, om, os);
#else
  fused_body(m, s, om, os);
  return 0;
#endif
}

// The arrays of one call.
struct Arrays {
  const int64_t* mags;
  const int64_t* signs;
  int64_t* omags;
  int64_t* osigns;
  int32_t* oflags;  // null untracked
  int64_t batch;
};

inline Arrays arrays(const void* mags, const void* signs, void* omags, void* osigns,
                     void* oflags, int64_t batch) {
  return Arrays{static_cast<const int64_t*>(mags), static_cast<const int64_t*>(signs),
                static_cast<int64_t*>(omags), static_cast<int64_t*>(osigns),
                static_cast<int32_t*>(oflags), batch};
}

// A call runs in phases, each over all threads of a block, with a
// barrier between a copy and a take.  Thread t of the block whose first
// matrix is `first` copies words t, t + kThreads, ... of the block's flat
// run of words, n*n of them, between device memory and the buffer, where
// word w sits in row w / n*n, rows kStride apart; and it takes and puts
// the cells of row t.
struct Staged {
  const Arrays& a;
  uint64_t* tile;
  int64_t first;
  QD_FN int words() const {
    const int64_t left = a.batch - first;
    return int(left < kThreads ? left : kThreads) * FUSED_N2;
  }
  static QD_FN int tile_index(int w) { return w + (w / FUSED_N2) * (kStride - FUSED_N2); }
  // the thread's words of the run, from device memory into r
  QD_FN void load(const int64_t* src, int t, uint64_t* r) const {
#pragma unroll
    for (int k = 0; k < FUSED_N2; ++k) {
      const int w = t + k * kThreads;
      r[k] = w < words() ? load_word(src + first * FUSED_N2 + w) : 0;
    }
  }
  // the same words from r into the buffer
  QD_FN void fill(const uint64_t* r, int t) const {
#pragma unroll
    for (int k = 0; k < FUSED_N2; ++k) {
      const int w = t + k * kThreads;
      if (w < words()) tile[tile_index(w)] = r[k];
    }
  }
  // and from the buffer to device memory
  QD_FN void drain(int64_t* dst, int t) const {
#pragma unroll
    for (int k = 0; k < FUSED_N2; ++k) {
      const int w = t + k * kThreads;
      if (w < words()) store_word(dst + first * FUSED_N2 + w, tile[tile_index(w)]);
    }
  }
  QD_FN void take_mags(int t, uint64_t* m) const {
#pragma unroll
    for (int i = 0; i < FUSED_N2; ++i) m[i] = tile[t * kStride + i];
  }
  QD_FN void take_signs(int t, int* s) const {
#pragma unroll
    for (int i = 0; i < FUSED_N2; ++i) s[i] = int(tile[t * kStride + i]);
  }
  QD_FN void put_mags(int t, const uint64_t* om) const {
#pragma unroll
    for (int i = 0; i < FUSED_N2; ++i) tile[t * kStride + i] = om[i];
  }
  QD_FN void put_signs(int t, const int* os) const {
#pragma unroll
    for (int i = 0; i < FUSED_N2; ++i) tile[t * kStride + i] = uint64_t(int64_t(os[i]));
  }
};

}  // namespace qcell

#ifdef __CUDACC__

namespace qcell {

__device__ __forceinline__ void staged_fetch(const Staged& st, int t, bool live, uint64_t* m,
                                             int* s) {
  uint64_t rm[FUSED_N2], rs[FUSED_N2];
  st.load(st.a.mags, t, rm);
  if (kSignsWithMags) st.load(st.a.signs, t, rs);
  st.fill(rm, t);
  __syncthreads();
  if (live) st.take_mags(t, m);
  __syncthreads();
  if (!kSignsWithMags) st.load(st.a.signs, t, rs);
  st.fill(rs, t);
  __syncthreads();
  if (live) st.take_signs(t, s);
}

// After staged_fetch a thread has read only its own row since the last
// barrier, so it may write that row at once.
__device__ __forceinline__ void staged_store(const Staged& st, int t, bool live,
                                             const uint64_t* om, const int* os) {
  if (live) st.put_mags(t, om);
  __syncthreads();
  st.drain(st.a.omags, t);
  __syncthreads();
  if (live) st.put_signs(t, os);
  __syncthreads();
  st.drain(st.a.osigns, t);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) fused_inverse_kernel(Arrays a) {
  const int t = threadIdx.x;
  const int64_t first = int64_t(blockIdx.x) * kThreads;
  const bool live = first + t < a.batch;
  uint64_t m[FUSED_N2], om[FUSED_N2];
  int s[FUSED_N2], os[FUSED_N2];
  __shared__ uint64_t tile[kThreads * kStride];
  const Staged st{a, tile, first};
  staged_fetch(st, t, live, m, s);
  int ovf = 0;
  if (live) ovf = run_body(m, s, om, os);
  staged_store(st, t, live, om, os);
#if FUSED_TRACK
  if (live) a.oflags[first + t] = ovf;
#else
  (void)ovf;
#endif
}

inline int launch(const Arrays& a, void* stream) {
  if (a.batch <= 0) return 0;
  const int64_t blocks = (a.batch + kThreads - 1) / kThreads;
  fused_inverse_kernel<<<unsigned(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

}  // namespace qcell

#define FUSED_ENTRY(name) name##_launch
#define FUSED_STREAM_PARAM , void* stream
#define FUSED_RUN(arrays) qcell::launch(arrays, stream)

#else

namespace qcell {

// The kernel on the host: the blocks one after the other, each phase of a
// block as a loop over its threads, the staging buffer on the heap.
inline int run_host(const Arrays& a) {
  std::vector<uint64_t> tile(kThreads * kStride), r(kThreads * FUSED_N2);
  std::vector<uint64_t> m(kThreads * FUSED_N2), om(kThreads * FUSED_N2);
  std::vector<int> s(kThreads * FUSED_N2), os(kThreads * FUSED_N2);
  for (int64_t first = 0; first < a.batch; first += kThreads) {
    const int live = int(a.batch - first < kThreads ? a.batch - first : kThreads);
    const Staged st{a, tile.data(), first};
    for (int t = 0; t < kThreads; ++t) st.load(a.mags, t, &r[t * FUSED_N2]);
    for (int t = 0; t < kThreads; ++t) st.fill(&r[t * FUSED_N2], t);
    for (int t = 0; t < live; ++t) st.take_mags(t, &m[t * FUSED_N2]);
    for (int t = 0; t < kThreads; ++t) st.load(a.signs, t, &r[t * FUSED_N2]);
    for (int t = 0; t < kThreads; ++t) st.fill(&r[t * FUSED_N2], t);
    for (int t = 0; t < live; ++t) st.take_signs(t, &s[t * FUSED_N2]);
    for (int t = 0; t < live; ++t) {
      const int ovf = run_body(&m[t * FUSED_N2], &s[t * FUSED_N2], &om[t * FUSED_N2],
                               &os[t * FUSED_N2]);
      if (a.oflags) a.oflags[first + t] = ovf;
    }
    for (int t = 0; t < live; ++t) st.put_mags(t, &om[t * FUSED_N2]);
    for (int t = 0; t < kThreads; ++t) st.drain(a.omags, t);
    for (int t = 0; t < live; ++t) st.put_signs(t, &os[t * FUSED_N2]);
    for (int t = 0; t < kThreads; ++t) st.drain(a.osigns, t);
  }
  return 0;
}

}  // namespace qcell

#define FUSED_ENTRY(name) name##_host
#define FUSED_STREAM_PARAM
#define FUSED_RUN(arrays) qcell::run_host(arrays)

#endif  // __CUDACC__

// The entry point: row-major (batch, n*n) int64 magnitudes and signs in,
// the same out, and tracked the (batch,) int32 overflow flags; on `stream`
// of the card (*_launch, returning the launch's cudaError_t) or on the host
// (*_host).

// The threads of a block, which the size of the staging buffer sets.
extern "C" int fused_inverse_block_threads() { return qcell::kThreads; }

#if FUSED_TRACK

extern "C" int FUSED_ENTRY(fused_inverse_tracked)(const void* mags, const void* signs,
                                                  void* omags, void* osigns, void* oflags,
                                                  int64_t batch FUSED_STREAM_PARAM) {
  return FUSED_RUN(qcell::arrays(mags, signs, omags, osigns, oflags, batch));
}

#else

extern "C" int FUSED_ENTRY(fused_inverse)(const void* mags, const void* signs, void* omags,
                                          void* osigns, int64_t batch FUSED_STREAM_PARAM) {
  return FUSED_RUN(qcell::arrays(mags, signs, omags, osigns, nullptr, batch));
}

#endif  // FUSED_TRACK
