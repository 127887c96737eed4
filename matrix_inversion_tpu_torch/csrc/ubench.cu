// ubench.cu -- issue-rate probes: straight-line chains of one op mix.
//
// Replaces benchmarks/ubench_vpu.py::_make_kernel/_build (K5), the Pallas
// probes whose measured rates are the denominator of the roofline
// (utils/roofline.py::kernel_roofline).  Per element: C independent chains
// start at x + (c+1), y + (c+1), each runs K iterations of a mutual
// recurrence x = op(x, y); y = op(y, x) (a recurrence the compiler cannot
// fold, unlike x = x + y repeated), and the output is the XOR (integer
// mixes) or the sum (f32_mul) of the chains' x.  The nine uint32/float32
// mixes keep the names, the arithmetic and the constants of
// ubench_vpu.py:42-108, so their outputs equal the Pallas kernel's bit for
// bit.  Four further mixes chain the cell primitives of qfloat_cell.cuh at
// the High format (base 2, 40 digits, 20 integer), because the fused
// kernel's body on this card is calls to those primitives and not uint32
// ops: they are what it_kernelmix is on the TPU.
//
// Not carried over block by block.  The Pallas kernel is one grid-free body
// over a (512, 128) block, unrolled K x C times when it is traced.  Here:
// one thread per element, the C chains in registers, no shared memory and
// no padding; the mix and C are template arguments and K is a runtime
// argument, so nvcc cannot fold a chain at compile time, the build takes
// seconds, and one library serves every K.  The K loop of a uint32 or
// float32 mix is unrolled by 8; a cell mix's body is hundreds of
// instructions and is not unrolled.
//
// Bound: operations by construction.  A launch moves 12 bytes (24 for a
// cell mix) per element against K * C * (ops per iteration) operations.
// Timing two K values and differencing cancels the launch, the loads and
// the store (utils/ubench.py::measure).
//
// cell_divide: the card's 64-bit `/` has a short path when both operands
// fit 32 bits.  The mix ORs 2**39 into every dividend (so the shifted
// dividend is always 60 bits wide, as a High true division's) and 1 into
// every divisor (never zero), which keeps every division on the long path.
//
// Built with nvcc for sm_90a, with the flags of the other kernels, into a
// library with a plain C interface (utils/ubench.py).  Without __CUDACC__
// the file compiles as host C++ with a loop in place of the launch, which
// is how the CPU tests run it (-ffp-contract=off, for f32_mul).

#include "qfloat_cell.cuh"

namespace ubench {

// utils/ubench.py::MIXES lists the mixes in this order.
enum Mix {
  U32_ADD = 0,
  U32_MUL,
  U32_MULADD,
  U32_SHR_XOR_ADD,
  U32_CMP_SEL_ADD,
  F32_MUL,
  U32_MASKAND,
  U32_CONVERT_ADD,
  U32_KERNELMIX,
  CELL_MUL,
  CELL_SADD,
  CELL_MUL_WINDOW_T,
  CELL_DIVIDE,
};

// Round-to-nearest float ops that nvcc can neither contract into an FMA
// (the final sum adds products) nor approximate.
QI_FN float f32_mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

QI_FN float f32_add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

// One chain of a mix: its state, init() from the element's inputs and the
// chain's number, step() for one iteration, out() and combine() for the
// element's output.  kUnroll is the unroll factor of the K loop.
template <int MIX>
struct Chain;

struct U32Chain {
  typedef uint32_t T;
  static constexpr int kUnroll = 8;
  uint32_t x, y;
  QI_FN void init(uint32_t x0, uint32_t y0, int c) {
    x = x0 + uint32_t(c + 1);
    y = y0 + uint32_t(c + 1);
  }
  QI_FN uint32_t out() const { return x; }
  static QI_FN uint32_t combine(uint32_t a, uint32_t b) { return a ^ b; }
};

template <>
struct Chain<U32_ADD> : U32Chain {  // 2 adds
  QI_FN void step() {
    x = x + y;
    y = y + x;
  }
};

template <>
struct Chain<U32_MUL> : U32Chain {  // 2 muls
  QI_FN void step() {
    x = x * y;
    y = y * x;
  }
};

template <>
struct Chain<U32_MULADD> : U32Chain {  // 1 mul + 1 add
  QI_FN void step() {
    x = x * y;
    y = y + x;
  }
};

template <>
struct Chain<U32_SHR_XOR_ADD> : U32Chain {  // shr + xor + add
  QI_FN void step() {
    x = (x >> 7) ^ y;
    y = y + x;
  }
};

template <>
struct Chain<U32_CMP_SEL_ADD> : U32Chain {  // cmp + xor + select + add
  QI_FN void step() {
    x = x > y ? (x ^ y) : y;
    y = y + x;
  }
};

template <>
struct Chain<U32_MASKAND> : U32Chain {  // 2 adds + 1 constant-mask and
  QI_FN void step() {
    x = (x + y) & 0x3FFFFFFFu;
    y = y + x;
  }
};

template <>
struct Chain<U32_CONVERT_ADD> : U32Chain {  // 2 adds + 2 u32<->i32 converts
  QI_FN void step() {
    // the int32 add wraps like the uint32 one; it is done unsigned because
    // signed overflow is undefined in C++, and the converts are no-ops
    x = uint32_t(int32_t(uint32_t(int32_t(x)) + uint32_t(int32_t(y))));
    y = y + x;
  }
};

template <>
struct Chain<U32_KERNELMIX> : U32Chain {  // ubench_vpu.py:90-108, 22 nominal ops
  QI_FN void step() {
    const uint32_t a = x & 0xFFFFu;                           // and
    const uint32_t b = (y >> 16) & 0x7FFFu;                   // shr, and
    const uint32_t c = (a * b) & 0x3FFFFFFFu;                 // mul, and
    const uint32_t d = (x - y) + (c - b);                     // sub, add, sub
    const uint32_t e = (c << 3) | (d >> 5);                   // shl, or, shr
    const uint32_t f = uint32_t(int32_t(e - 7u));             // convert, sub, convert
    const uint32_t g = x < y ? f : e;                         // lt, select
    x = ((g + a) ^ (g << 1)) & 0x7FFFFFFFu;                   // add, xor, shl, and
    y = y + x;                                                // add
  }
};

template <>
struct Chain<F32_MUL> {  // 2 f32 muls
  typedef float T;
  static constexpr int kUnroll = 8;
  float x, y;
  QI_FN void init(float x0, float y0, int c) {
    x = f32_add(x0, float(c + 1));
    y = f32_add(y0, float(c + 1));
  }
  QI_FN void step() {
    x = f32_mul(x, y);
    y = f32_mul(y, x);
  }
  QI_FN float out() const { return x; }
  static QI_FN float combine(float a, float b) { return f32_add(a, b); }
};

// The cell mixes: 64-bit words masked to the 40 digits of the High format.
constexpr uint64_t kCellMask = qcell::low_mask(40);

struct CellChain {
  typedef uint64_t T;
  static constexpr int kUnroll = 1;
  uint64_t x, y;
  QI_FN void init(uint64_t x0, uint64_t y0, int c) {
    x = (x0 + uint64_t(c + 1)) & kCellMask;
    y = (y0 + uint64_t(c + 1)) & kCellMask;
  }
  QI_FN uint64_t out() const { return x; }
  static QI_FN uint64_t combine(uint64_t a, uint64_t b) { return a ^ b; }
};

template <>
struct Chain<CELL_MUL> : CellChain {  // 2 truncated multiplies
  QI_FN void step() {
    x = qcell::mul_inl<1, 40, 20, 40, 20, 40, 20>(x, y);
    y = qcell::mul_inl<1, 40, 20, 40, 20, 40, 20>(y, x);
  }
};

template <>
struct Chain<CELL_SADD> : CellChain {  // a signed subtract and a signed add
  // the signs travel with the magnitudes, as in the fused kernel's body,
  // where every sadd takes run-time signs and hands its own on
  int sx, sy;
  QI_FN void init(uint64_t x0, uint64_t y0, int c) {
    CellChain::init(x0, y0, c);
    sx = sy = 1;
  }
  QI_FN void step() {
    const qcell::Cell a = qcell::sadd<1, 40>(x, sx, y, -sy);
    x = a.m;
    sx = a.s;
    const qcell::Cell b = qcell::sadd<1, 40>(y, sy, x, sx);
    y = b.m;
    sy = b.s;
  }
};

template <>
struct Chain<CELL_MUL_WINDOW_T> : CellChain {  // 2 tracked windowed multiplies
  int f;  // OR of the flags, as the tracked kernel keeps it
  QI_FN void init(uint64_t x0, uint64_t y0, int c) {
    CellChain::init(x0, y0, c);
    f = 0;
  }
  QI_FN void step() {
    const qcell::MagF a = qcell::mul_window_inl<1, 40, 20, 40, 20, 40, 20>(x, y);
    x = a.m;
    f |= a.f;
    const qcell::MagF b = qcell::mul_window_inl<1, 40, 20, 40, 20, 40, 20>(y, x);
    y = b.m;
    f |= b.f;
  }
  // the flag sits above the 40 magnitude bits, so it reaches the output
  QI_FN uint64_t out() const { return x ^ (uint64_t(f) << 40); }
};

template <>
struct Chain<CELL_DIVIDE> : CellChain {  // 2 true divisions, always 60 bits by non-zero
  static constexpr uint64_t kTop = uint64_t(1) << 39;
  QI_FN void step() {
    x = qcell::divide<1, 40, 20>(x | kTop, y | 1);
    y = qcell::divide<1, 40, 20>(y | kTop, x | 1);
  }
};

// One element: C chains of K iterations each.
template <int MIX, int C>
QI_FN typename Chain<MIX>::T run_chains(typename Chain<MIX>::T x0,
                                        typename Chain<MIX>::T y0, int K) {
  Chain<MIX> ch[C];
#pragma unroll
  for (int c = 0; c < C; ++c) ch[c].init(x0, y0, c);
  if constexpr (Chain<MIX>::kUnroll == 8) {
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int c = 0; c < C; ++c) ch[c].step();
    }
  } else {
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int c = 0; c < C; ++c) ch[c].step();
    }
  }
  typename Chain<MIX>::T acc = ch[0].out();
#pragma unroll
  for (int c = 1; c < C; ++c) acc = Chain<MIX>::combine(acc, ch[c].out());
  return acc;
}

// Calls Op<MIX, C>::run(args...) for a run-time mix and C; -1 for a mix or
// a C that was not instantiated (C is 1 or 8; the host build, which the CPU
// tests run, has C = 2 as well).
template <template <int, int> class Op, int MIX, typename... Args>
int dispatch_c(int C, Args... args) {
  switch (C) {
    case 1: return Op<MIX, 1>::run(args...);
#ifndef __CUDACC__
    case 2: return Op<MIX, 2>::run(args...);
#endif
    case 8: return Op<MIX, 8>::run(args...);
  }
  return -1;
}

template <template <int, int> class Op, typename... Args>
int dispatch(int mix, int C, Args... args) {
  switch (mix) {
    case U32_ADD: return dispatch_c<Op, U32_ADD>(C, args...);
    case U32_MUL: return dispatch_c<Op, U32_MUL>(C, args...);
    case U32_MULADD: return dispatch_c<Op, U32_MULADD>(C, args...);
    case U32_SHR_XOR_ADD: return dispatch_c<Op, U32_SHR_XOR_ADD>(C, args...);
    case U32_CMP_SEL_ADD: return dispatch_c<Op, U32_CMP_SEL_ADD>(C, args...);
    case F32_MUL: return dispatch_c<Op, F32_MUL>(C, args...);
    case U32_MASKAND: return dispatch_c<Op, U32_MASKAND>(C, args...);
    case U32_CONVERT_ADD: return dispatch_c<Op, U32_CONVERT_ADD>(C, args...);
    case U32_KERNELMIX: return dispatch_c<Op, U32_KERNELMIX>(C, args...);
    case CELL_MUL: return dispatch_c<Op, CELL_MUL>(C, args...);
    case CELL_SADD: return dispatch_c<Op, CELL_SADD>(C, args...);
    case CELL_MUL_WINDOW_T: return dispatch_c<Op, CELL_MUL_WINDOW_T>(C, args...);
    case CELL_DIVIDE: return dispatch_c<Op, CELL_DIVIDE>(C, args...);
  }
  return -1;
}

#ifdef __CUDACC__

constexpr int kThreads = 256;

template <int MIX, int C>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const void* __restrict__ x, const void* __restrict__ y,
             void* __restrict__ out, int64_t n, int K) {
  typedef typename Chain<MIX>::T T;
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) {
    static_cast<T*>(out)[i] =
        run_chains<MIX, C>(static_cast<const T*>(x)[i], static_cast<const T*>(y)[i], K);
  }
}

template <int MIX, int C>
struct Launch {
  static int run(const void* x, const void* y, void* out, int64_t n, int K,
                 cudaStream_t stream) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    chain_kernel<MIX, C><<<unsigned(blocks), kThreads, 0, stream>>>(x, y, out, n, K);
    return int(cudaGetLastError());
  }
};

#else

template <int MIX, int C>
struct HostLoop {
  static int run(const void* x, const void* y, void* out, int64_t n, int K) {
    typedef typename Chain<MIX>::T T;
    for (int64_t i = 0; i < n; ++i) {
      static_cast<T*>(out)[i] =
          run_chains<MIX, C>(static_cast<const T*>(x)[i], static_cast<const T*>(y)[i], K);
    }
    return 0;
  }
};

#endif  // __CUDACC__

}  // namespace ubench

#ifdef __CUDACC__

// n elements x and y in (uint32, float32 or, for a cell mix, uint64 words),
// n out, C chains of K iterations of mix number `mix`, on `stream`.
// Returns the launch's cudaError_t, or -1 for an unknown mix or C.
extern "C" int ubench_chain_launch(int mix, int C, const void* x, const void* y, void* out,
                                   int64_t n, int K, void* stream) {
  if (n <= 0) return 0;
  return ubench::dispatch<ubench::Launch>(mix, C, x, y, out, n, K,
                                          static_cast<cudaStream_t>(stream));
}

#else

// Host form of the launch: the same per-element function over n.
extern "C" int ubench_chain_host(int mix, int C, const void* x, const void* y, void* out,
                                 int64_t n, int K) {
  return ubench::dispatch<ubench::HostLoop>(mix, C, x, y, out, n, K);
}

#endif  // __CUDACC__
