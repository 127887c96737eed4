// mul_window.cu -- K4, the base-2 truncated multiply of 64-bit magnitudes.
//
// Replaces matrix_inversion_tpu/ops/pallas_kernels.py::_mul_window_kernel
// (K4, pair_math.mul_window), the opt-in multiply of the JAX package's
// op-by-op path.  Per element it gives the cropped partial-product sum of
// the reference's windowed multiply (reference qfloat.py:995-1016) masked
// to the output window, the magnitude of ops/packed.py::mul_window_packed.
// The TPU kernel adds one cropped partial product per digit of a, read from
// a table of rows; this one takes the sum's algebraic form
// (pair_math.mul_truncated, pair_math.py:320-399; K1's qfloat_cell.cuh::
// mul_inl is the same algebra in 128 bits throughout).  With
//   t1  = (a_len - a_ints) + (b_len - b_ints) - (newlength - newints),
//   nt  = min(t1, a_len),
//   out = ((a*b - C) >> t1) & out_mask,
//   C   = sum over p < nt of a_p * ((b << p) mod 2**t1),
// one wide product less a correction that floors every partial product
// below the window separately; t1 <= 0 widens: ((a*b) << -t1) & out_mask.
//
// a*b - C is at least 0 (C <= (a mod 2**nt) * b) and below 2**124, and only
// its bits [t1, t1 + newlength) are kept, so the words can be cut:
//   * the product: its low 64 bits where t1 + newlength <= 64 (every
//     preset's multiply), else all 128;
//   * C: each term is below 2**t1, so C < nt * 2**t1.  Where t1 + 1 + the
//     bit length of nt <= 32 (every preset's multiply but Medium's
//     (31,16) x (31,0)) C is one 32-bit word, and a term is b shifted, bit
//     p of a spread to a mask by two shifts, one three-input and and an
//     add, all on 32 bits; with a 64-bit product C is otherwise taken mod
//     2**64, with the 128-bit product in 64 bits where it fits them, else
//     in 128.
// The presets' multiplies are compile-time instances (t1, nt and newlength
// fixed, the correction unrolled), as K2's divisions are; every other
// format takes the run-time form of its word widths.
//
// Bound: bytes.  An element moves 24 bytes (16 where a is one broadcast
// word); at High the function is about a hundred 32-bit instructions,
// which the card issues in under half the time the bytes take.  So K4 runs
// in the streaming frame that it shares with K2 and K3 (stream_frame.cuh).
// PERF.md has its time, its SASS count and the design steps
// (csrc/long_division_steps.cu keeps the first K4, the row table, beside
// it).
//
// Built with nvcc for sm_90a into a library with a plain C interface
// (ops/long_division.py).  Without __CUDACC__ the file compiles as host
// C++ with a loop in place of the launch, which is how the CPU tests run
// the same element functions.

#include <type_traits>

#include "qfloat_cell.cuh"
#include "stream_frame.cuh"

namespace mulwin {

using qcell::low_mask;
typedef unsigned __int128 u128;

// All ones where bit p of a is set, else 0, in the word CT.
template <class CT>
QI_FN CT digit_mask(uint64_t a, int p) {
  if constexpr (sizeof(CT) == 4) {
    return CT(int32_t(uint32_t(a) << (31 - p)) >> 31);  // p < 32
  } else {
    return CT(int64_t(a << (63 - p)) >> 63);  // sign-extends to 128 bits too
  }
}

// C = sum over p < nt of a_p * ((b << p) mod 2**t1), in CT (mod its width).
// NT > 0 fixes nt at compile time and unrolls the sum.
template <class CT, int NT>
QI_FN CT correction(uint64_t a, uint64_t b, int t1, int nt_rt) {
  const CT mask = (CT(1) << t1) - 1;  // t1 < the width of CT
  const CT bw = CT(b) & mask;
  CT c = 0;
  if constexpr (NT != 0) {
#pragma unroll
    for (int p = 0; p < NT; ++p) c += (bw << p) & mask & digit_mask<CT>(a, p);
  } else {
    for (int p = 0; p < nt_rt; ++p) c += (bw << p) & mask & digit_mask<CT>(a, p);
  }
  return c;
}

// ((a*b - C) >> t1) & out_mask with C in CT and the product in PT.
template <class CT, class PT, int NT>
QI_FN uint64_t truncated(uint64_t a, uint64_t b, int t1, int nt, uint64_t out_mask) {
  const CT c = correction<CT, NT>(a, b, t1, nt);
  return uint64_t((PT(a) * b - c) >> t1) & out_mask;
}

// Whether C = sum of nt terms below 2**t1 fits `width` bits.
constexpr bool c_fits(int t1, int nt, int width) {
  int len = 0;
  while (nt >> len) ++len;
  return t1 + 1 + len <= width;
}

// The element functions as objects, for the frame.
template <class CT, class PT>
struct TruncAny {
  int t1, nt;
  uint64_t out_mask;
  QI_FN uint64_t operator()(uint64_t a, uint64_t b) const {
    return truncated<CT, PT, 0>(a, b, t1, nt, out_mask);
  }
};

template <int T1, int NT, int NL>
struct TruncFixed {
  static_assert(T1 > 0 && NT > 0 && T1 + NL <= 64, "a preset's multiply: 64-bit product");
  typedef typename std::conditional<c_fits(T1, NT, 32), uint32_t, uint64_t>::type CT;
  QI_FN uint64_t operator()(uint64_t a, uint64_t b) const {
    return truncated<CT, uint64_t, NT>(a, b, T1, NT, low_mask(NL));
  }
};

struct Widen {
  int shift;  // -t1 >= 0
  uint64_t out_mask;
  QI_FN uint64_t operator()(uint64_t a, uint64_t b) const { return ((a * b) << shift) & out_mask; }
};

// run(op) with K4's element function for (t1, nt, newlength): a
// compile-time instance for the presets' multiplies ((len, ints) of a, of b
// and of the product), the run-time form of its word widths for every
// other format.
template <class Run>
int with_mul_op(int t1, int nt, int newlength, Run run) {
#define MW_FIXED(T1, NT, NL) \
  if (t1 == T1 && nt == NT && newlength == NL) return run(TruncFixed<T1, NT, NL>{});
  MW_FIXED(20, 20, 40)  // High (40,20)^3
  MW_FIXED(15, 15, 31)  // Medium and Medium+ (31,16)^3
  MW_FIXED(31, 31, 31)  // Medium (31,16) x (31,0) -> (31,16): C in 64 bits
  MW_FIXED(14, 14, 23)  // Low (23,9)^3
  MW_FIXED(23, 23, 23)  // Low (23,9) x (23,0) -> (23,9)
#undef MW_FIXED
  const uint64_t out_mask = low_mask(newlength);
  if (t1 <= 0) return run(Widen{-t1, out_mask});
  if (t1 + newlength <= 64) {
    if (c_fits(t1, nt, 32)) return run(TruncAny<uint32_t, uint64_t>{t1, nt, out_mask});
    return run(TruncAny<uint64_t, uint64_t>{t1, nt, out_mask});
  }
  if (c_fits(t1, nt, 64)) return run(TruncAny<uint64_t, u128>{t1, nt, out_mask});
  return run(TruncAny<u128, u128>{t1, nt, out_mask});
}

}  // namespace mulwin

// n int64 magnitudes b in, n products out; a is n words (a_stride 1) or one
// word (a_stride 0).  (t1, nt, newlength) as in the header, from the
// operands' formats (ops/long_division.py::mul_trunc_format).
extern "C" int SF_ENTRY(mul_window)(const void* a, const void* b, void* out, int64_t n,
                                    int a_stride, int t1, int nt, int newlength SF_STREAM_PARAM) {
  return mulwin::with_mul_op(t1, nt, newlength, sframe::Call{a, b, out, n, a_stride, SF_STREAM});
}
