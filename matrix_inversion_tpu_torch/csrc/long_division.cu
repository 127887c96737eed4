// long_division.cu -- exact batched division of 64-bit magnitudes.
//
// Replaces the two division kernels of the JAX package's op-by-op path,
// matrix_inversion_tpu/ops/pallas_kernels.py:
//   K2 _division_float_kernel (pair_math.div_float): radix-2**k long
//      division with a downward-biased f32 reciprocal estimate and one
//      add-back fixup per step;
//   K3 _division_kernel (pair_math.div_classic): the division that owes
//      nothing to a float estimate, and so checks K2's.
// Both compute q = (v mod 2**n_bits) // d exactly for d < 2**62 and
// saturate a zero divisor to 2**n_bits - 1.  Neither masks its quotient:
// the caller reads the digits above its window for the overflow flag.
//
// Bound: bytes.  An element moves 24 bytes (16 where the dividend is one
// broadcast word), which the card's memory takes longer over than its
// issue slots take over either algorithm below (about a hundred 32-bit
// instructions an element).  So both run in the streaming frame of
// stream_frame.cuh, which K4 shares: four elements a thread through
// 128-bit streaming accesses, a one-element-per-thread kernel for an odd
// last element and unaligned views, and a dividend of stride 0 or 1 (a
// reciprocal's constant dividend is read from one address).
//
// K3 was digit-serial on the TPU (one compare-subtract per quotient bit on
// uint32 pairs: Mosaic has no 64-bit integers and no wide multiply).
// Here it divides by an integer reciprocal, in integers only: no float, no
// double and no 64-bit `/` or `%`.  With dn = d << clz(d) in [2**63,
// 2**64), a 33-bit x = 2**32 + y approximates 2**96 / dn from below:
//   * z0 = floor(2**31 * 2*sqrt(2)) - (dt + 1), dt the top 32 bits of dn,
//     is the tangent of 1/D at D = 1/sqrt(2) in units of 2**-31; 1/D is
//     convex, so z0 <= 2**63 / (dt + 1), short by at most 17.2%;
//   * three Newton steps z += floor(z * e / 2**63), e = 2**63 - z * (dt + 1)
//     >= 0, square that shortfall (to 2.9%, 8.7e-4, 7.5e-7) and never pass
//     2**63 / (dt + 1) <= 2**95 / dn, because a Newton step from below
//     stays below and every floor rounds down;
//   * the last step takes the residual against all 64 bits of dn, e = 2**95
//     - (z - 1) * dn >= dn, and gives x = 2 * (z - 1) + floor((z - 1) * e /
//     2**94) with e cut from below to 32 bits; it is short of 2**96 / dn by
//     the squared shortfall (< 1/8 unit at 2**-18) and the floors: by less
//     than 2.
// A quotient below 2**31 of a < d * 2**31 is then floor(a * x * 2**s /
// 2**96), short of a / d by less than a * 2**s * 2 / 2**96 < 1, so it is
// the quotient or one less, and one compare-subtract settles it.  The
// 62-bit quotient is two such radix-2**31 digits.
//
// K2 keeps the estimate-and-fixup form, with every conversion a 32-bit
// one.  d is normalised once (L its bit length, d_top its top 32 bits);
// r < d * 2**k has at most L + k bits, so rc = r >> sh with sh = max(0, L
// + k - 32) fits 32 bits.  The digit estimate is
//   floor(f32(rc) * ((1 - 2**-17) * 2**(sh - L + 32) / f32(d_top))),
// both conversions rounding toward zero, the divide and the multiply to
// nearest, the power of two exact.  What can raise it above r / d: d_top
// cut from below (2**-31 relative), its conversion (2**-23), the divide and
// the multiply (2**-24 each); together under the bias 2**-17, so the
// estimate is never above the true digit.  What lowers it: the bias, rc's
// conversion (2**-23), the divide and the multiply, in all under 1.04 *
// 2**-17 of r / d < 2**k, and the bits of r below sh, worth 2**sh / d <=
// 2**(k - 31) of a quotient unit.  For k <= 15 that is under 0.27 + 2**-16
// < 1: the floored estimate is at most one below the digit, and ONE
// add-back suffices (it would up to k = 16).  The float operations are the
// IEEE intrinsics, so no approximate division or contraction sneaks in;
// the host build needs -ffp-contract=off for the same reason.  Exactness
// holds for d < 2**divisor_bits with k = _float_div_chunk_bits(n_bits,
// divisor_bits) (ops/packed.py).  The (n_bits, k) pairs of the four
// presets' divisions are instantiated with constant shifts and unrolled
// chunk loops; any other pair takes the run-time form.
//
// Built with nvcc for sm_90a into a library with a plain C interface
// (ops/long_division.py).  Without __CUDACC__ the file compiles as host
// C++ with a loop in place of the launch, which is how the CPU tests run
// the same per-element functions.

#include <math.h>

#include "qfloat_cell.cuh"
#include "stream_frame.cuh"

namespace longdiv {

using qcell::low_mask;

// Device-only on the card (the intrinsics exist only there), plain inline
// functions in the host build.
#ifdef __CUDACC__
#define LD_FN __device__ __forceinline__
LD_FN int clz64(uint64_t x) { return __clzll(static_cast<long long>(x)); }
LD_FN uint32_t mulhi32(uint32_t a, uint32_t b) { return __umulhi(a, b); }
LD_FN float u32_to_f32_rz(uint32_t x) { return __uint2float_rz(x); }
LD_FN uint32_t f32_to_u32_rz(float x) { return __float2uint_rz(x); }
LD_FN float f32_div(float a, float b) { return __fdiv_rn(a, b); }
LD_FN float f32_mul(float a, float b) { return __fmul_rn(a, b); }
// x * 2**e, exact (0 <= e < 128)
LD_FN float f32_scale2(float x, int e) { return __fmul_rn(x, __uint_as_float(uint32_t(127 + e) << 23)); }
#else
#define LD_FN inline
LD_FN int clz64(uint64_t x) { return __builtin_clzll(x); }
LD_FN uint32_t mulhi32(uint32_t a, uint32_t b) { return uint32_t((uint64_t(a) * b) >> 32); }
LD_FN float u32_to_f32_rz(uint32_t x) {
  const int drop = 8 - (x ? __builtin_clz(x) : 32);  // bits below the top 24
  return float(drop > 0 ? x & ~((1u << drop) - 1) : x);
}
LD_FN uint32_t f32_to_u32_rz(float x) { return uint32_t(x); }
LD_FN float f32_div(float a, float b) { return a / b; }
LD_FN float f32_mul(float a, float b) { return a * b; }
LD_FN float f32_scale2(float x, int e) { return ldexpf(x, e); }
#endif

// 1 - 2**-17, exact in f32.
constexpr float kBias = 0.99999237060546875f;

// One step of K2: shift kc dividend bits into r, estimate the digit from
// the top 32 bits of r, fix it up, append it to q.
LD_FN void float_step(uint64_t& r, uint64_t& q, uint64_t bits, int kc, int sh, float rdf,
                      uint64_t ds) {
  // r < ds * 2**kc <= 2**61: the incoming remainder is below ds
  r = (r << kc) | bits;
  uint32_t qc = f32_to_u32_rz(f32_mul(u32_to_f32_rz(uint32_t(r >> sh)), rdf));
  // the estimate is never too high, at most one too low
  uint64_t rem = r - uint64_t(qc) * ds;
  if (rem >= ds) {
    qc += 1;
    rem -= ds;
  }
  r = rem;
  q = (q << kc) | qc;
}

// K2: q = v // d in steps of k quotient bits (the first step takes the
// n_bits - k * (n_chunks - 1) leftover bits), pair_math.py:143-237.  NB > 0
// fixes (n_bits, k) = (NB, K) at compile time and unrolls the steps.
template <int NB, int K>
LD_FN uint64_t div_float(uint64_t v, uint64_t d, int n_bits_rt, int k_rt) {
  const int n_bits = NB ? NB : n_bits_rt, k = NB ? K : k_rt;
  const bool zero = d == 0;
  const uint64_t ds = zero ? 1 : d;  // divide by 1, saturate at the end
  const int s = clz64(ds), len = 64 - s;
  const int sh = len + k > 32 ? len + k - 32 : 0;
  const float rdf = f32_div(f32_scale2(kBias, sh - len + 32),
                            u32_to_f32_rz(uint32_t((ds << s) >> 32)));
  const int n_chunks = (n_bits + k - 1) / k;
  const int first = n_bits - k * (n_chunks - 1);
  uint64_t r = 0, q = 0;
  float_step(r, q, (v >> (n_bits - first)) & low_mask(first), first, sh, rdf, ds);
  if constexpr (NB != 0) {
#pragma unroll
    for (int c = 1; c < n_chunks; ++c) {
      float_step(r, q, (v >> (n_bits - first - c * k)) & low_mask(k), k, sh, rdf, ds);
    }
  } else {
#pragma unroll 1
    for (int c = 1; c < n_chunks; ++c) {
      float_step(r, q, (v >> (n_bits - first - c * k)) & low_mask(k), k, sh, rdf, ds);
    }
  }
  return zero ? low_mask(n_bits) : q;
}

// floor(2**31 * 2 * sqrt(2)) mod 2**32: the tangent's constant term.
constexpr uint32_t kTangent = 1779033703u;

// y with 2**32 + y <= 2**96 / dn < 2**32 + y + 2, for dn in [2**63, 2**64).
LD_FN uint32_t reciprocal33(uint64_t dn) {
  const uint32_t dt = uint32_t(dn >> 32), dlo = uint32_t(dn);
  uint32_t z = kTangent - dt - 1u;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint64_t e = (uint64_t(1) << 63) - (uint64_t(z) * dt + z);  // < 2**61
    z += mulhi32(z, uint32_t(e >> 31));
  }
  z -= 1u;
  // floor(z * dn / 2**32) <= 2**63 - 2**31, and the residual's top 45 bits
  const uint64_t e = ((uint64_t(1) << 63) - 1) - (uint64_t(z) * dt + mulhi32(z, dlo));
  const uint64_t x = 2 * uint64_t(z) + (mulhi32(z, uint32_t(e >> 13)) >> 17);
  return (x >> 32) ? uint32_t(x) : 0u;  // 2**32 itself is a lower bound too
}

// One radix-2**31 digit of K3: a // d for a < d * 2**31, a < 2**62, with
// s = clz(d) and y = reciprocal33(d << s); leaves a % d in r.
LD_FN uint32_t classic_digit(uint64_t a, uint64_t d, int s, uint32_t y, uint64_t& r) {
  // floor(a * (2**32 + y) / 2**32) < 2**63
  const uint64_t t = a + uint64_t(uint32_t(a >> 32)) * y + mulhi32(uint32_t(a), y);
  uint32_t q = uint32_t((t >> (63 - s)) >> 1);  // s = 0 shifts by 64
  r = a - uint64_t(q) * d;
  if (r >= d) {
    q += 1;
    r -= d;
  }
  return q;
}

// K3: q = (v mod 2**n_bits) // d through an integer reciprocal, two
// radix-2**31 digits, one compare-subtract each (pair_math.py:240-273 is
// the function; its digit-serial loop is not carried over).
LD_FN uint64_t div_classic(uint64_t v, uint64_t d, int n_bits) {
  const bool zero = d == 0;
  const uint64_t ds = zero ? 1 : d;  // clz(0) is 64: saturate at the end
  const int s = clz64(ds);
  const uint32_t y = reciprocal33(ds << s);
  v &= low_mask(n_bits);
  uint64_t r;
  const uint64_t q = uint64_t(classic_digit(v >> 31, ds, s, y, r)) << 31;
  return zero ? low_mask(n_bits) : q | classic_digit((r << 31) | (v & low_mask(31)), ds, s, y, r);
}

// The element functions as objects, for the frame.
struct Classic {
  int n_bits;
  LD_FN uint64_t operator()(uint64_t v, uint64_t d) const { return div_classic(v, d, n_bits); }
};

struct FloatAny {
  int n_bits, k;
  LD_FN uint64_t operator()(uint64_t v, uint64_t d) const {
    return div_float<0, 0>(v, d, n_bits, k);
  }
};

template <int NB, int K>
struct FloatFixed {
  LD_FN uint64_t operator()(uint64_t v, uint64_t d) const { return div_float<NB, K>(v, d, NB, K); }
};

// run(op) with K2's element function for (n_bits, k): a compile-time
// instance for the divisions of the Low, Medium and High presets (true
// division len + frac bits, reciprocal 1 + frac + len, the 2x2 closed
// form's 4 + len; all k = 15), the run-time form for every other pair.
template <class Run>
int with_float_op(int n_bits, int k, Run run) {
  if (k == 15) {
    switch (n_bits) {
#define LD_FIXED(NB) \
  case NB:           \
    return run(FloatFixed<NB, 15>{});
      LD_FIXED(27) LD_FIXED(37) LD_FIXED(38)
      LD_FIXED(35) LD_FIXED(46) LD_FIXED(47)
      LD_FIXED(44) LD_FIXED(60) LD_FIXED(61)
#undef LD_FIXED
    }
  }
  return run(FloatAny{n_bits, k});
}

}  // namespace longdiv

// n int64 divisors in, n quotients out; the dividends n words (v_stride 1)
// or one word (v_stride 0).  K3's (n_digits, bits) fix n_bits = n_digits *
// bits and nothing else.
extern "C" int SF_ENTRY(long_division_float)(const void* v, const void* d, void* q, int64_t n,
                                             int v_stride, int n_bits, int k SF_STREAM_PARAM) {
  return longdiv::with_float_op(n_bits, k, sframe::Call{v, d, q, n, v_stride, SF_STREAM});
}

extern "C" int SF_ENTRY(long_division_classic)(const void* v, const void* d, void* q, int64_t n,
                                               int v_stride, int n_digits,
                                               int bits SF_STREAM_PARAM) {
  return sframe::Call{v, d, q, n, v_stride, SF_STREAM}(longdiv::Classic{n_digits * bits});
}
