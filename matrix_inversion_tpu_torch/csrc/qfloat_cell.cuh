// qfloat_cell.cuh -- QFloat cell arithmetic on 64-bit words.
//
// The primitives the fused inversion kernel (fused_inverse.cu) is built
// from.  A cell is a magnitude (uint64_t, below 2**62) and a sign (int in
// {-1, 0, +1}; sign 0 makes the value act as zero).  Formats (digit bits,
// length, integer digits) are template arguments, fixed when the kernel
// body is emitted (ops/emit.py), so every mask and shift is a constant.
//
// Each primitive gives the same bits as its JAX counterpart in
// matrix_inversion_tpu/ops/pair_qfloat.py and ops/pair_math.py.  Those
// work on uint32 (hi, lo) pairs only because Mosaic has no 64-bit
// integers; here a cell is one register pair and wide products use
// unsigned __int128.
//
// The tracked primitives (suffix _t) return the value together with an
// overflow flag: the digits their normalization dropped, as recorded by
// matrix_inversion_tpu/ops/packed.py inside a track_overflow() scope.  The
// tracked kernel ORs every flag of one inversion into its output.
//
// Compiled by nvcc for the card, and by a host C++ compiler (with
// __host__/__device__ defined away) so that the CPU tests can run the
// same code.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

#define QI_FN __host__ __device__ __forceinline__

// A primitive that is compiled once per format and called, not inlined at
// each use.  The fused kernel's body is straight-line code, so an inlined
// primitive of hundreds of instructions, used fifty times, is fifty copies
// in the instruction stream (fused_inverse.cu says what that cost).
#ifdef __CUDACC__
#define QI_CALL_FN __host__ __device__ __noinline__
#else
#define QI_CALL_FN __attribute__((noinline))
#endif

// The build's choices for the windowed multiply.  The defaults are what the
// port runs; tests/test_torch_emit.py holds the other forms to the same
// bits.
//   QCELL_MUL_WINDOW_INLINE  1: mul_window_t is inlined at every call
//   QCELL_MUL_WINDOW_ACCS    accumulators that share the windowed sum's rows
//   QCELL_MUL_WINDOW_NET     1: a row is one net shift and one mask,
//                            0: shift down, mask, shift up
// INLINE 1 is the tracked body as first ported.  More accumulators and the
// net shift were measured in the called function and bought nothing (the
// compiler makes the same count of instructions of every form, PERF.md),
// so the sum keeps its plainest form.
#ifndef QCELL_MUL_WINDOW_INLINE
#define QCELL_MUL_WINDOW_INLINE 0
#endif
#ifndef QCELL_MUL_WINDOW_ACCS
#define QCELL_MUL_WINDOW_ACCS 1
#endif
#ifndef QCELL_MUL_WINDOW_NET
#define QCELL_MUL_WINDOW_NET 0
#endif

namespace qcell {

typedef unsigned __int128 u128;

struct Cell {
  uint64_t m;
  int s;
};

__host__ __device__ constexpr uint64_t low_mask(int nbits) {
  return (uint64_t(1) << nbits) - 1;
}

// mag * sign for sign in {-1, 0, +1}, as a two's-complement word.
QI_FN uint64_t signed_word(uint64_t m, int s) {
  return s == 0 ? 0 : (s < 0 ? uint64_t(0) - m : m);
}

// Signed add + tidy (pair_qfloat.py:266-322; packed.py:313-325): v is the
// sum of the signed values, mag = |v| & mask, and the sign is -1 only when
// v < 0 and mag != 0.
template <int BITS, int LEN>
QI_FN Cell sadd(uint64_t am, int as, uint64_t bm, int bs) {
  constexpr uint64_t kMask = low_mask(BITS * LEN);
  const uint64_t v = signed_word(am, as) + signed_word(bm, bs);
  const bool neg = int64_t(v) < 0;
  const uint64_t m = (neg ? uint64_t(0) - v : v) & kMask;
  Cell r;
  r.m = m;
  r.s = (neg && m != 0) ? -1 : 1;
  return r;
}

// a > b on (mag, sign) cells (pair_qfloat.py:247-263): magnitudes compare
// as int64, as the eager int64 path does.
QI_FN int gt(uint64_t am, int as, uint64_t bm, int bs) {
  if (as == bs) return int(int64_t(am) > int64_t(bm)) ^ int(as < 0 && am != bm);
  return int(as > bs);
}

// Magnitude-only select (pair_qfloat.py:511-516): the sign is NOT blended,
// bug-compatible with the reference's argmax.
QI_FN uint64_t blend(int cond, uint64_t other_m, uint64_t self_m) {
  return cond != 0 ? other_m : self_m;
}

// Crop/pad to a new (len, ints) format (pair_qfloat.py:210-228).
template <int BITS, int LEN, int INTS, int NEWLEN, int NEWINTS>
QI_FN uint64_t set_len_ints(uint64_t m) {
  constexpr int kLen =
      NEWINTS < INTS ? LEN - (INTS - NEWINTS) : LEN + (NEWINTS - INTS);
  constexpr int kDiff = NEWLEN - kLen;
  static_assert(BITS * kDiff < 64 && BITS * -kDiff < 64, "shift out of range");
  if constexpr (NEWINTS < INTS) m &= low_mask(BITS * kLen);
  if constexpr (kDiff > 0) m <<= BITS * kDiff;
  if constexpr (kDiff < 0) m >>= BITS * -kDiff;
  return m;
}

// The cropped partial-product sum of the reference's windowed multiply
// (reference qfloat.py:995-1016), in the algebraic form of
// pair_math.mul_truncated (pair_math.py:320-399): with
// t1 = BITS * (frac_a + frac_b - frac_new),
//   out = ((a*b - C) >> t1) & out_mask,
//   C   = sum over digits p of a below t1 of a_p * 2**(BITS*p) * (b mod 2**(t1 - BITS*p)),
// which floors every partial product below the window separately.  The
// 128-bit product holds a*b exactly, so the uint32-word conditions of
// pair_math.py:371-376 do not apply.
template <int BITS, int A_LEN, int A_INTS, int B_LEN, int B_INTS, int NEWLEN,
          int NEWINTS>
QI_FN uint64_t mul_inl(uint64_t a, uint64_t b) {
  constexpr int kTDig = (A_LEN - A_INTS) + (B_LEN - B_INTS) - (NEWLEN - NEWINTS);
  constexpr int kT1 = BITS * kTDig;
  constexpr uint64_t kOut = low_mask(BITS * NEWLEN);
  if constexpr (kT1 <= 0) {
    // widening output (pair_math.py:351-354): every product bit is kept
    static_assert(-kT1 < 64, "shift out of range");
    return ((a * b) << -kT1) & kOut;
  } else {
    static_assert(kT1 < 128, "shift out of range");
    constexpr int kNt = kTDig < A_LEN ? kTDig : A_LEN;
    constexpr u128 kMaskT1 = (u128(1) << kT1) - 1;
    constexpr uint64_t kDigit = low_mask(BITS);
    u128 c = 0;
#pragma unroll
    for (int p = 0; p < kNt; ++p) {
      const uint64_t d = (a >> (BITS * p)) & kDigit;
      const u128 w = (u128(b) << (BITS * p)) & kMaskT1;
      if constexpr (BITS == 1) {
        c += w & (u128(0) - u128(d));
      } else {
        c += w * d;
      }
    }
    return uint64_t((u128(a) * b - c) >> kT1) & kOut;
  }
}

// mul as the emitted body calls it: one function per format (inlined at
// each use it was measured slower, PERF.md).
template <int BITS, int A_LEN, int A_INTS, int B_LEN, int B_INTS, int NEWLEN,
          int NEWINTS>
QI_CALL_FN uint64_t mul(uint64_t a, uint64_t b) {
  return mul_inl<BITS, A_LEN, A_INTS, B_LEN, B_INTS, NEWLEN, NEWINTS>(a, b);
}

// Exact quotient of (a << BITS*frac) by d, cropped to LEN digits
// (pair_qfloat.py:445-481).  A zero divisor saturates every quotient digit
// (reference base_p_arrays.py:189-201).
template <int BITS, int LEN, int INTS>
QI_FN uint64_t divide(uint64_t a, uint64_t d) {
  constexpr int kFp = LEN - INTS;
  constexpr int kNBits = BITS * (LEN + kFp);
  static_assert(kNBits <= 62, "dividend too wide");
  const uint64_t q = d == 0 ? low_mask(kNBits) : (a << (BITS * kFp)) / d;
  return q & low_mask(BITS * LEN);
}

// Reciprocal magnitude at a new format (pair_qfloat.py:483-504).
template <int BITS, int LEN, int INTS, int NEWLEN, int NEWINTS>
QI_FN uint64_t invert(uint64_t d) {
  constexpr int kFp = NEWLEN - NEWINTS;
  constexpr int kFpSelf = LEN - INTS;
  constexpr int kNDigits = 1 + kFpSelf + kFp;
  static_assert(BITS * kNDigits <= 62, "dividend too wide");
  uint64_t q = d == 0 ? low_mask(BITS * kNDigits)
                      : (uint64_t(1) << (BITS * (kFpSelf + kFp))) / d;
  if constexpr (NEWLEN < kNDigits) q &= low_mask(BITS * NEWLEN);
  return q;
}

// Division by a SignedBinary v (pair_qfloat.py:448-464): v = 0 saturates
// the magnitude and keeps the sign, otherwise v becomes the sign.
template <int BITS, int LEN>
QI_FN uint64_t sb_div_mag(uint64_t m, int v) {
  return v == 0 ? low_mask(BITS * LEN) : m;
}

QI_FN int sb_div_sign(int s, int v) { return v == 0 ? s : v; }

// ---- tracked primitives --------------------------------------------------

// A magnitude and its overflow flag; a cell and its overflow flag.
struct MagF {
  uint64_t m;
  int f;
};

struct CellF {
  uint64_t m;
  int s;
  int f;
};

// sadd, flagged when |v| exceeds the mask (packed.py:313-325,
// pair_qfloat.py:307-313).  |v| < 2**63 since both magnitudes are below
// 2**62, so the flag is exact.
template <int BITS, int LEN>
QI_FN CellF sadd_t(uint64_t am, int as, uint64_t bm, int bs) {
  constexpr uint64_t kMask = low_mask(BITS * LEN);
  const uint64_t v = signed_word(am, as) + signed_word(bm, bs);
  const bool neg = int64_t(v) < 0;
  const uint64_t av = neg ? uint64_t(0) - v : v;
  const uint64_t m = av & kMask;
  CellF r;
  r.m = m;
  r.s = (neg && m != 0) ? -1 : 1;
  r.f = av > kMask;
  return r;
}

// The windowed multiply (packed.py:868-969, pair_math.py:475-532): one
// cropped partial product per digit of a, from the top, summed in
// uint64_t.  The sum must stay 64 bits wide: carries past 2**64 wrap and go
// unseen, exactly as in the reference, and a wider one would flag more.
// Addition mod 2**64 is associative, so the rows may go to ACCS
// accumulators in turn, added at the end: the same value and the same flag
// from ACCS shorter chains of dependent adds.  The flag is any bit above the output
// window.  The per-digit constants (packed.py:779-798) depend on the
// template arguments only, so the unrolled loop folds them.
//
// A row's window of b is ((b >> s) & m) << o.  With NET it is taken as the
// reference's pair form takes it (pair_math.py:506-517): b shifted once by
// o - s, under the one mask (m << o): two operations for three.  Both give
// the same word: bit j of b lands at j + o - s, and the mask keeps the
// positions [o, o + len(m)), which are the bits [s, s + len(m)) of b.
template <int ACCS, bool NET, int BITS, int A_LEN, int A_INTS, int B_LEN, int B_INTS,
          int NEWLEN, int NEWINTS>
QI_FN MagF mul_window_sum(uint64_t a, uint64_t b) {
  static_assert(ACCS >= 1, "at least one accumulator");
  constexpr uint64_t kOut = low_mask(BITS * NEWLEN);
  constexpr uint64_t kDigit = low_mask(BITS);
  uint64_t acc[ACCS] = {};
#pragma unroll
  for (int i = 0; i < A_LEN; ++i) {
    const int indb = NEWINTS - A_INTS + i + 1 - B_INTS;
    const int ind1 = indb >= 0 ? 0 : -indb;
    const int ind2 = B_LEN < NEWLEN - indb ? B_LEN : NEWLEN - indb;
    if (ind2 <= ind1) continue;
    const uint64_t d = (a >> (BITS * (A_LEN - 1 - i))) & kDigit;
    // the cropped window of b at its output position: below 2**62
    const int s = BITS * (B_LEN - ind2);
    const int o = BITS * (NEWLEN - indb - ind2);
    const uint64_t m = low_mask(BITS * (ind2 - ind1));
    uint64_t w;
    if (NET) {
      w = (o >= s ? b << (o - s) : b >> (s - o)) & (m << o);
    } else {
      w = ((b >> s) & m) << o;
    }
    if constexpr (BITS == 1) {
      acc[i % ACCS] += w & (uint64_t(0) - d);
    } else {
      acc[i % ACCS] += w * d;
    }
  }
  uint64_t sum = acc[0];
#pragma unroll
  for (int k = 1; k < ACCS; ++k) sum += acc[k];
  MagF r;
  r.m = sum & kOut;
  r.f = (sum & ~kOut) != 0;
  return r;
}

// The windowed multiply in the build's form, always inlined: what the
// issue-rate probe (ubench.cu) times alone.
template <int BITS, int A_LEN, int A_INTS, int B_LEN, int B_INTS, int NEWLEN,
          int NEWINTS>
QI_FN MagF mul_window_inl(uint64_t a, uint64_t b) {
  return mul_window_sum<QCELL_MUL_WINDOW_ACCS, QCELL_MUL_WINDOW_NET != 0, BITS, A_LEN,
                        A_INTS, B_LEN, B_INTS, NEWLEN, NEWINTS>(a, b);
}

// mul_window_t as the emitted body calls it: one function per format,
// called from each of the body's multiplies (HIGH n=4: one format, fifty
// calls).
template <int BITS, int A_LEN, int A_INTS, int B_LEN, int B_INTS, int NEWLEN,
          int NEWINTS>
#if QCELL_MUL_WINDOW_INLINE
QI_FN
#else
QI_CALL_FN
#endif
MagF mul_window_t(uint64_t a, uint64_t b) {
  return mul_window_inl<BITS, A_LEN, A_INTS, B_LEN, B_INTS, NEWLEN, NEWINTS>(a, b);
}

// divide, flagged when the quotient has digits above the kept LEN
// (packed.py:567-569, pair_qfloat.py:474-478); read before the mask, so a
// zero divisor, which saturates all quotient digits, flags.
template <int BITS, int LEN, int INTS>
QI_FN MagF divide_t(uint64_t a, uint64_t d) {
  constexpr int kFp = LEN - INTS;
  constexpr int kNBits = BITS * (LEN + kFp);
  static_assert(kNBits <= 62, "dividend too wide");
  const uint64_t q = d == 0 ? low_mask(kNBits) : (a << (BITS * kFp)) / d;
  MagF r;
  r.m = q & low_mask(BITS * LEN);
  r.f = (q >> (BITS * LEN)) != 0;
  return r;
}

// invert, flagged only when the quotient is cropped, NEWLEN < kNDigits
// (packed.py:589-593, pair_qfloat.py:498-502); otherwise the flag is 0.
template <int BITS, int LEN, int INTS, int NEWLEN, int NEWINTS>
QI_FN MagF invert_t(uint64_t d) {
  constexpr int kFp = NEWLEN - NEWINTS;
  constexpr int kFpSelf = LEN - INTS;
  constexpr int kNDigits = 1 + kFpSelf + kFp;
  static_assert(BITS * kNDigits <= 62, "dividend too wide");
  const uint64_t q = d == 0 ? low_mask(BITS * kNDigits)
                            : (uint64_t(1) << (BITS * (kFpSelf + kFp))) / d;
  MagF r;
  if constexpr (NEWLEN < kNDigits) {
    r.m = q & low_mask(BITS * NEWLEN);
    r.f = (q >> (BITS * NEWLEN)) != 0;
  } else {
    r.m = q;
    r.f = 0;
  }
  return r;
}

}  // namespace qcell
