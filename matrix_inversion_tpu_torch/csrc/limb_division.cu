// limb_division.cu -- K6: restoring long division of digit arrays, any base.
//
// Replaces the quotient loop of the JAX package's limb backend,
// matrix_inversion_tpu/ops/limbs.py:195-228 (base_p_division, with the
// full-width borrow of _subtract_full_width, :162-192).  JAX has no Pallas
// kernel there: it runs the borrow chains as lax.scan over the digit axis
// inside one XLA program.  Run eagerly, that is ~175 launches a quotient
// digit; here one thread divides one number, its digits in registers.
//
// The function, for tidy digits (each in [0, p)), most significant first:
// q = floor(v / d) with d_len quotient digits, and all p - 1 digits where
// d = 0.  Per quotient digit i the remainder window takes dividend digit i
// on the right, then up to p - 1 rounds of full-width compare-subtract-
// select add one to the digit each time the window is not below d.
//
// The window.  JAX's grows from one digit to v_len + 1, then drops its
// leading digit at each step.  Here it is W >= v_len + 1 digits wide from
// the start, right-aligned, with the divisor right-aligned beside it and
// zero on the left, and it shifts left one digit a step.  The two agree
// digit for digit: a borrow chain over the extra leading zeros of both gives
// the same borrow as JAX's test of the divisor's digits above the window
// (divisor digits are >= 0); and the window before a round is below
// d * p <= p**(v_len + 1) whenever d > 0 (the last round left it below d,
// and one digit below p came in), so every digit left of the last v_len + 1
// is zero, and the digit JAX drops is zero too.  Where d = 0 every round
// subtracts nothing and the digit is p - 1 whatever the window holds.
//
// Rounds stop at the first window below d: the rounds after it in JAX's
// loop leave window and digit as they are.  So base 2 takes one round a
// digit and base 10 on average about five.
//
// Bound: operations.  A digit step (subtract with borrow, the borrow, the
// add-back, the select) is about four 32-bit instructions, and a number
// takes (rounds) x (window width) steps: ~2,500 at HIGH's reciprocal (61
// quotient digits over a 41-digit window), ~10k instructions, against 244
// bytes of dividend and 160 of divisor (a reciprocal's dividend is one row
// of constants, read from one address: v_stride 0).  Window widths up to 64
// are compile-time instances in multiples of 8 (the window and the
// divisor in registers); wider divisors, up to kMaxDivisorDigits, take a
// run-time form whose window lives in local memory.  Built with
// -DLIMB_RUNTIME_WINDOW, every width takes the run-time form: the build
// that chip_smoke.py times against the compile-time windows.  Past
// kMaxDivisorDigits a third form, limb_division_wide, keeps the window in
// a global scratch array that the caller allocates, number i's digit slot
// k at window[k * n + i] (a warp's accesses to one slot are contiguous).
// The window is a ring there: a step moves its start one slot instead of
// shifting every digit, and a round walks it twice, once for the borrow
// out of the compare and once to subtract, so that no difference is kept.
//
// Built with nvcc for sm_90a into a library with a plain C interface
// (ops/limb_kernels.py).  Without __CUDACC__ the file compiles as host C++
// with a loop in place of the launch, which is how the CPU tests run it.

#include "limb_frame.cuh"

namespace limbdiv {

constexpr int kMaxDivisorDigits = 256;
constexpr int kMaxWindow = kMaxDivisorDigits + 1;

// Number i's quotient: v the d_len dividend digits, d the v_len divisor
// digits, q the d_len quotient digits.  W > 0 fixes the window's width at
// compile time (W >= v_len + 1): the loops over it unroll and the window
// lives in registers.  W = 0 takes v_len + 1 at run time, in local memory.
template <int W>
LIMB_FN void divide_one(const int32_t* v, const int32_t* d, int32_t* q, int d_len, int v_len,
                        int base) {
  constexpr int kCap = W > 0 ? W : kMaxWindow;
  const int w = W > 0 ? W : v_len + 1;
  int32_t r[kCap], dv[kCap], diff[kCap];
#pragma unroll
  for (int j = 0; j < w; ++j) {
    const int k = j - (w - v_len);
    dv[j] = k >= 0 ? d[k] : 0;
    r[j] = 0;
  }
#pragma unroll 1
  for (int i = 0; i < d_len; ++i) {
#pragma unroll
    for (int j = 0; j + 1 < w; ++j) r[j] = r[j + 1];
    r[w - 1] = v[i];
    int32_t digit = 0;
#pragma unroll 1
    for (int round = 1; round < base; ++round) {
      int32_t borrow = 0;
#pragma unroll
      for (int j = w - 1; j >= 0; --j) {
        const int32_t t = r[j] - dv[j] - borrow;
        borrow = t < 0;
        diff[j] = t + (borrow ? base : 0);
      }
      if (borrow) break;  // the window is below d: this digit is done
#pragma unroll
      for (int j = 0; j < w; ++j) r[j] = diff[j];
      digit += 1;
    }
    q[i] = digit;
  }
}

template <int W>
struct Divide {
  const int32_t* v;
  int64_t v_stride;
  const int32_t* d;
  int32_t* q;
  int d_len, v_len, base;
  LIMB_FN void operator()(int64_t i) const {
    divide_one<W>(v + i * v_stride, d + i * v_len, q + i * d_len, d_len, v_len, base);
  }
};

// Any divisor width, the window in global scratch (see the header):
// slot (head + j) % w holds window digit j, most significant first.
struct DivideWide {
  const int32_t* v;
  int64_t v_stride;
  const int32_t* d;
  int32_t* q;
  int32_t* window;
  int64_t n;
  int d_len, v_len, base;
  LIMB_FN void operator()(int64_t i) const {
    const int w = v_len + 1;
    const int32_t* vi = v + i * v_stride;
    const int32_t* di = d + i * v_len;
    int32_t* r = window + i;
    for (int k = 0; k < w; ++k) r[k * n] = 0;
    int head = 0;
    for (int s = 0; s < d_len; ++s) {
      // the window shifts left: its leading digit's slot takes the new one
      const int last = head;
      head = head + 1 == w ? 0 : head + 1;
      r[last * n] = vi[s];
      int32_t digit = 0;
      for (int round = 1; round < base; ++round) {
        int32_t borrow = 0;
        for (int j = w - 1, k = last; j >= 0; --j, k = k == 0 ? w - 1 : k - 1) {
          borrow = r[k * n] - (j > 0 ? di[j - 1] : 0) - borrow < 0;
        }
        if (borrow) break;  // the window is below d: this digit is done
        for (int j = w - 1, k = last; j >= 0; --j, k = k == 0 ? w - 1 : k - 1) {
          const int32_t t = r[k * n] - (j > 0 ? di[j - 1] : 0) - borrow;
          borrow = t < 0;
          r[k * n] = t + (borrow ? base : 0);
        }
        digit += 1;
      }
      q[i * d_len + s] = digit;
    }
  }
};

template <int W>
int run(const void* v, int64_t v_stride, const void* d, void* q, int64_t n, int d_len, int v_len,
        int base, void* stream) {
  return limbframe::run(n, Divide<W>{static_cast<const int32_t*>(v), v_stride,
                                     static_cast<const int32_t*>(d), static_cast<int32_t*>(q),
                                     d_len, v_len, base},
                        stream);
}

}  // namespace limbdiv

// n quotients of d_len int32 digits: dividends of d_len digits, number i's
// at v + i * v_stride (v_stride d_len, or 0 for one dividend shared by all),
// divisors of v_len digits, contiguous.  Returns the launch's cudaError_t
// (kLimbInvalidValue for arguments outside the kernel's range).
extern "C" int LIMB_ENTRY(limb_division)(const void* v, int64_t v_stride, const void* d, void* q,
                                         int64_t n, int d_len, int v_len,
                                         int base LIMB_STREAM_PARAM) {
  using namespace limbdiv;
  if (d_len < 1 || v_len < 1 || v_len > kMaxDivisorDigits || base < 2) return kLimbInvalidValue;
#ifndef LIMB_RUNTIME_WINDOW
  switch ((v_len + 1 + 7) / 8) {
#define LIMB_WIDTH(k) \
  case k:             \
    return run<8 * k>(v, v_stride, d, q, n, d_len, v_len, base, LIMB_STREAM);
    LIMB_WIDTH(1) LIMB_WIDTH(2) LIMB_WIDTH(3) LIMB_WIDTH(4)
    LIMB_WIDTH(5) LIMB_WIDTH(6) LIMB_WIDTH(7) LIMB_WIDTH(8)
#undef LIMB_WIDTH
  }
#endif
  return run<0>(v, v_stride, d, q, n, d_len, v_len, base, LIMB_STREAM);
}

// The same for a divisor of any width, past kMaxDivisorDigits too: window
// is n * (v_len + 1) int32 of scratch, which the call overwrites.
extern "C" int LIMB_ENTRY(limb_division_wide)(const void* v, int64_t v_stride, const void* d,
                                              void* q, void* window, int64_t n, int d_len,
                                              int v_len, int base LIMB_STREAM_PARAM) {
  using namespace limbdiv;
  if (d_len < 1 || v_len < 1 || base < 2 || window == nullptr) return kLimbInvalidValue;
  return limbframe::run(n, DivideWide{static_cast<const int32_t*>(v), v_stride,
                                      static_cast<const int32_t*>(d), static_cast<int32_t*>(q),
                                      static_cast<int32_t*>(window), n, d_len, v_len, base},
                        LIMB_STREAM);
}
