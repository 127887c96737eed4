// limb_division.cu -- K6: long division of digit arrays, any base.
//
// Replaces the quotient loop of the JAX package's limb backend,
// matrix_inversion_tpu/ops/limbs.py:195-228 (base_p_division, with the
// full-width borrow of _subtract_full_width, :162-192).  JAX has no Pallas
// kernel there: it runs the borrow chains as lax.scan over the digit axis
// inside one XLA program.  Run eagerly, that is ~175 launches a quotient
// digit; here one thread divides one number.
//
// The function, for tidy digits (each in [0, p)), most significant first:
// q = floor(v / d) with d_len quotient digits, and all p - 1 digits where
// d = 0.  Per quotient digit i the remainder window takes dividend digit i
// on the right, then gives up as many multiples of d as it holds (at most
// p - 1): that count is the digit.
//
// The window in machine words.  JAX's window is a row of digits that grows
// to v_len + 1 and then drops its leading digit at each step.  For d > 0
// the window before a digit's rounds is below d * p <= p**(v_len + 1) (the
// last digit left it below d, and one digit below p came in), so it is an
// exact integer of at most (v_len + 1) log2 p bits, and the digit JAX drops
// is zero.  Here the window r and the divisor d are unsigned integers of K
// 64-bit words, least significant first, in registers, and the quotient
// digits come a chunk of k at a time: the long division runs in base p**k,
// the dividend's first chunk padded with zeros on the left, and the window
// stays below d * p**k < p**(v_len + k).  K is the fewest words that hold
// p**(v_len + k) - 1, a compile-time instance up to kMaxWords; k the most
// digits with p**k < 2**32 (31 at base 2, 20 at base 3, 9 at base 10)
// unless they take the window past the words one digit needs while half of
// them or more fit there, and then as many as fit (radix_of: one word and
// 24 digits at HIGH's 40 binary digits, three words and 9 digits at 40
// decimal ones).  The divisor is converted once a number (Horner over its
// chunks).  A chunk of quotient digits is then:
//   - the shift-in r = r * p**k + c, c the chunk's k dividend digits
//     gathered into one number (K multiply-adds by p**k);
//   - an estimate q' = floor(x (1 - 2**-46)), x = r / d in float64 from
//     the words (d's reciprocal once a number).  x is within (4K + 3) 2**-53
//     of r / d relatively, so q' is the chunk q or q - 1 (q < 2**32); a
//     multiply-subtract r -= q' d over K words;
//   - restoring rounds (compare r with d, subtract, q' + 1) until r < d:
//     one at most after the estimate.  A loop that adds d back while r - q'
//     d borrowed makes the chunk exact whatever the estimate;
//   - q split into its k digits by multiplies with p's inverse (Radix).
// The estimate was chosen over restoring rounds alone (a digit at a time,
// its q + 1 rounds, at most p - 1), whose cost grows with p: on an NVIDIA
// H100 80GB HBM3 at 700 W, 1,048,576 reciprocals of (61, 40) digits took,
// chunks with the estimate against restoring rounds, timed in turns in one
// chip_smoke.py run: base 3 0.205 / 0.386 ms, 4 0.208 / 0.408, 5 0.204 /
// 0.429, 6 0.207 / 0.450, 7 0.210 / 0.472, 8 0.224 / 0.501, 10 0.224 /
// 0.699, 16 0.234 / 0.910 (PERF.md).  A zero divisor gives every digit p -
// 1 and runs no round: its window would outgrow its words.
//
// Staging.  At HIGH's widths a number moves 640 bytes (160 of divisor, 240
// of dividend and of quotient) in a few hundred instructions.  A block of
// 128 numbers reads its divisors, its dividends and writes its quotients as
// contiguous runs through one shared buffer of 128 rows, each an odd number
// of 32-bit words (limbframe::stage), the digits in 16 bits up to base
// 2**16: the divisors first, converted; then the dividends, each chunk of
// quotient digits written over the dividend digits it came from; then the
// run of quotients out.  A reciprocal's dividend, one row for every number
// (v_stride 0), is read once a block into a row after the buffer.  16 KB a
// block at (60, 40): 13 blocks an SM.  Rows wider than kMaxStagedDigits do
// not fit a block's shared memory; past them, and past kMaxWords words, the
// wrapper takes limb_division_wide (below).
//
// Bound: bytes, the bytes above over the memory rate; the work the
// quotients need is less (chip_smoke.py, k6_work: per number the divisor's
// conversion, per chunk a shift-in, an estimate, a multiply-subtract and
// one round over K words, per digit its gather and split; ~310 32-bit
// instructions a number at base 2, (60, 40)).
//
// The form it replaced, built with -DLIMB_DIGIT_WINDOW, kept for timing:
// one thread a number with its window a row of W >= v_len + 1 int32 digits
// in registers (W a multiple of 8 up to 64; past it, up to
// kMaxDivisorDigits, in local memory), every round a borrow chain over all
// W digits, and each thread reading and writing its own rows (a warp's
// accesses 32 sectors apart).
//
// Past both, limb_division_wide keeps a digit window in a global scratch
// array that the caller allocates, number i's digit slot k at window[k * n
// + i] (a warp's accesses to one slot are contiguous).  The window is a
// ring there: a step moves its start one slot instead of shifting every
// digit, and a round walks it twice, once for the borrow out of the compare
// and once to subtract, so that no difference is kept.
//
// Built with nvcc for sm_90a into a library with a plain C interface
// (ops/limb_kernels.py).  Without __CUDACC__ the file compiles as host C++
// with loops in place of the launch (the staged kernel's phases block by
// block, thread by thread), which is how the CPU tests run it.

#include <math.h>

#include "limb_frame.cuh"

#ifndef __CUDACC__
#include <vector>
#endif

namespace limbdiv {

constexpr int kThreads = 128;
constexpr int kMaxWords = 8;
// The largest base whose digits are staged in 16 bits.
constexpr int kMaxShortBase = 1 << 16;
// The widest row staged: 128 rows of an odd stride <= 449 words and a
// reciprocal's row fit the 227 KB a block may have.
constexpr int kMaxStagedDigits = 449;
// The digit-window form's cap.
constexpr int kMaxDivisorDigits = 256;

// The base, and the quotient digits found at once: `chunk` of them, at most
// the most with base**chunk < 2**32, base_chunk
// = base**chunk, and inverse = ceil(2**64 / base), which splits a chunk into
// its digits by multiplies: floor(x / base) is the high word of x * inverse
// for x < 2**32 (the error x (inverse - 2**64 / base) / 2**64 is below
// 2**-32 <= 1 / base).
struct Radix {
  uint32_t base;
  int chunk;
  uint32_t base_chunk;
  uint64_t inverse;
};

// The fewest 64-bit words that hold base**digits - 1, for digits up to
// `last`, into words[digits], counted exactly in 32-bit limbs; kMaxWords +
// 1 past the cap.
inline void window_words(int base, int last, int* words) {
  constexpr int kLimbs = 2 * kMaxWords + 1;
  uint32_t x[kLimbs] = {1};
  for (int digits = 1; digits <= last; ++digits) {
    uint64_t carry = 0;
    for (int k = 0; k < kLimbs; ++k) {
      const uint64_t t = uint64_t(x[k]) * uint32_t(base) + carry;
      x[k] = uint32_t(t);
      carry = t >> 32;
    }
    int top = kLimbs - 1;
    while (top > 0 && x[top] == 0) --top;
    bool power_of_two = (x[top] & (x[top] - 1)) == 0;
    for (int k = 0; k < top; ++k) power_of_two = power_of_two && x[k] == 0;
    int bits = 32 * top;
    for (uint32_t t = x[top]; t != 0; t >>= 1) bits += 1;
    words[digits] = carry != 0 ? kMaxWords + 1 : (bits - power_of_two + 63) / 64;
    if (carry != 0) {
      for (int rest = digits + 1; rest <= last; ++rest) words[rest] = kMaxWords + 1;
      return;
    }
  }
}

// The chunk and the window's words for a divisor of v_len digits: the most
// digits a chunk, unless they take the window past the words one digit
// takes while half of them or more fit there; then as many as fit.  The
// words hold base**(v_len + chunk) - 1: the window stays below d *
// base**chunk.
inline Radix radix_of(int base, int v_len, int* words_out) {
  Radix rx{uint32_t(base), 1, uint32_t(base), ~uint64_t(0) / uint32_t(base) + 1};
  int most = 1;
  for (uint64_t b = base; b * uint32_t(base) < (uint64_t(1) << 32); b *= base) {
    most += 1;
  }
  int words[kMaxStagedDigits + 33];
  window_words(base, v_len + most, words);
  int fit = 1;
  while (fit < most && words[v_len + fit + 1] <= words[v_len + 1]) fit += 1;
  rx.chunk = 2 * fit < most ? most : fit;
  for (int k = 1; k < rx.chunk; ++k) rx.base_chunk *= rx.base;
  *words_out = words[v_len + rx.chunk];
  return rx;
}

// w * m + carry into the returned word, the carry out into `carry`
// (m and carry below 2**32, in and out).
LIMB_FN uint64_t mul_add(uint64_t w, uint32_t m, uint64_t& carry) {
  const uint64_t lo = (w & 0xffffffffu) * m + carry;
  const uint64_t hi = (w >> 32) * m + (lo >> 32);
  carry = hi >> 32;
  return (hi << 32) | (lo & 0xffffffffu);
}

// The high word of x * m, x < 2**32.
LIMB_FN uint32_t mul_high(uint32_t x, uint64_t m) {
  return uint32_t((uint64_t(x) * (m >> 32) + ((uint64_t(x) * uint32_t(m)) >> 32)) >> 32);
}

// The chunk of rx.chunk digits of a row that starts at digit `start` (< 0:
// zeros on the left), as one number below base_chunk.
template <class Slot>
LIMB_FN uint32_t gather(const Slot* row, int start, const Radix& rx) {
  uint32_t value = 0;
  for (int j = 0; j < rx.chunk; ++j) {
    value = value * rx.base + (start + j >= 0 ? uint32_t(row[start + j]) : 0u);
  }
  return value;
}

// One restoring round: r -= d unless r < d; whether it subtracted.
template <int K>
LIMB_FN bool subtract_if_not_below(uint64_t* r, const uint64_t* d) {
  uint64_t diff[K];
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint64_t t = r[k] - d[k];
    diff[k] = t - borrow;
    borrow = (r[k] < d[k]) | (t < borrow);
  }
  if (borrow) return false;
#pragma unroll
  for (int k = 0; k < K; ++k) r[k] = diff[k];
  return true;
}

// A number's divisor: its digits (most significant first) into K words,
// a chunk at a time, and 1 / d in float64 (0 where d = 0).
template <int K, class Slot>
LIMB_FN double load_divisor(const Slot* digits, int v_len, const Radix& rx, uint64_t* d) {
#pragma unroll
  for (int k = 0; k < K; ++k) d[k] = 0;
  const int chunks = (v_len + rx.chunk - 1) / rx.chunk;
  for (int c = 0, start = v_len - chunks * rx.chunk; c < chunks; ++c, start += rx.chunk) {
    uint64_t carry = gather(digits, start, rx);
#pragma unroll
    for (int k = 0; k < K; ++k) d[k] = mul_add(d[k], rx.base_chunk, carry);
  }
  double df = 0;
#pragma unroll
  for (int k = K - 1; k >= 0; --k) df = df * 0x1p64 + double(d[k]);
  return df == 0 ? 0 : 1 / df;
}

// A number's d_len quotient digits into q from its dividend digits v (q may
// be v: a chunk's digits are read before its quotient digits are written),
// by the divisor d in K words with reciprocal inv.  The dividend is taken a
// chunk at a time, the first chunk with zeros on its left.
template <int K, class In, class Out>
LIMB_FN void divide_row(const uint64_t* d, double inv, const In* v, Out* q, int d_len,
                        const Radix& rx) {
  if (inv == 0) {
    for (int i = 0; i < d_len; ++i) q[i] = Out(rx.base - 1);
    return;
  }
  uint64_t r[K];
#pragma unroll
  for (int k = 0; k < K; ++k) r[k] = 0;
  const int chunks = (d_len + rx.chunk - 1) / rx.chunk;
  for (int c = 0, start = d_len - chunks * rx.chunk; c < chunks; ++c, start += rx.chunk) {
    uint64_t carry = gather(v, start, rx);
#pragma unroll
    for (int k = 0; k < K; ++k) r[k] = mul_add(r[k], rx.base_chunk, carry);
    double rf = 0;
#pragma unroll
    for (int k = K - 1; k >= 0; --k) rf = rf * 0x1p64 + double(r[k]);
    // the chunk's quotient, below base_chunk: estimated, then made exact
    uint32_t digit = uint32_t(fmin(rf * inv * (1 - 0x1p-46), double(rx.base_chunk - 1)));
    // r -= digit * d, which fits K words since digit < base_chunk
    uint64_t mul_carry = 0, borrow = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint64_t prod = mul_add(d[k], digit, mul_carry);
      const uint64_t t = r[k] - prod;
      const uint64_t b = (r[k] < prod) | (t < borrow);
      r[k] = t - borrow;
      borrow = b;
    }
    while (borrow) {  // the estimate was above the digit: add d back
      digit -= 1;
      uint64_t add_carry = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const uint64_t t = r[k] + d[k];
        const uint64_t s = t + add_carry;
        add_carry = (t < r[k]) | (s < t);
        r[k] = s;
      }
      borrow = !add_carry;
    }
    while (digit < rx.base_chunk - 1 && subtract_if_not_below<K>(r, d)) digit += 1;
    for (int j = rx.chunk - 1; j >= 0; --j) {
      const uint32_t rest = mul_high(digit, rx.inverse);
      if (start + j >= 0) q[start + j] = Out(digit - rest * rx.base);
      digit = rest;
    }
  }
}

// The staging buffer's row stride in slots: an odd number of 32-bit words
// that hold max(d_len, v_len) slots, so that a warp's threads, one a row,
// fall in 32 banks.
template <class Slot>
LIMB_HOST_FN int slot_stride(int d_len, int v_len) {
  const int len = d_len > v_len ? d_len : v_len;
  return ((len * int(sizeof(Slot)) + 3) / 4 | 1) * 4 / int(sizeof(Slot));
}

// Bytes of shared memory a block takes: kThreads rows, then a reciprocal's
// row of int32.
template <class Slot>
size_t staged_bytes(int d_len, int v_len, bool one_row) {
  return size_t(kThreads) * slot_stride<Slot>(d_len, v_len) * sizeof(Slot) +
         (one_row ? size_t(d_len) * sizeof(int32_t) : 0);
}

#ifdef __CUDACC__

// A block's 128 numbers: divisors staged in and converted, dividends staged
// in and divided in place, quotients staged out.  Slot: a staged digit's
// type.
template <int K, class Slot>
__global__ void __launch_bounds__(kThreads)
staged_kernel(const int32_t* v, int64_t v_stride, const int32_t* d, int32_t* q, int64_t n,
              int d_len, int v_len, Radix rx) {
  extern __shared__ int32_t smem[];
  const int stride = slot_stride<Slot>(d_len, v_len);
  Slot* buf = reinterpret_cast<Slot*>(smem);
  int32_t* shared_row = smem + kThreads * stride * int(sizeof(Slot)) / 4;
  const int t = threadIdx.x;
  const int64_t first = int64_t(blockIdx.x) * kThreads;
  const int rows = int(n - first < kThreads ? n - first : kThreads);
  limbframe::stage(const_cast<int32_t*>(d) + first * v_len, buf, rows, v_len, stride, t,
                   kThreads, true);
  __syncthreads();
  uint64_t dw[K];
  const double inv = t < rows ? load_divisor<K>(buf + t * stride, v_len, rx, dw) : 0;
  __syncthreads();
  if (v_stride == 0) {
    for (int j = t; j < d_len; j += kThreads) shared_row[j] = v[j];
  } else {
    limbframe::stage(const_cast<int32_t*>(v) + first * d_len, buf, rows, d_len, stride, t,
                     kThreads, true);
  }
  __syncthreads();
  if (t < rows) {
    Slot* row = buf + t * stride;
    if (v_stride == 0) {
      divide_row<K>(dw, inv, shared_row, row, d_len, rx);
    } else {
      divide_row<K>(dw, inv, row, row, d_len, rx);
    }
  }
  __syncthreads();
  limbframe::stage(q + first * d_len, buf, rows, d_len, stride, t, kThreads, false);
}

template <int K, class Slot>
int run_staged(const int32_t* v, int64_t v_stride, const int32_t* d, int32_t* q, int64_t n,
               int d_len, int v_len, const Radix& rx, void* stream) {
  if (n <= 0) return 0;
  const size_t bytes = staged_bytes<Slot>(d_len, v_len, v_stride == 0);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        staged_kernel<K, Slot>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return int(err);
  }
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  staged_kernel<K, Slot>
      <<<unsigned(blocks), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
          v, v_stride, d, q, n, d_len, v_len, rx);
  return int(cudaGetLastError());
}

#else

// The host form of the staged kernel: its phases, block by block, thread by
// thread, each thread's divisor words kept between them.
template <int K, class Slot>
int run_staged(const int32_t* v, int64_t v_stride, const int32_t* d, int32_t* q, int64_t n,
               int d_len, int v_len, const Radix& rx, void*) {
  const int stride = slot_stride<Slot>(d_len, v_len);
  std::vector<Slot> buf(size_t(kThreads) * stride);
  std::vector<int32_t> shared_row(d_len);
  uint64_t dw[kThreads][K];
  double inv[kThreads];
  for (int64_t first = 0; first < n; first += kThreads) {
    const int rows = int(n - first < kThreads ? n - first : kThreads);
    for (int t = 0; t < kThreads; ++t) {
      limbframe::stage(const_cast<int32_t*>(d) + first * v_len, buf.data(), rows, v_len, stride,
                       t, kThreads, true);
    }
    for (int t = 0; t < rows; ++t) inv[t] = load_divisor<K>(&buf[t * stride], v_len, rx, dw[t]);
    for (int t = 0; t < kThreads; ++t) {
      if (v_stride == 0) {
        for (int j = t; j < d_len; j += kThreads) shared_row[j] = v[j];
      } else {
        limbframe::stage(const_cast<int32_t*>(v) + first * d_len, buf.data(), rows, d_len, stride,
                         t, kThreads, true);
      }
    }
    for (int t = 0; t < rows; ++t) {
      Slot* row = &buf[t * stride];
      if (v_stride == 0) {
        divide_row<K>(dw[t], inv[t], shared_row.data(), row, d_len, rx);
      } else {
        divide_row<K>(dw[t], inv[t], row, row, d_len, rx);
      }
    }
    for (int t = 0; t < kThreads; ++t) {
      limbframe::stage(q + first * d_len, buf.data(), rows, d_len, stride, t, kThreads, false);
    }
  }
  return 0;
}

#endif  // __CUDACC__

// The staged kernel at K words, its digits staged in 16 bits where the base
// allows.
template <int K>
int run_words(const int32_t* v, int64_t v_stride, const int32_t* d, int32_t* q, int64_t n,
              int d_len, int v_len, const Radix& rx, void* stream) {
  if (rx.base <= uint32_t(kMaxShortBase)) {
    return run_staged<K, uint16_t>(v, v_stride, d, q, n, d_len, v_len, rx, stream);
  }
  return run_staged<K, int32_t>(v, v_stride, d, q, n, d_len, v_len, rx, stream);
}

#ifdef LIMB_DIGIT_WINDOW

// The digit-window form: number i's quotient, v the d_len dividend digits,
// d the v_len divisor digits, q the d_len quotient digits.  W > 0 fixes the
// window's width at compile time (W >= v_len + 1): the loops over it unroll
// and the window lives in registers.  W = 0 takes v_len + 1 at run time, in
// local memory.
template <int W>
LIMB_FN void divide_one(const int32_t* v, const int32_t* d, int32_t* q, int d_len, int v_len,
                        int base) {
  constexpr int kCap = W > 0 ? W : kMaxDivisorDigits + 1;
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

template <int W>
int run_digit_window(const void* v, int64_t v_stride, const void* d, void* q, int64_t n,
                     int d_len, int v_len, int base, void* stream) {
  return limbframe::run(n, Divide<W>{static_cast<const int32_t*>(v), v_stride,
                                     static_cast<const int32_t*>(d), static_cast<int32_t*>(q),
                                     d_len, v_len, base},
                        stream);
}

#endif  // LIMB_DIGIT_WINDOW

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

}  // namespace limbdiv

// n quotients of d_len int32 digits: dividends of d_len digits, number i's
// at v + i * v_stride (v_stride d_len, or 0 for one dividend shared by all),
// divisors of v_len digits, contiguous.  Returns the launch's cudaError_t
// (kLimbInvalidValue for arguments outside the kernel's range: rows wider
// than kMaxStagedDigits or a window of more than kMaxWords words; with
// -DLIMB_DIGIT_WINDOW divisors wider than kMaxDivisorDigits).
extern "C" int LIMB_ENTRY(limb_division)(const void* v, int64_t v_stride, const void* d, void* q,
                                         int64_t n, int d_len, int v_len,
                                         int base LIMB_STREAM_PARAM) {
  using namespace limbdiv;
  if (d_len < 1 || v_len < 1 || base < 2) return kLimbInvalidValue;
#ifdef LIMB_DIGIT_WINDOW
  if (v_len > kMaxDivisorDigits) return kLimbInvalidValue;
  switch ((v_len + 1 + 7) / 8) {
#define LIMB_WIDTH(k) \
  case k:             \
    return run_digit_window<8 * k>(v, v_stride, d, q, n, d_len, v_len, base, LIMB_STREAM);
    LIMB_WIDTH(1) LIMB_WIDTH(2) LIMB_WIDTH(3) LIMB_WIDTH(4)
    LIMB_WIDTH(5) LIMB_WIDTH(6) LIMB_WIDTH(7) LIMB_WIDTH(8)
#undef LIMB_WIDTH
  }
  return run_digit_window<0>(v, v_stride, d, q, n, d_len, v_len, base, LIMB_STREAM);
#else
  if ((v_stride != 0 && v_stride != d_len) || d_len > kMaxStagedDigits ||
      v_len > kMaxStagedDigits) {
    return kLimbInvalidValue;
  }
  const int32_t* vi = static_cast<const int32_t*>(v);
  const int32_t* di = static_cast<const int32_t*>(d);
  int32_t* qi = static_cast<int32_t*>(q);
  int words;
  const Radix rx = radix_of(base, v_len, &words);
  switch (words) {
#define LIMB_WORDS(k) \
  case k:             \
    return run_words<k>(vi, v_stride, di, qi, n, d_len, v_len, rx, LIMB_STREAM);
    LIMB_WORDS(1) LIMB_WORDS(2) LIMB_WORDS(3) LIMB_WORDS(4)
    LIMB_WORDS(5) LIMB_WORDS(6) LIMB_WORDS(7) LIMB_WORDS(8)
#undef LIMB_WORDS
  }
  return kLimbInvalidValue;
#endif
}

// The same for any widths: window is n * (v_len + 1) int32 of scratch,
// which the call overwrites.
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
