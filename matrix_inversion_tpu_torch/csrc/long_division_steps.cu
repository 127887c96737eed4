// long_division_steps.cu -- the steps of the op-by-op kernels' design,
// side by side, for timing (utils/division_steps.py).  Not on any path of
// the port.
//
// long_division.cu and mul_window.cu are included whole, so the frame and
// the element functions timed here are the ones the port launches.  Beside
// them stand what they replaced: the port's first frame (one element per
// thread, 64-bit accesses; the port keeps it for what 128-bit accesses
// cannot take) and its first element functions (K2 with 64-bit conversions
// and run-time shifts, K3 as the digit-serial restoring loop, K4 as the sum
// of rows read from a table), and the card's own 64-bit `/`, which the
// fused kernel's divide runs.  Any frame can run any element function:
//   frame 0  one element per thread          division op 0  first K2
//   frame 1  the streaming frame, 1 pair     division op 1  first K3
//   frame 2  the streaming frame, 2 pairs    division op 2  K2, run-time (n_bits, k)
//                                            division op 3  K2, compile-time (60 or 61, 15)
//                                            division op 4  K3
//                                            division op 5  the card's `/`
//                                            multiply op 0  first K4 (the row table)
//                                            multiply op 1  K4's algebra in 128 bits
//                                                           (K1's mul_inl), run-time format
//                                            multiply op 2  K4, C in 32 bits, run-time format
//                                            multiply op 3  K4, High's compile-time instance
// Compiles as host C++ too (the frames are then one loop), where the tests
// hold the first element functions against the present ones.

#include "long_division.cu"
#include "mul_window.cu"

namespace divsteps {

using longdiv::low_mask;

#ifdef __CUDACC__
LD_FN float u64_to_f32(uint64_t x) { return __ull2float_rn(x); }
#else
LD_FN float u64_to_f32(uint64_t x) { return float(x); }
#endif

// The first K2: the reciprocal from a 64-bit conversion of d, and per chunk
// a 64-bit conversion of r, floorf and a cast to int64_t, a clamp.
struct FirstFloat {
  int n_bits, k;
  LD_FN uint64_t operator()(uint64_t v, uint64_t d) const {
    const bool zero = d == 0;
    const uint64_t ds = zero ? 1 : d;
    const float rdf = longdiv::f32_div(longdiv::kBias, u64_to_f32(ds));
    const int n_chunks = (n_bits + k - 1) / k;
    const int first = n_bits - k * (n_chunks - 1);
    uint64_t r = 0, q = 0;
    int consumed = 0;
    for (int c = 0; c < n_chunks; ++c) {
      const int kc = c == 0 ? first : k;
      consumed += kc;
      r = (r << kc) | ((v >> (n_bits - consumed)) & low_mask(kc));
      int64_t qc = int64_t(floorf(longdiv::f32_mul(u64_to_f32(r), rdf)));
      const int64_t qmax = int64_t(low_mask(kc));
      qc = qc < 0 ? 0 : (qc > qmax ? qmax : qc);
      uint64_t rem = r - uint64_t(qc) * ds;
      if (rem >= ds) {
        qc += 1;
        rem -= ds;
      }
      r = rem;
      q = (q << kc) | uint64_t(qc);
    }
    return zero ? low_mask(n_bits) : q;
  }
};

// The first K3: restoring division, one base-2**bits digit per step,
// (base - 1) compare-subtracts each.
struct FirstClassic {
  int n_digits, bits;
  LD_FN uint64_t operator()(uint64_t v, uint64_t d) const {
    const uint64_t digit_mask = low_mask(bits);
    const int subtracts = (1 << bits) - 1;
    uint64_t r = 0, q = 0;
    for (int i = 0; i < n_digits; ++i) {
      r = (r << bits) | ((v >> (bits * (n_digits - 1 - i))) & digit_mask);
      uint64_t qdigit = 0;
      for (int s = 0; s < subtracts; ++s) {
        const uint64_t ge = r >= d;
        r -= d & (uint64_t(0) - ge);
        qdigit += ge;
      }
      q = (q << bits) | qdigit;
    }
    return q;
  }
};

// The card's own 64-bit division.
struct Native {
  int n_bits;
  LD_FN uint64_t operator()(uint64_t v, uint64_t d) const {
    return d == 0 ? low_mask(n_bits) : (v & low_mask(n_bits)) / d;
  }
};

// The first K4: the rows of ops/packed.py::mul_window_consts for the
// operands' formats, by value (at most 62 rows, 1.3 KB of kernel
// parameters), as utils/division_steps.py::MulWindowTable lays them out.
constexpr int kMaxRows = 62;

struct MulWindowTable {
  uint64_t b_mask[kMaxRows];
  uint64_t out_mask;
  int32_t a_shift[kMaxRows];
  int32_t b_shift[kMaxRows];
  int32_t out_shift[kMaxRows];
  int32_t rows;
};

// One cropped partial product per row, summed in a uint64_t that wraps mod
// 2**64, then masked to the output window.  At base 2 a digit is 0 or 1, so
// each partial product is a mask, not a multiply.  The row loop is unrolled
// to the table's capacity and stops at its row count, so every row is read
// at a constant offset: 20 instructions a row, two of them run-time 64-bit
// shifts.
struct FirstMul {
  MulWindowTable t;
  LD_FN uint64_t operator()(uint64_t a, uint64_t b) const {
    uint64_t acc = 0;
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i) {
      if (i >= t.rows) break;
      const uint64_t digit = (a >> t.a_shift[i]) & 1;
      const uint64_t window = ((b >> t.b_shift[i]) & t.b_mask[i]) << t.out_shift[i];
      acc += window & (uint64_t(0) - digit);
    }
    return acc & t.out_mask;
  }
};

struct Call {
  int frame;
  const void* x;
  const void* y;
  void* out;
  int64_t n;
  int x_stride;
  void* stream;
  template <class Op>
  int operator()(Op op) const {
#ifdef __CUDACC__
    if (n <= 0) return 0;
    if (frame == 1) return sframe::launch_stream<1>(op, x, x_stride, y, out, n, stream);
    if (frame == 2) return sframe::launch_stream<2>(op, x, x_stride, y, out, n, stream);
    return sframe::launch_scalar(op, static_cast<const uint64_t*>(x), x_stride,
                                 static_cast<const uint64_t*>(y), static_cast<uint64_t*>(out), n,
                                 static_cast<cudaStream_t>(stream));
#else
    return sframe::host_stream(op, x, x_stride, y, out, n);
#endif
  }
};

}  // namespace divsteps

// One launch of division element function `op` in frame `frame`; -1 for a
// pair the file does not hold.
extern "C" int SF_ENTRY(division_step)(int frame, int op, const void* v, const void* d, void* q,
                                       int64_t n, int v_stride, int n_bits, int k SF_STREAM_PARAM) {
  if (frame < 0 || frame > 2) return -1;
  const divsteps::Call call{frame, v, d, q, n, v_stride, SF_STREAM};
  switch (op) {
    case 0: return call(divsteps::FirstFloat{n_bits, k});
    case 1: return call(divsteps::FirstClassic{n_bits, 1});
    case 2: return call(longdiv::FloatAny{n_bits, k});
    case 3:
      if (k == 15 && n_bits == 60) return call(longdiv::FloatFixed<60, 15>{});
      if (k == 15 && n_bits == 61) return call(longdiv::FloatFixed<61, 15>{});
      return -1;
    case 4: return call(longdiv::Classic{n_bits});
    case 5: return call(divsteps::Native{n_bits});
  }
  return -1;
}

// One launch of multiply element function `op` in frame `frame`: (t1, nt,
// newlength) as mul_window.cu takes them, `table` for the first K4.  -1 for
// a pair the file does not hold: the 32-bit correction where C does not fit
// 32 bits or the product 64, the compile-time instance at any format but
// High's.
extern "C" int SF_ENTRY(mul_step)(int frame, int op, const void* a, const void* b, void* out,
                                  int64_t n, int a_stride, int t1, int nt, int newlength,
                                  const divsteps::MulWindowTable* table SF_STREAM_PARAM) {
  if (frame < 0 || frame > 2 || t1 <= 0) return -1;
  const divsteps::Call call{frame, a, b, out, n, a_stride, SF_STREAM};
  const uint64_t out_mask = qcell::low_mask(newlength);
  switch (op) {
    case 0: return call(divsteps::FirstMul{*table});
    case 1: return call(mulwin::TruncAny<mulwin::u128, mulwin::u128>{t1, nt, out_mask});
    case 2:
      if (t1 + newlength > 64 || !mulwin::c_fits(t1, nt, 32)) return -1;
      return call(mulwin::TruncAny<uint32_t, uint64_t>{t1, nt, out_mask});
    case 3:
      if (t1 != 20 || nt != 20 || newlength != 40) return -1;
      return call(mulwin::TruncFixed<20, 20, 40>{});
  }
  return -1;
}
