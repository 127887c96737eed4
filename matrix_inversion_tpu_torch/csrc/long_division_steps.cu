// long_division_steps.cu -- the steps of the division kernels' design,
// side by side, for timing (utils/division_steps.py).  Not on any path of
// the port.
//
// long_division.cu is included whole, so the frame and the element
// functions timed here are the ones the port launches.  Beside them stand
// what they replaced: the port's first frame (one element per thread,
// 64-bit accesses; the port keeps it for what 128-bit accesses cannot
// take) and its first element functions (K2 with 64-bit conversions and
// run-time shifts, K3 as the digit-serial restoring loop), and the card's
// own 64-bit `/`, which the fused kernel's divide runs.  Any frame can run
// any element function:
//   frame 0  one element per thread          op 0  first K2
//   frame 1  the streaming frame, 1 pair     op 1  first K3
//   frame 2  the streaming frame, 2 pairs    op 2  K2, run-time (n_bits, k)
//                                            op 3  K2, compile-time (60 or 61, 15)
//                                            op 4  K3
//                                            op 5  the card's `/`
// Compiles as host C++ too (the frames are then one loop), where the tests
// hold the first element functions against the present ones.

#include "long_division.cu"

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

struct Call {
  int frame;
  const void* v;
  const void* d;
  void* q;
  int64_t n;
  int v_stride;
  void* stream;
  template <class Op>
  int operator()(Op op) const {
#ifdef __CUDACC__
    if (n <= 0) return 0;
    if (frame == 1) return longdiv::launch_stream<1>(op, v, v_stride, d, q, n, stream);
    if (frame == 2) return longdiv::launch_stream<2>(op, v, v_stride, d, q, n, stream);
    return longdiv::launch_scalar(op, static_cast<const uint64_t*>(v), v_stride,
                                  static_cast<const uint64_t*>(d), static_cast<uint64_t*>(q), n,
                                  static_cast<cudaStream_t>(stream));
#else
    return longdiv::host_stream(op, v, v_stride, d, q, n);
#endif
  }
};

}  // namespace divsteps

// One launch of element function `op` in frame `frame`; -1 for a pair the
// file does not hold.
extern "C" int LD_ENTRY(division_step)(int frame, int op, const void* v, const void* d, void* q,
                                       int64_t n, int v_stride, int n_bits, int k LD_STREAM_PARAM) {
  if (frame < 0 || frame > 2) return -1;
  const divsteps::Call call{frame, v, d, q, n, v_stride, LD_STREAM};
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
