// qmarshal — native host-side QFloat marshalling for matrix_inversion_tpu_torch.
//
// A copy of the JAX package's native/qmarshal.cc (same five entry points,
// same ABI version), built at first use with g++ by runtime/native.py.  It
// converts large batches of float64 matrices into base-p digit arrays /
// packed int64 magnitudes and back (reference main.py:68-91,
// qfloat_matrix_inversion.py:222-309): for 10^5+ matrices per step this is
// real host work on the datapath feeding the card, so it runs here as a
// multithreaded C++ library, called through ctypes, which releases the GIL.
// ops/radix.py and models/marshal.py take it at 4,096 values or more and
// keep the numpy closed form below that, as the JAX package does.
//
// Semantics are bit-exact with ops/radix.py (and therefore with the
// reference converters): integer part digits by repeated divmod of the
// truncated magnitude, fraction digits by the float64 multiply-truncate
// loop, sign of 0.0 is +1.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int n_threads_for(int64_t n_items) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 4;
  int64_t want = n_items / 4096 + 1;
  return static_cast<int>(want < hw ? want : hw);
}

template <typename Fn>
void parallel_for(int64_t n, Fn fn) {
  int nt = n_threads_for(n);
  if (nt <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back([=] { fn(lo, hi); });
  }
  for (auto &th : threads) th.join();
}

}  // namespace

extern "C" {

// float64 values -> (digits int32[len] MSD-first, sign int32) per value.
// Matches radix.float_to_digits_and_sign.
void quantize_digits(const double *values, int64_t n_values, int32_t len,
                     int32_t ints, int32_t base, int32_t *digits_out,
                     int32_t *signs_out) {
  bool pow2 = (base & (base - 1)) == 0;
  int32_t k = 0;
  for (int32_t b = base; b > 1; b >>= 1) ++k;
  if (pow2 && static_cast<int64_t>(k) * len <= 62) {
    // closed form (see quantize_packed): one scale+truncate per value,
    // then peel digits with shifts — bit-exact with the loops below
    const int32_t fp_bits = k * (len - ints);
    const double fp_scale = std::ldexp(1.0, fp_bits);
    const int64_t int_mask = (int64_t{1} << (k * ints)) - 1;
    const int32_t dmask = base - 1;
    parallel_for(n_values, [&](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; ++i) {
        double f = values[i];
        double af = f < 0 ? -f : f;
        double int_part = std::trunc(af);
        int64_t mag =
            ((static_cast<int64_t>(int_part) & int_mask) << fp_bits) |
            static_cast<int64_t>((af - int_part) * fp_scale);
        int32_t *d = digits_out + i * len;
        for (int32_t j = 0; j < len; ++j) {
          d[j] = static_cast<int32_t>(mag >> (k * (len - 1 - j))) & dmask;
        }
        signs_out[i] = f > 0 ? 1 : (f < 0 ? -1 : 1);
      }
    });
    return;
  }
  parallel_for(n_values, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      double f = values[i];
      int64_t int_part = static_cast<int64_t>(f);  // trunc toward zero
      double frac = f - static_cast<double>(int_part);
      int32_t *d = digits_out + i * len;
      // integer digits, most significant first
      int64_t mag = int_part < 0 ? -int_part : int_part;
      for (int32_t j = ints - 1; j >= 0; --j) {
        d[j] = static_cast<int32_t>(mag % base);
        mag /= base;
      }
      // fraction digits: float64 multiply-truncate loop (same rounding as
      // the reference python loop)
      double fm = frac < 0 ? -frac : frac;
      for (int32_t j = ints; j < len; ++j) {
        fm *= base;
        int64_t digit = static_cast<int64_t>(fm);
        fm -= static_cast<double>(digit);
        d[j] = static_cast<int32_t>(digit);
      }
      signs_out[i] = f > 0 ? 1 : (f < 0 ? -1 : 1);  // sign of 0 is +1
    }
  });
}

// float64 values -> packed int64 magnitudes + signs (production fast path;
// base must be a power of two with base**len < 2**62).
void quantize_packed(const double *values, int64_t n_values, int32_t len,
                     int32_t ints, int32_t base, int64_t *mags_out,
                     int64_t *signs_out) {
  bool pow2 = (base & (base - 1)) == 0;
  int32_t k = 0;
  for (int32_t b = base; b > 1; b >>= 1) ++k;  // log2(base) when pow2
  if (pow2) {
    // Exact closed form of the digit loops below: for base 2**k every
    // step of the multiply-truncate fraction loop is an exact f64
    // operation (multiply by a power of two, truncate), so the loop
    // computes floor(|frac| * 2**fp_bits) — one scale + one truncate.
    // The integer digits are just the low k*ints bits.  Bit-exact with
    // the generic path (tests/test_torch_native.py), ~10x fewer ops, and the
    // branch-free body auto-vectorizes.
    const int32_t fp_bits = k * (len - ints);
    const double fp_scale = std::ldexp(1.0, fp_bits);  // 2**fp_bits, exact
    const int64_t int_mask = (int64_t{1} << (k * ints)) - 1;
    parallel_for(n_values, [&](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; ++i) {
        double f = values[i];
        double af = f < 0 ? -f : f;
        double int_part = std::trunc(af);
        int64_t int_mag = static_cast<int64_t>(int_part) & int_mask;
        int64_t frac_mag = static_cast<int64_t>((af - int_part) * fp_scale);
        mags_out[i] = (int_mag << fp_bits) | frac_mag;
        signs_out[i] = f > 0 ? 1 : (f < 0 ? -1 : 1);
      }
    });
    return;
  }
  parallel_for(n_values, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      double f = values[i];
      int64_t int_part = static_cast<int64_t>(f);
      double frac = f - static_cast<double>(int_part);
      int64_t mag = int_part < 0 ? -int_part : int_part;
      // clamp integer overflow the same way digit truncation would:
      // keep the low `ints` digits
      int64_t int_mod = 1;
      for (int32_t j = 0; j < ints; ++j) int_mod *= base;
      mag %= int_mod;
      double fm = frac < 0 ? -frac : frac;
      for (int32_t j = ints; j < len; ++j) {
        fm *= base;
        int64_t digit = static_cast<int64_t>(fm);
        fm -= static_cast<double>(digit);
        mag = mag * base + digit;
      }
      mags_out[i] = mag;
      signs_out[i] = f > 0 ? 1 : (f < 0 ? -1 : 1);
    }
  });
}

// (digits int32[len+1] with sign in the last slot) -> float64 values.
// Matches radix.digits_and_sign_to_float summation order.
void dequantize_digits(const int32_t *digits_and_sign, int64_t n_values,
                       int32_t len, int32_t ints, int32_t base,
                       double *values_out) {
  parallel_for(n_values, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const int32_t *d = digits_and_sign + i * (len + 1);
      double int_part = 0.0;
      for (int32_t j = 0; j < ints; ++j) {
        int_part = int_part * base + static_cast<double>(d[j]);
      }
      double frac = 0.0, place = 1.0;
      for (int32_t j = ints; j < len; ++j) {
        place /= base;
        frac += static_cast<double>(d[j]) * place;
      }
      values_out[i] = (int_part + frac) * static_cast<double>(d[len]);
    }
  });
}

// packed magnitudes + signs -> float64 values.
void dequantize_packed(const int64_t *mags, const int64_t *signs,
                       int64_t n_values, int32_t len, int32_t ints,
                       int32_t base, double *values_out) {
  double scale = std::pow(static_cast<double>(base),
                          -static_cast<double>(len - ints));
  parallel_for(n_values, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      values_out[i] =
          static_cast<double>(mags[i]) * scale * static_cast<double>(signs[i]);
    }
  });
}

// digit arrays -> packed magnitudes (device-format conversion on host).
void pack_digits(const int32_t *digits, int64_t n_values, int32_t len,
                 int32_t base, int64_t *mags_out) {
  parallel_for(n_values, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const int32_t *d = digits + i * len;
      int64_t mag = 0;
      for (int32_t j = 0; j < len; ++j) mag = mag * base + d[j];
      mags_out[i] = mag;
    }
  });
}

int32_t qmarshal_abi_version() { return 1; }

}  // extern "C"
