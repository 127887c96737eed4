// float_io.cu -- the float stream's packed quantize and dequantize on the card:
// float64 values to int64 magnitudes and signs, and back.
//
// No Pallas kernel: the JAX package converts on the host, in
// native/qmarshal.cc, and so did the port's StreamingInverter
// (csrc/qmarshal.cc::quantize_packed and ::dequantize_packed), whose host
// stages set the float stream's pace.  These kernels give that route's bits
// exactly, so a packed batch can cross PCIe as float64 and the host only
// copies.
//
// float_quantize_kernel: qmarshal.cc::quantize_packed's power-of-two closed
// form.  At base 2**bits every step of the reference's multiply-truncate
// fraction loop is exact in float64, so the magnitude is the low bits * ints
// bits of trunc(|x|), shifted up fp_bits = bits * (len - ints), or'ed with
// trunc((|x| - trunc(|x|)) * 2**fp_bits); the sign is -1 below 0 and +1
// otherwise (+0.0, -0.0 and NaN).  The host's static_cast<int64_t> of a value
// out of int64's range (|x| >= 2**63, +-inf, NaN) gives x86-64's
// 0x8000000000000000, where the card's conversion saturates (or gives 0 for a
// NaN), so to_int64 below gives that value explicitly.
// float_dequantize_kernel: (double)mag * scale * (double)sign, in that order,
// each int64 converted to nearest as the host does, with scale = base**-(len -
// ints) computed on the host as qmarshal.cc computes it.
//
// Bound: bytes.  Each kernel reads every byte once and writes every byte
// once: 8 bytes in and 16 out a value, or 16 in and 8 out.  At the High
// preset, n = 4 and 1,048,576 matrices (16,777,216 values) each moves 403 MB,
// 0.120 ms at 3.35 TB/s; at n = 10 and 262,144 matrices 629 MB, 0.188 ms.
// One thread takes two neighbouring values, in 16-byte accesses where every
// array is 16-byte aligned (streaming loads and stores: nothing is read
// twice), and value by value where one is not.
//
// Built with nvcc (--fmad=false) for sm_90a into a library with a plain C
// interface (ops/float_io.py).  Without __CUDACC__ the file compiles as host
// C++, the launch replaced by a loop over the threads, which is how the CPU
// tests run the same code.

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define FIO_FN __device__ __forceinline__
#else
#define FIO_FN inline
#endif

namespace floatio {

constexpr int kThreads = 256;  // threads a block, two values a thread

// The conversion of x86-64's cvttsd2si, which the host route's
// static_cast<int64_t> compiles to: toward zero, and 0x8000000000000000 for
// a value out of int64's range or a NaN.
FIO_FN int64_t to_int64(double x) {
  return (x >= -0x1p63 && x < 0x1p63) ? int64_t(x) : INT64_MIN;
}

// The packed format: fp_bits fraction bits, the integer part's mask.
struct Format {
  int fp_bits;
  double fp_scale;  // 2**fp_bits, exact
  int64_t int_mask;
};

FIO_FN void quantize_one(double f, const Format& fmt, int64_t& mag, int64_t& sign) {
  const double af = f < 0 ? -f : f;
  const double int_part = trunc(af);
  const int64_t int_mag = to_int64(int_part) & fmt.int_mask;
  const int64_t frac_mag = to_int64((af - int_part) * fmt.fp_scale);
  mag = (int_mag << fmt.fp_bits) | frac_mag;
  sign = f > 0 ? 1 : (f < 0 ? -1 : 1);
}

FIO_FN double dequantize_one(int64_t mag, int64_t sign, double scale) {
  return double(mag) * scale * double(sign);
}

// Thread `pair`'s values 2 * pair and 2 * pair + 1 (those below `count`).
template <bool kVec>
FIO_FN void quantize_pair(const double* values, int64_t* mags, int64_t* signs, int64_t count,
                          int64_t pair, const Format& fmt) {
  const int64_t i = 2 * pair;
  if (i >= count) return;
  if (kVec && i + 1 < count) {
    double f[2];
    int64_t m[2], s[2];
#ifdef __CUDACC__
    const double2 v = __ldcs(reinterpret_cast<const double2*>(values + i));
    f[0] = v.x, f[1] = v.y;
#else
    memcpy(f, values + i, sizeof f);
#endif
    quantize_one(f[0], fmt, m[0], s[0]);
    quantize_one(f[1], fmt, m[1], s[1]);
#ifdef __CUDACC__
    __stcs(reinterpret_cast<longlong2*>(mags + i), make_longlong2(m[0], m[1]));
    __stcs(reinterpret_cast<longlong2*>(signs + i), make_longlong2(s[0], s[1]));
#else
    memcpy(mags + i, m, sizeof m);
    memcpy(signs + i, s, sizeof s);
#endif
    return;
  }
  for (int64_t j = i; j < count && j < i + 2; ++j) quantize_one(values[j], fmt, mags[j], signs[j]);
}

template <bool kVec>
FIO_FN void dequantize_pair(const int64_t* mags, const int64_t* signs, double* out, int64_t count,
                            int64_t pair, double scale) {
  const int64_t i = 2 * pair;
  if (i >= count) return;
  if (kVec && i + 1 < count) {
    int64_t m[2], s[2];
    double f[2];
#ifdef __CUDACC__
    const longlong2 vm = __ldcs(reinterpret_cast<const longlong2*>(mags + i));
    const longlong2 vs = __ldcs(reinterpret_cast<const longlong2*>(signs + i));
    m[0] = vm.x, m[1] = vm.y, s[0] = vs.x, s[1] = vs.y;
#else
    memcpy(m, mags + i, sizeof m);
    memcpy(s, signs + i, sizeof s);
#endif
    f[0] = dequantize_one(m[0], s[0], scale);
    f[1] = dequantize_one(m[1], s[1], scale);
#ifdef __CUDACC__
    __stcs(reinterpret_cast<double2*>(out + i), make_double2(f[0], f[1]));
#else
    memcpy(out + i, f, sizeof f);
#endif
    return;
  }
  for (int64_t j = i; j < count && j < i + 2; ++j) out[j] = dequantize_one(mags[j], signs[j], scale);
}

inline int64_t pairs_of(int64_t count) { return (count + 1) / 2; }

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

#ifdef __CUDACC__

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
float_quantize_kernel(const double* __restrict__ values, int64_t* __restrict__ mags,
                      int64_t* __restrict__ signs, int64_t count, Format fmt) {
  quantize_pair<kVec>(values, mags, signs, count, int64_t(blockIdx.x) * kThreads + threadIdx.x,
                      fmt);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
float_dequantize_kernel(const int64_t* __restrict__ mags, const int64_t* __restrict__ signs,
                        double* __restrict__ out, int64_t count, double scale) {
  dequantize_pair<kVec>(mags, signs, out, count, int64_t(blockIdx.x) * kThreads + threadIdx.x,
                        scale);
}

inline unsigned blocks_of(int64_t count) {
  return unsigned((pairs_of(count) + kThreads - 1) / kThreads);
}

int quantize(const double* values, int64_t* mags, int64_t* signs, int64_t count,
             const Format& fmt, bool vec, void* stream) {
  const auto kernel = vec ? float_quantize_kernel<true> : float_quantize_kernel<false>;
  kernel<<<blocks_of(count), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      values, mags, signs, count, fmt);
  return int(cudaGetLastError());
}

int dequantize(const int64_t* mags, const int64_t* signs, double* out, int64_t count,
               double scale, bool vec, void* stream) {
  const auto kernel = vec ? float_dequantize_kernel<true> : float_dequantize_kernel<false>;
  kernel<<<blocks_of(count), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mags, signs, out, count, scale);
  return int(cudaGetLastError());
}

#else

// The host form of the kernels: one thread's pair after another.
int quantize(const double* values, int64_t* mags, int64_t* signs, int64_t count,
             const Format& fmt, bool vec, void*) {
  for (int64_t pair = 0; pair < pairs_of(count); ++pair) {
    if (vec) {
      quantize_pair<true>(values, mags, signs, count, pair, fmt);
    } else {
      quantize_pair<false>(values, mags, signs, count, pair, fmt);
    }
  }
  return 0;
}

int dequantize(const int64_t* mags, const int64_t* signs, double* out, int64_t count,
               double scale, bool vec, void*) {
  for (int64_t pair = 0; pair < pairs_of(count); ++pair) {
    if (vec) {
      dequantize_pair<true>(mags, signs, out, count, pair, scale);
    } else {
      dequantize_pair<false>(mags, signs, out, count, pair, scale);
    }
  }
  return 0;
}

#endif  // __CUDACC__

}  // namespace floatio

// The C entry points: name_launch(..., stream) on the card, name_host(...) in
// the host build.
#ifdef __CUDACC__
#define FIO_ENTRY(name) name##_launch
#define FIO_STREAM_PARAM , void* stream
#define FIO_STREAM stream
#else
#define FIO_ENTRY(name) name##_host
#define FIO_STREAM_PARAM
#define FIO_STREAM nullptr
#endif

// What an entry point returns for arguments it does not take
// (cudaErrorInvalidValue); the wrappers check them first.
constexpr int kFioInvalidValue = 1;

// `count` float64 values at `values` into `count` int64 magnitudes at `mags`
// and signs at `signs`, in the format of `len` digits of `bits` bits, `ints`
// of them before the point (bits * len <= 62).  Returns the launch's
// cudaError_t.
extern "C" int FIO_ENTRY(float_quantize)(const void* values, void* mags, void* signs,
                                         int64_t count, int len, int ints,
                                         int bits FIO_STREAM_PARAM) {
  if (bits < 1 || ints < 0 || ints > len || bits * len > 62 || count < 0) {
    return kFioInvalidValue;
  }
  if (count == 0) return 0;
  const int fp_bits = bits * (len - ints);
  const floatio::Format fmt{fp_bits, ldexp(1.0, fp_bits),
                            int64_t((uint64_t(1) << (bits * ints)) - 1)};
  const bool vec = floatio::aligned16(values) && floatio::aligned16(mags) &&
                   floatio::aligned16(signs);
  return floatio::quantize(static_cast<const double*>(values), static_cast<int64_t*>(mags),
                           static_cast<int64_t*>(signs), count, fmt, vec, FIO_STREAM);
}

// `count` int64 magnitudes at `mags` and signs at `signs` into `count`
// float64 values at `out`: mag * scale * sign.  Returns the launch's
// cudaError_t.
extern "C" int FIO_ENTRY(float_dequantize)(const void* mags, const void* signs, void* out,
                                           int64_t count, double scale FIO_STREAM_PARAM) {
  if (count < 0) return kFioInvalidValue;
  if (count == 0) return 0;
  const bool vec = floatio::aligned16(mags) && floatio::aligned16(signs) &&
                   floatio::aligned16(out);
  return floatio::dequantize(static_cast<const int64_t*>(mags),
                             static_cast<const int64_t*>(signs), static_cast<double*>(out), count,
                             scale, vec, FIO_STREAM);
}
