// long_division.cu -- exact batched long division on 64-bit magnitudes.
//
// Replaces the two division kernels of the JAX package's op-by-op path,
// matrix_inversion_tpu/ops/pallas_kernels.py:
//   K2 _division_float_kernel (pair_math.div_float): radix-2**k long
//      division with a downward-biased f32 reciprocal estimate and one
//      add-back fixup per step;
//   K3 _division_kernel (pair_math.div_classic): restoring long division,
//      one base-2**bits digit per step, (base - 1) compare-subtracts each.
// Both compute q = v // d exactly for v < 2**n_bits, d < 2**62, and
// saturate a zero divisor to 2**n_bits - 1: K3 by itself (the remainder
// never drops), K2 explicitly.  Neither masks its quotient: the caller
// reads the digits above its window for the overflow flag.
//
// One thread per element.  The TPU kernels worked on uint32 (hi, lo)
// pairs because Mosaic has no 64-bit integers; here a magnitude is one
// uint64_t (int64 in torch, reinterpreted: magnitudes stay below 2**62).
// The parameters (n_bits and k, or n_digits and bits) are runtime
// arguments, so one library serves every QFloat format.
//
// Bound: integer instruction throughput, not bytes.  An element moves 24
// bytes and costs K2 about 4 steps of ~30 instructions at High (n_bits 60,
// k 15), K3 about 60 digit steps of ~10 64-bit operations at base 2.
// Nothing is staged in shared memory: there is no reuse.  K2 exists to
// cut K3's step count by about 15x; it is also the estimate-and-fixup form
// that could replace the native 64-bit `/` of the fused kernel
// (fused_inverse.cu).
//
// K2's exactness rests on a rounding argument (pair_math.py:165-169,
// 214-221): the reciprocal (1 - 2**-17) / d is biased down by 2**-17,
// which outweighs the four f32 roundings here (r to f32, d to f32, the
// divide, the multiply; each <= 2**-24 relative), so the floored estimate
// is never above the true quotient digit and, the digit being < 2**15, at
// most one below it.  The float operations are the IEEE round-to-nearest
// intrinsics, so no approximate division or contraction sneaks in; the
// host build needs -ffp-contract=off for the same reason.  Exactness
// holds for d < 2**divisor_bits with k = _float_div_chunk_bits(n_bits,
// divisor_bits) (ops/packed.py).
//
// Built with nvcc for sm_90a into a library with a plain C interface
// (ops/long_division.py).  Without __CUDACC__ the file compiles as host
// C++ with a loop in place of the launch, which is how the CPU tests run
// it.

#include <math.h>

#include "qfloat_cell.cuh"

namespace longdiv {

using qcell::low_mask;

// Device-only on the card (the f32 intrinsics exist only there), plain
// inline functions in the host build.
#ifdef __CUDACC__
#define LD_FN __device__ __forceinline__
LD_FN float u64_to_f32(uint64_t x) { return __ull2float_rn(x); }
LD_FN float f32_div(float a, float b) { return __fdiv_rn(a, b); }
LD_FN float f32_mul(float a, float b) { return __fmul_rn(a, b); }
#else
#define LD_FN inline
LD_FN float u64_to_f32(uint64_t x) { return float(x); }
LD_FN float f32_div(float a, float b) { return a / b; }
LD_FN float f32_mul(float a, float b) { return a * b; }
#endif

// 1 - 2**-17, exact in f32.
constexpr float kBias = 0.99999237060546875f;

// K2: q = v // d in steps of k quotient bits (the first step takes the
// n_bits - k * (n_chunks - 1) leftover bits), pair_math.py:143-237.
LD_FN uint64_t div_float(uint64_t v, uint64_t d, int n_bits, int k) {
  const bool zero = d == 0;
  const uint64_t ds = zero ? 1 : d;  // divide by 1, saturate at the end
  const float rdf = f32_div(kBias, u64_to_f32(ds));
  const int n_chunks = (n_bits + k - 1) / k;
  const int first = n_bits - k * (n_chunks - 1);
  uint64_t r = 0, q = 0;
  int consumed = 0;
  for (int c = 0; c < n_chunks; ++c) {
    const int kc = c == 0 ? first : k;
    consumed += kc;
    // r < ds * 2**kc <= 2**61: the incoming remainder is below ds
    r = (r << kc) | ((v >> (n_bits - consumed)) & low_mask(kc));
    int64_t qc = int64_t(floorf(f32_mul(u64_to_f32(r), rdf)));
    const int64_t qmax = int64_t(low_mask(kc));
    qc = qc < 0 ? 0 : (qc > qmax ? qmax : qc);
    // the estimate is never too high, at most one too low
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

// K3: q = v // d, one base-2**bits digit per step, pair_math.py:240-273
// (reference base_p_arrays.py:173-203).  r < d * 2**bits stays in 64 bits.
LD_FN uint64_t div_classic(uint64_t v, uint64_t d, int n_digits, int bits) {
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

}  // namespace longdiv

#ifdef __CUDACC__

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
long_division_float_kernel(const uint64_t* __restrict__ v, const uint64_t* __restrict__ d,
                           uint64_t* __restrict__ q, int64_t n, int n_bits, int k) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) q[i] = longdiv::div_float(v[i], d[i], n_bits, k);
}

__global__ void __launch_bounds__(kThreads)
long_division_classic_kernel(const uint64_t* __restrict__ v, const uint64_t* __restrict__ d,
                             uint64_t* __restrict__ q, int64_t n, int n_digits, int bits) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) q[i] = longdiv::div_classic(v[i], d[i], n_digits, bits);
}

// n int64 dividends and divisors in, n quotients out, on `stream`.
// Returns the launch's cudaError_t.
extern "C" int long_division_float_launch(const void* v, const void* d, void* q, int64_t n,
                                          int n_bits, int k, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  long_division_float_kernel<<<unsigned(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(v), static_cast<const uint64_t*>(d),
      static_cast<uint64_t*>(q), n, n_bits, k);
  return int(cudaGetLastError());
}

extern "C" int long_division_classic_launch(const void* v, const void* d, void* q, int64_t n,
                                            int n_digits, int bits, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  long_division_classic_kernel<<<unsigned(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(v), static_cast<const uint64_t*>(d),
      static_cast<uint64_t*>(q), n, n_digits, bits);
  return int(cudaGetLastError());
}

#else

// Host forms of the launches: the same per-element functions over n.
extern "C" int long_division_float_host(const void* v, const void* d, void* q, int64_t n,
                                        int n_bits, int k) {
  for (int64_t i = 0; i < n; ++i) {
    static_cast<uint64_t*>(q)[i] = longdiv::div_float(
        static_cast<const uint64_t*>(v)[i], static_cast<const uint64_t*>(d)[i], n_bits, k);
  }
  return 0;
}

extern "C" int long_division_classic_host(const void* v, const void* d, void* q, int64_t n,
                                          int n_digits, int bits) {
  for (int64_t i = 0; i < n; ++i) {
    static_cast<uint64_t*>(q)[i] = longdiv::div_classic(
        static_cast<const uint64_t*>(v)[i], static_cast<const uint64_t*>(d)[i], n_digits, bits);
  }
  return 0;
}

#endif  // __CUDACC__
