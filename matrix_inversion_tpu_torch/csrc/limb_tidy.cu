// limb_tidy.cu -- K7: the carry chain of a digit array, and its sign and
// magnitude.
//
// Replaces the two normalisations of the JAX package's limb backend,
// matrix_inversion_tpu/ops/limbs.py:231-263: base_tidy (a lax.scan carry
// chain, :243) and tidy_to_sign_mag (its two base_p_subtraction borrow
// chains, :254-263).  JAX runs them as scans inside one XLA program, with
// no Pallas kernel; run eagerly they are ~10 launches a digit.  Here one
// thread walks one number's digits from the least significant up.
//
// Mode tidy (sign == nullptr): the signed carry chain.  cur = digit + carry,
// carry = cur / p rounded toward zero (JAX's sign(cur) * (|cur| // p)),
// digit = cur - carry * p, in ]-p, p[; the carry out of the top digit is
// dropped.  Any int32 digits in, as long as no sum overflows.
//
// Mode tidy + sign (sign != nullptr): the same, then what tidy_to_sign_mag
// does with the tidy digits t.  JAX splits them into pos = max(t, 0) and
// neg = max(-t, 0) and runs two borrow chains, pos - neg and neg - pos; the
// first one's borrow out says whether the value is negative, and selects
// the magnitude.  pos - neg is t and neg - pos is -t digit by digit, so the
// first chain runs beside the carry chain in the same pass, and a second
// pass runs the chain the first one selected: on t (value >= 0, sign +1)
// or on -t (sign -1), over the first pass's digits where they lie.
//
// Bound: bytes.  A number moves 4 * L bytes in and out (and 4 of sign), and
// its digit step is a handful of instructions.  One thread a number would
// read and write with a stride of L digits, 32 cache lines a warp access;
// so a block stages its 128 numbers' run of digits through shared memory
// instead, read and written with neighbouring threads on neighbouring
// words, each row padded to an odd stride so that a warp's rows fall in 32
// banks (128 * (L | 1) * 4 bytes of dynamic shared memory, 21 KB at L =
// 40).  Rows of more than kMaxStagedLen digits (over 48 KB a block) are
// copied and walked in place in device memory, one thread a number in the
// frame of limb_frame.cuh.  The base is a run-time argument.
//
// Built with nvcc for sm_90a into a library with a plain C interface
// (ops/limb_kernels.py).  Without __CUDACC__ the file compiles as host C++
// with loops over the blocks and their threads in place of the launch,
// phase by phase, which is how the CPU tests run the same code.

#include "limb_frame.cuh"

namespace limbtidy {

constexpr int kThreads = 128;
// The widest row staged: 128 rows of an odd stride <= 95 words fit 48 KB.
constexpr int kMaxStagedLen = 95;

// The tidy (and with sign, the magnitude and sign) of one number's digits,
// in place.
LIMB_FN void tidy_one(int32_t* digits, int32_t* sign, int len, int32_t base) {
  int32_t carry = 0, negative = 0;
  for (int j = len - 1; j >= 0; --j) {
    const int32_t cur = digits[j] + carry;
    carry = cur / base;  // toward zero
    const int32_t t = cur - carry * base;
    digits[j] = t;
    negative = t - negative < 0;  // the borrow of pos - neg
  }
  if (sign == nullptr) return;
  const int32_t s = negative ? -1 : 1;
  int32_t borrow = 0;
  for (int j = len - 1; j >= 0; --j) {
    const int32_t a = s * digits[j] - borrow;
    borrow = a < 0;
    digits[j] = a + (borrow ? base : 0);
  }
  *sign = 1 - 2 * negative;
}

#ifdef __CUDACC__

// A block's 128 numbers: staged in, tidied one a thread, staged out.
__global__ void __launch_bounds__(kThreads)
staged_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, int32_t* sign,
              int64_t n, int len, int base) {
  extern __shared__ int32_t buf[];  // kThreads rows of stride len | 1
  const int stride = len | 1;
  const int64_t first = int64_t(blockIdx.x) * kThreads;
  const int rows = int(n - first < kThreads ? n - first : kThreads);
  limbframe::stage(const_cast<int32_t*>(in) + first * len, buf, rows, len, stride, threadIdx.x,
                   kThreads, true);
  __syncthreads();
  if (int(threadIdx.x) < rows) {
    tidy_one(buf + threadIdx.x * stride, sign ? sign + first + threadIdx.x : nullptr, len, base);
  }
  __syncthreads();
  limbframe::stage(out + first * len, buf, rows, len, stride, threadIdx.x, kThreads, false);
}

int launch_staged(const int32_t* in, int32_t* out, int32_t* sign, int64_t n, int len, int base,
                  void* stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const size_t bytes = size_t(kThreads) * (len | 1) * sizeof(int32_t);
  staged_kernel<<<unsigned(blocks), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      in, out, sign, n, len, base);
  return int(cudaGetLastError());
}

#else

// The host form of the staged kernel: its phases, block by block, thread by
// thread.
int launch_staged(const int32_t* in, int32_t* out, int32_t* sign, int64_t n, int len, int base,
                  void*) {
  static thread_local int32_t buf[kThreads * kMaxStagedLen];
  const int stride = len | 1;
  for (int64_t first = 0; first < n; first += kThreads) {
    const int rows = int(n - first < kThreads ? n - first : kThreads);
    for (int t = 0; t < kThreads; ++t) {
      limbframe::stage(const_cast<int32_t*>(in) + first * len, buf, rows, len, stride, t, kThreads,
                       true);
    }
    for (int t = 0; t < rows; ++t) {
      tidy_one(buf + t * stride, sign ? sign + first + t : nullptr, len, base);
    }
    for (int t = 0; t < kThreads; ++t) {
      limbframe::stage(out + first * len, buf, rows, len, stride, t, kThreads, false);
    }
  }
  return 0;
}

#endif  // __CUDACC__

// Rows too wide to stage: one thread a number, copied and walked in place in
// `out`.
struct Direct {
  const int32_t* in;
  int32_t* out;
  int32_t* sign;
  int len, base;
  LIMB_FN void operator()(int64_t i) const {
    for (int j = 0; j < len; ++j) out[i * len + j] = in[i * len + j];
    tidy_one(out + i * len, sign ? sign + i : nullptr, len, base);
  }
};

}  // namespace limbtidy

// n numbers of len int32 digits, contiguous, tidied into out; with sign not
// null, the magnitudes into out and the int32 signs (+1 for a value >= 0,
// else -1) into sign.  Returns the launch's cudaError_t
// (kLimbInvalidValue for arguments outside the kernel's range).
extern "C" int LIMB_ENTRY(limb_tidy)(const void* in, void* out, void* sign, int64_t n, int len,
                                     int base LIMB_STREAM_PARAM) {
  if (len < 1 || base < 2) return kLimbInvalidValue;
  if (n <= 0) return 0;
  const int32_t* from = static_cast<const int32_t*>(in);
  int32_t* to = static_cast<int32_t*>(out);
  int32_t* signs = static_cast<int32_t*>(sign);
  if (len <= limbtidy::kMaxStagedLen) {
    return limbtidy::launch_staged(from, to, signs, n, len, base, LIMB_STREAM);
  }
  return limbframe::run(n, limbtidy::Direct{from, to, signs, len, base}, LIMB_STREAM);
}
