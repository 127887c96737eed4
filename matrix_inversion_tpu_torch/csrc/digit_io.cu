// digit_io.cu -- the pack and unpack of digit I/O: digit rows to int64
// magnitudes, and magnitudes (and signs) back to int32 digit rows.
//
// Replaces the jnp expressions of matrix_inversion_tpu/models/inverse.py:61-105
// (no Pallas kernel there): the pack `sum(digits * place, -1)` and the unpack
// `((mags[..., None] >> shifts) & (base - 1)).astype(int32)` with the signs
// concatenated, each of which XLA fuses into one pass.  Run as eager PyTorch
// they move each byte several times (a shifted int64 copy of the digits, then
// its sum; a shifted int64 copy of the output, then its mask and the sign).
//
// digits_pack_kernel: (cells, len) int64 digits -> (cells,) int64
// magnitudes sum_j d_j << bits * (len - 1 - j), taken as the Horner chain
// acc = (acc << bits) + d_j in unsigned 64-bit arithmetic: the same value
// mod 2**64 for any digits (a place of 64 bits or more contributes 0, as it
// does in torch's shift), so the bits of ops/packed.py's plain version.
// digits_unpack_kernel: (cells,) int64 magnitudes -> rows of len int32
// digits (mag >> bits * (len - 1 - j)) & (2**bits - 1), the shift
// arithmetic and capped at 63 as torch's is; with signs, one column more
// holding the sign.  The output rows lie row_stride words apart (a view's
// rows).
//
// Bound: bytes.  At the High preset, n = 4 and 262,144 matrices the pack
// reads 1.342 GB and writes 33.5 MB, the unpack reads 67 MB and writes
// 0.688 GB; the arithmetic is a shift and an add or a mask a digit.  Both
// kernels stage a tile of kThreads cells through shared memory, so that
// device memory is read and written as one contiguous run a tile, in 16-byte
// accesses where the run is 16-byte aligned, with neighbouring threads on
// neighbouring addresses; one thread then works on one cell's row.  The rows
// in shared memory have an odd stride (len | 1 words), so that a warp's
// threads, one a row, fall in distinct banks; a row of an odd width needs no
// padding, and the unpack reads that buffer back 16 bytes at a time (41
// words at the High preset).  The pack keeps four 16-byte loads in flight a
// thread.  A tile past 48 KB takes the card's larger dynamic shared memory;
// one past that (rows of hundreds of digits, which no packed format has) is
// read or written by one thread a cell in place.
//
// Built with nvcc for sm_90a into a library with a plain C interface
// (ops/digit_io.py).  Without __CUDACC__ the file compiles as host C++ with
// loops over the blocks and their threads in place of the launch, phase by
// phase, which is how the CPU tests run the same code.

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define DIO_FN __device__ __forceinline__
#define DIO_HOST_FN __host__ __device__ __forceinline__
#else
#include <algorithm>
#include <vector>
#define DIO_FN inline
#define DIO_HOST_FN inline
#endif

namespace digitio {

constexpr int kThreads = 128;  // cells a tile, threads a block
constexpr int kUnroll = 4;     // 16-byte loads in flight a thread
constexpr int kDefaultShared = 48 * 1024;
constexpr int kMaxShared = 232448;  // what a block can have on sm_90

// 16 bytes, as one access.
struct alignas(16) Vec16 {
  uint64_t lo, hi;
};

// The place (row, column) of word `w` of a tile's run of rows of `len` words.
struct Place {
  int row, col;
  DIO_FN void start(int w, int len) {
    row = w / len;
    col = w - row * len;
  }
  // `step_r` rows and `step_c` < len columns on.
  DIO_FN void advance(int step_r, int step_c, int len) {
    row += step_r;
    col += step_c;
    if (col >= len) {
      col -= len;
      row += 1;
    }
  }
};

DIO_HOST_FN int shared_stride(int len) { return len | 1; }

DIO_FN uint64_t pack_row(const uint64_t* row, int len, int bits) {
  uint64_t acc = 0;
  for (int j = 0; j < len; ++j) acc = (acc << bits) + row[j];
  return acc;
}

// The digit `shift` bits up magnitude m: torch's arithmetic shift (a
// shift of 63 or more gives the sign's bits) and the mask, cast to int32.
DIO_FN int32_t digit_of(int64_t m, int shift, uint64_t mask) {
  return int32_t(uint64_t(m >> shift) & mask);
}

DIO_FN void unpack_row(int64_t m, const int64_t* sign, uint32_t* row, int len, int bits,
                       uint64_t mask) {
  int shift = 0;
  for (int j = len - 1; j >= 0; --j) {
    row[j] = uint32_t(digit_of(m, shift, mask));
    shift = shift + bits < 63 ? shift + bits : 63;
  }
  if (sign != nullptr) row[len] = uint32_t(int32_t(*sign));
}

// Thread t's share of the copy of a tile's `words` contiguous words at `src`
// (16-byte aligned where `vec`) into rows of `len` at stride `stride` in
// `buf`: 16-byte loads, kUnroll in flight, and a scalar tail.
DIO_FN void load_tile(const uint64_t* src, uint64_t* buf, int words, int len, int stride, int t,
                      bool vec) {
  if (!vec) {
    Place p;
    p.start(t, len);
    const int step_r = kThreads / len, step_c = kThreads - step_r * len;
    for (int w = t; w < words; w += kThreads) {
      buf[p.row * stride + p.col] = src[w];
      p.advance(step_r, step_c, len);
    }
    return;
  }
  const int chunks = words / 2;
  const Vec16* from = reinterpret_cast<const Vec16*>(src);
  Place p;
  p.start(2 * t, len);
  const int step_r = 2 * kThreads / len, step_c = 2 * kThreads - step_r * len;
  for (int k0 = t; k0 < chunks; k0 += kUnroll * kThreads) {
    Vec16 v[kUnroll];
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * kThreads;
      if (k < chunks) {
#ifdef __CUDACC__
        const ulonglong2 x = __ldcs(reinterpret_cast<const ulonglong2*>(from + k));
        v[u].lo = x.x;
        v[u].hi = x.y;
#else
        memcpy(&v[u], from + k, sizeof(Vec16));
#endif
      }
    }
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int u = 0; u < kUnroll; ++u) {
      if (k0 + u * kThreads < chunks) {
        buf[p.row * stride + p.col] = v[u].lo;
        Place q = p;
        q.advance(0, 1, len);
        buf[q.row * stride + q.col] = v[u].hi;
        p.advance(step_r, step_c, len);
      }
    }
  }
  if (t == 0 && words % 2) {
    Place q;
    q.start(words - 1, len);
    buf[q.row * stride + q.col] = src[words - 1];
  }
}

// Thread t's share of the copy of `rows` rows of `width` words at stride
// `stride` in `buf` out to rows `row_stride` words apart at `dst`: where
// `vec` (row_stride == width, `dst` 16-byte aligned) one contiguous run in
// 16-byte stores and a scalar tail, else word by word.
DIO_FN void store_tile(uint32_t* dst, const uint32_t* buf, int rows, int width, int stride,
                       int64_t row_stride, int t, bool vec) {
  const int words = rows * width;
  if (!vec) {
    Place p;
    p.start(t, width);
    const int step_r = kThreads / width, step_c = kThreads - step_r * width;
    for (int w = t; w < words; w += kThreads) {
      dst[p.row * row_stride + p.col] = buf[p.row * stride + p.col];
      p.advance(step_r, step_c, width);
    }
    return;
  }
  const int chunks = words / 4;
  Place p;
  p.start(4 * t, width);
  const int step_r = 4 * kThreads / width, step_c = 4 * kThreads - step_r * width;
  for (int k = t; k < chunks; k += kThreads) {
    uint32_t x[4];
    if (stride == width) {  // an odd width: the buffer is the run itself
#ifdef __CUDACC__
      const uint4 v = reinterpret_cast<const uint4*>(buf)[k];
      x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
#else
      memcpy(x, buf + 4 * k, sizeof x);
#endif
    } else {
      Place q = p;
      for (int u = 0; u < 4; ++u) {
        x[u] = buf[q.row * stride + q.col];
        q.advance(0, 1, width);
      }
      p.advance(step_r, step_c, width);
    }
#ifdef __CUDACC__
    __stcs(reinterpret_cast<uint4*>(dst) + k, make_uint4(x[0], x[1], x[2], x[3]));
#else
    memcpy(dst + 4 * k, x, sizeof x);
#endif
  }
  for (int w = 4 * chunks + t; w < words; w += kThreads) {
    Place q;
    q.start(w, width);
    dst[w] = buf[q.row * stride + q.col];
  }
}

// Bytes of shared memory a tile of rows of `len` words of `word` bytes takes.
inline int64_t tile_bytes(int len, int word) {
  return int64_t(kThreads) * shared_stride(len) * word;
}

inline uint64_t digit_mask(int bits) { return (uint64_t(1) << bits) - 1; }

#ifdef __CUDACC__

// One tile of kThreads cells a block: the digits staged in, one cell a
// thread packed.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
digits_pack_kernel(const uint64_t* __restrict__ digits, uint64_t* __restrict__ mags,
                   int64_t cells, int len, int bits) {
  extern __shared__ __align__(16) uint64_t buf64[];
  const int64_t first = int64_t(blockIdx.x) * kThreads;
  const int rows = int(cells - first < kThreads ? cells - first : kThreads);
  const int stride = shared_stride(len);
  load_tile(digits + first * len, buf64, rows * len, len, stride, threadIdx.x, kVec);
  __syncthreads();
  if (int(threadIdx.x) < rows) {
    mags[first + threadIdx.x] = pack_row(buf64 + threadIdx.x * stride, len, bits);
  }
}

// One tile of kThreads cells a block: one cell a thread unpacked into shared
// memory, the rows staged out.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
digits_unpack_kernel(const int64_t* __restrict__ mags, const int64_t* __restrict__ signs,
                     uint32_t* __restrict__ out, int64_t cells, int len, int64_t row_stride,
                     int bits, uint64_t mask) {
  extern __shared__ __align__(16) uint32_t buf32[];
  const int64_t first = int64_t(blockIdx.x) * kThreads;
  const int rows = int(cells - first < kThreads ? cells - first : kThreads);
  const int width = len + (signs != nullptr);
  const int stride = shared_stride(width);
  if (int(threadIdx.x) < rows) {
    const int64_t i = first + threadIdx.x;
    const int64_t m = __ldcs(reinterpret_cast<const long long*>(mags) + i);
    unpack_row(m, signs != nullptr ? signs + i : nullptr, buf32 + threadIdx.x * stride, len, bits,
               mask);
  }
  __syncthreads();
  store_tile(out + first * row_stride, buf32, rows, width, stride, row_stride, threadIdx.x, kVec);
}

// Rows too wide to stage: one thread a cell, in place.
__global__ void __launch_bounds__(kThreads)
digits_pack_wide_kernel(const uint64_t* __restrict__ digits, uint64_t* __restrict__ mags,
                        int64_t cells, int len, int bits) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i < cells) mags[i] = pack_row(digits + i * len, len, bits);
}

__global__ void __launch_bounds__(kThreads)
digits_unpack_wide_kernel(const int64_t* __restrict__ mags, const int64_t* __restrict__ signs,
                          uint32_t* __restrict__ out, int64_t cells, int len, int64_t row_stride,
                          int bits, uint64_t mask) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i < cells) {
    unpack_row(mags[i], signs != nullptr ? signs + i : nullptr, out + i * row_stride, len, bits,
               mask);
  }
}

// A launch of `kernel` with `bytes` of dynamic shared memory, past 48 KB
// after raising the kernel's limit; returns the launch's cudaError_t.
template <class Kernel, class... Args>
int launch(Kernel kernel, int64_t cells, int bytes, void* stream, Args... args) {
  if (bytes > kDefaultShared) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return int(err);
  }
  const int64_t blocks = (cells + kThreads - 1) / kThreads;
  kernel<<<unsigned(blocks), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(args...);
  return int(cudaGetLastError());
}

int pack(const uint64_t* digits, uint64_t* mags, int64_t cells, int len, int bits, bool vec,
         void* stream) {
  if (tile_bytes(len, 8) > kMaxShared) {
    return launch(digits_pack_wide_kernel, cells, 0, stream, digits, mags, cells, len, bits);
  }
  const auto kernel = vec ? digits_pack_kernel<true> : digits_pack_kernel<false>;
  return launch(kernel, cells, int(tile_bytes(len, 8)), stream, digits, mags, cells, len, bits);
}

int unpack(const int64_t* mags, const int64_t* signs, uint32_t* out, int64_t cells, int len,
           int64_t row_stride, int bits, bool vec, void* stream) {
  const uint64_t mask = digit_mask(bits);
  const int64_t bytes = tile_bytes(len + (signs != nullptr), 4);
  if (bytes > kMaxShared) {
    return launch(digits_unpack_wide_kernel, cells, 0, stream, mags, signs, out, cells, len,
                  row_stride, bits, mask);
  }
  const auto kernel = vec ? digits_unpack_kernel<true> : digits_unpack_kernel<false>;
  return launch(kernel, cells, int(bytes), stream, mags, signs, out, cells, len, row_stride, bits,
                mask);
}

#else

// The host form of the kernels: their phases, block by block, thread by
// thread, the same tiles and the same fallback past kMaxShared.
int pack(const uint64_t* digits, uint64_t* mags, int64_t cells, int len, int bits, bool vec,
         void*) {
  if (tile_bytes(len, 8) > kMaxShared) {
    for (int64_t i = 0; i < cells; ++i) mags[i] = pack_row(digits + i * len, len, bits);
    return 0;
  }
  const int stride = shared_stride(len);
  std::vector<uint64_t> buf(size_t(kThreads) * stride);
  for (int64_t first = 0; first < cells; first += kThreads) {
    const int rows = int(std::min<int64_t>(cells - first, kThreads));
    for (int t = 0; t < kThreads; ++t) {
      load_tile(digits + first * len, buf.data(), rows * len, len, stride, t, vec);
    }
    for (int t = 0; t < rows; ++t) mags[first + t] = pack_row(buf.data() + t * stride, len, bits);
  }
  return 0;
}

int unpack(const int64_t* mags, const int64_t* signs, uint32_t* out, int64_t cells, int len,
           int64_t row_stride, int bits, bool vec, void*) {
  const uint64_t mask = digit_mask(bits);
  const int width = len + (signs != nullptr);
  if (tile_bytes(width, 4) > kMaxShared) {
    for (int64_t i = 0; i < cells; ++i) {
      unpack_row(mags[i], signs != nullptr ? signs + i : nullptr, out + i * row_stride, len, bits,
                 mask);
    }
    return 0;
  }
  const int stride = shared_stride(width);
  std::vector<uint32_t> buf(size_t(kThreads) * stride);
  for (int64_t first = 0; first < cells; first += kThreads) {
    const int rows = int(std::min<int64_t>(cells - first, kThreads));
    for (int t = 0; t < rows; ++t) {
      unpack_row(mags[first + t], signs != nullptr ? signs + first + t : nullptr,
                 buf.data() + t * stride, len, bits, mask);
    }
    for (int t = 0; t < kThreads; ++t) {
      store_tile(out + first * row_stride, buf.data(), rows, width, stride, row_stride, t, vec);
    }
  }
  return 0;
}

#endif  // __CUDACC__

}  // namespace digitio

// The C entry points: name_launch(..., stream) on the card, name_host(...) in
// the host build.
#ifdef __CUDACC__
#define DIO_ENTRY(name) name##_launch
#define DIO_STREAM_PARAM , void* stream
#define DIO_STREAM stream
#else
#define DIO_ENTRY(name) name##_host
#define DIO_STREAM_PARAM
#define DIO_STREAM nullptr
#endif

// What an entry point returns for arguments it does not take
// (cudaErrorInvalidValue); the wrappers check them first.
constexpr int kDioInvalidValue = 1;

// `cells` rows of `len` int64 digits, contiguous at `digits`, into `cells`
// int64 magnitudes at `mags`.  Returns the launch's cudaError_t.
extern "C" int DIO_ENTRY(digits_pack)(const void* digits, void* mags, int64_t cells, int len,
                                      int bits DIO_STREAM_PARAM) {
  if (len < 1 || bits < 1 || bits > 63 || cells < 0) return kDioInvalidValue;
  if (cells == 0) return 0;
  const bool vec = reinterpret_cast<uintptr_t>(digits) % 16 == 0;
  return digitio::pack(static_cast<const uint64_t*>(digits), static_cast<uint64_t*>(mags), cells,
                       len, bits, vec, DIO_STREAM);
}

// `cells` int64 magnitudes at `mags` into rows of `len` int32 digits,
// `row_stride` words apart from `out`; with `signs` not null, the cells'
// int64 signs into column `len` of each row as int32.  Returns the launch's
// cudaError_t.
extern "C" int DIO_ENTRY(digits_unpack)(const void* mags, const void* signs, void* out,
                                        int64_t cells, int len, int64_t row_stride,
                                        int bits DIO_STREAM_PARAM) {
  const int width = len + (signs != nullptr);
  if (len < 1 || bits < 1 || bits > 63 || cells < 0 || row_stride < width) {
    return kDioInvalidValue;
  }
  if (cells == 0) return 0;
  const bool vec = row_stride == width && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return digitio::unpack(static_cast<const int64_t*>(mags), static_cast<const int64_t*>(signs),
                         static_cast<uint32_t*>(out), cells, len, row_stride, bits, vec,
                         DIO_STREAM);
}
