// fused_inverse_lanes.cu -- K1 past n = 5: one matrix across a group of lanes.
//
// Replaces matrix_inversion_tpu/ops/fused_inverse.py::_fused_kernel (the
// Pallas TPU kernel) for the sizes where one thread a matrix cannot hold
// the work: the straight-line body of fused_inverse.cu grows as n^3 (5,974
// primitives at n = 12), keeps several n x n matrices of cells live and
// spills tens of KB a thread.  Here a group of n lanes inverts one matrix:
// lane i owns row i.  A warp holds floor(32 / n) groups (3 at n = 10, 2 at
// n = 11-16), none straddling two warps, so that a group's barrier is the
// warp's; its last 32 - floor(32 / n) n lanes belong to no group.  Every
// step is warp-synchronous and its instruction stream the same whatever
// the lanes a group, so a warp's throughput is its matrices.  The matrix,
// then L and U, lie in a tile of shared memory; each lane keeps its
// working row in registers (the LU's accumulators, then its rows of Y and
// of X), and the circuit runs as loops over compile-time bounds, so the
// code grows as n^2 and its live set as n.  Past n = 32 a block is one
// group of the next power of two >= n lanes (a matrix a block, block
// barriers, loops not unrolled): right, not fast.
//
// What it computes is the circuit of models/qfloat_lu.py bit for bit,
// overflow flag included: every cell is the same primitive of
// qfloat_cell.cuh on the same formats and the same operands in the same
// order as in the straight-line body (ops/emit.py), and every dot product
// adds its terms in the same order.  Only which lane computes a cell, and
// when, differs.  Two steps of the circuit are done more cheaply, with the
// same bits:
//   - P.M.  Row i of the pivot matrix is one-hot, so the reference's chain
//     of n sign-masked sadds (signed_word of a sign-0 cell is 0) equals one
//     sadd of the selected cell with a zero: the same masked magnitude, the
//     same sign normalisation and the same flag.  The kernel gathers row
//     perm[i] of M and makes that one sadd (tests/test_torch_k1_lanes.py
//     holds the two forms equal on sign-0 cells, magnitudes above the mask
//     and ties).
//   - The pivot.  Its n - 1 argmax scans read only the input M, so lane j
//     runs column j's scan (gt, blend: the running maximum keeps the first
//     cell's sign, as the reference's); the one-hot row updates are row
//     swaps, which each lane traces back to the row that ends at its
//     position.  The reciprocals of U's diagonal, which the reference
//     computes once in the LU and once more in the substitution, are
//     computed once.
//
// Schedule.  Pivot scans (lanes j < n - 1); the gather of P.M (each lane
// its row); then the LU right-looking, one phase k = 1..n-1 a group barrier:
// lanes i >= k make L[i][k-1] from their row and U[k-1][k-1] and add the
// terms U[k-1][j] L[i][k-1] (j >= k) to their accumulators, the k-th term
// of each cell's dot product, in the reference's order; then lane k, whose
// row's dot products are complete, writes U[k][j] (j >= k) and its
// reciprocal.  The multiplies keep the reference's operand order:
// mul_window_t is not symmetric.  Then each lane runs forward and backward
// substitution on its own row, reading L, U and the reciprocals from the
// tile (broadcast reads): 3/4 of the multiplies, balanced over the lanes.
// A lane writes only its own row of the tile in a step, and reads another
// row only in a later step, so one barrier a step suffices.
//
// I/O.  A block of kThreads = 128 threads holds kMats = 4 floor(32 / n)
// matrices.  Every thread, in a group or not, copies its share of the
// block's (B, n*n) words into the tiles with coalesced 64-bit loads, and
// the outputs back the same way; a thread in no group computes nothing
// and touches no tile in between, and takes part in every barrier.
// A tile row is padded to an odd count of cells, so that the lanes'
// accesses to one column of n rows fall into different banks.  The shared
// memory is dynamic; past 48 KB the launch opts in.
//
// Bound: integer issue, as fused_inverse.cu.  The design removes the
// spills and the code growth; the work stays the circuit's.
//
// Built with nvcc for sm_90a into a library with a plain C interface
// (ops/fused_inverse.py), one per configuration: -D LANES_N, LANES_BITS,
// LANES_LEN, LANES_INTS, LANES_TRUE_DIV, LANES_TRACK.  Without __CUDACC__ the same file compiles as host
// C++: every step runs as a loop over the threads of a block, the barrier
// between two steps being the end of the loop, and the primitives are
// counted (fused_inverse_lanes_counts), which is how the CPU tests run it.

#include "qfloat_cell.cuh"

#ifndef __CUDACC__
#include <vector>
#endif

#ifndef LANES_TRACK
#define LANES_TRACK 0
#endif

namespace qlanes {

using namespace qcell;

constexpr int N = LANES_N;
constexpr int BITS = LANES_BITS;
constexpr int LEN = LANES_LEN;
constexpr int INTS = LANES_INTS;
constexpr bool kTrueDiv = LANES_TRUE_DIV != 0;
constexpr bool kTrack = LANES_TRACK != 0;
constexpr int N2 = N * N;
static_assert(N >= 3 && N <= 1024, "the lanes kernel takes n in [3, 1024]");

constexpr int next_pow2(int x) { return x <= 1 ? 1 : 2 * next_pow2((x + 1) / 2); }

// A group is n lanes, kWarpMats of them a warp; past 32 a group is a whole
// block of the next power of two of lanes.
constexpr bool kBlockGroup = N > 32;
constexpr int kThreads = kBlockGroup ? next_pow2(N) : 128;
constexpr int kWarpMats = kBlockGroup ? 1 : 32 / N;
constexpr int kMats = kBlockGroup ? 1 : kThreads / 32 * kWarpMats;
// The group of a thread in none: past the block's matrices, and no tile.
constexpr int kNoGroup = kMats;

// A matrix's tile, in 8-byte words: magnitudes n rows of S cells, signs
// (int) the same, the reciprocals of U's diagonal, then ints: the pivot
// rows of the scans, the permutation, the lanes' flags.  The tile is an odd
// count of words, so that the groups of a warp read their broadcasts from
// different banks.
constexpr int S = N | 1;
constexpr int kMagWords = N * S;
constexpr int kSgnWords = (N * S + 1) / 2;
constexpr int kInvWords = N;
constexpr int kIntWords = (3 * N + 1) / 2;
constexpr int kMatWords = (kMagWords + kSgnWords + kInvWords + kIntWords) | 1;
constexpr int kSmemBytes = kMats * kMatWords * 8;
constexpr int kWords = kMats * N2;  // input words of a block, per array
constexpr int kWordsPerThread = (kWords + kThreads - 1) / kThreads;

constexpr uint64_t kUnit = uint64_t(1) << (BITS * (LEN - INTS));

#ifdef __CUDACC__
#define QD_FN __device__ __forceinline__
typedef unsigned long long ull;
QD_FN uint64_t load_word(const int64_t* p) { return __ldcs(reinterpret_cast<const ull*>(p)); }
QD_FN void store_word(int64_t* p, uint64_t v) { __stcs(reinterpret_cast<ull*>(p), ull(v)); }
// loops over compile-time bounds unroll up to n = 32, so that a lane's row
// stays in registers
#if LANES_N <= 32
#define LANES_UNROLL _Pragma("unroll")
#else
#define LANES_UNROLL _Pragma("unroll 1")
#endif
#define LANES_COUNT(prim) ((void)0)
#else
#define QD_FN inline
QD_FN uint64_t load_word(const int64_t* p) { return uint64_t(*p); }
QD_FN void store_word(int64_t* p, uint64_t v) { *p = int64_t(v); }
#define LANES_UNROLL
// the host build counts its calls of each primitive
enum Prim { kSadd, kMul, kDivide, kInvert, kGt, kBlend, kPrims };
inline int64_t g_counts[kPrims];
#define LANES_COUNT(prim) (++g_counts[prim])
#endif

// ---- the primitives at the circuit's formats, counted and flagged -------

struct Val {
  uint64_t m;
  int s;
};

QD_FN Val add(uint64_t am, int as, uint64_t bm, int bs, int& ovf) {
  LANES_COUNT(kSadd);
  if constexpr (kTrack) {
    const CellF c = sadd_t<BITS, LEN>(am, as, bm, bs);
    ovf |= c.f;
    return Val{c.m, c.s};
  } else {
    const Cell c = sadd<BITS, LEN>(am, as, bm, bs);
    return Val{c.m, c.s};
  }
}

// (len, ints) x (len, ints) -> (len, ints): every multiply of the LU and
// the substitution's dot products
QD_FN uint64_t mul_cells(uint64_t a, uint64_t b, int& ovf) {
  LANES_COUNT(kMul);
  if constexpr (kTrack) {
    const MagF r = mul_window_t<BITS, LEN, INTS, LEN, INTS, LEN, INTS>(a, b);
    ovf |= r.f;
    return r.m;
  } else {
    return mul<BITS, LEN, INTS, LEN, INTS, LEN, INTS>(a, b);
  }
}

// a / U[j][j]: the true division, or the product with the reciprocal at
// (len, 0)
template <bool TRUE_DIV = kTrueDiv>
QD_FN uint64_t quotient(uint64_t a, uint64_t d, uint64_t recip, int& ovf) {
  if constexpr (TRUE_DIV) {
    LANES_COUNT(kDivide);
    (void)recip;
    if constexpr (kTrack) {
      const MagF r = divide_t<BITS, LEN, INTS>(a, d);
      ovf |= r.f;
      return r.m;
    } else {
      return divide<BITS, LEN, INTS>(a, d);
    }
  } else {
    LANES_COUNT(kMul);
    (void)d;
    if constexpr (kTrack) {
      const MagF r = mul_window_t<BITS, LEN, INTS, LEN, 0, LEN, INTS>(a, recip);
      ovf |= r.f;
      return r.m;
    } else {
      return mul<BITS, LEN, INTS, LEN, 0, LEN, INTS>(a, recip);
    }
  }
}

// U[j][j]'s reciprocal at (len, 0); a cropped quotient is flagged
template <bool TRACK = kTrack>
QD_FN uint64_t reciprocal(uint64_t d, int& ovf) {
  LANES_COUNT(kInvert);
  if constexpr (TRACK && LEN < 1 + (LEN - INTS) + LEN) {
    const MagF r = invert_t<BITS, LEN, INTS, LEN, 0>(d);
    ovf |= r.f;
    return r.m;
  } else {
    return invert<BITS, LEN, INTS, LEN, 0>(d);
  }
}

// ---- the tile and a thread's place ---------------------------------------

struct Tile {
  uint64_t* mag;  // cell (r, c) at r * S + c
  int* sgn;
  uint64_t* inv;  // reciprocal of U[j][j]
  int* piv;       // row chosen by column j's scan
  int* perm;      // P.M's row i is M's row perm[i]
  int* flag;      // lane i's overflow flag
};

QD_FN Tile tile_of(uint64_t* smem, int g) {
  uint64_t* base = smem + g * kMatWords;
  int* ints = reinterpret_cast<int*>(base + kMagWords + kSgnWords + kInvWords);
  return Tile{base, reinterpret_cast<int*>(base + kMagWords), base + kMagWords + kSgnWords,
              ints, ints + N, ints + 2 * N};
}

// The arrays of one call.
struct Arrays {
  const int64_t* mags;
  const int64_t* signs;
  int64_t* omags;
  int64_t* osigns;
  int32_t* oflags;  // null untracked
  int64_t batch;
};

// One thread of a block: its block's matrices, its group's tile, its lane.
struct Ctx {
  Arrays a;
  int64_t first;  // the block's first matrix
  int live;       // matrices of the block below the batch
  uint64_t* smem;
  int t;          // thread in the block
  int g;          // its group: the block's matrix g, or kNoGroup
  int lane;       // its row; N in no group, and past n in a block's group
  Tile tile;      // its group's; none in no group
};

// A lane's row in registers: the LU's accumulators, then Y's row, then X's.
struct Lane {
  uint64_t m[N];
  int s[N];
  int ovf;
};

// Word w of a block's input or output: its matrix, its cell and where it
// lies in the arrays; `ok` if the matrix is in the batch.
QD_FN void word_place(const Ctx& c, int w, int& b, int& cell, int64_t& at, bool& ok) {
  b = w / N2;
  cell = w % N2;
  at = c.first * N2 + w;
  ok = b < c.live;
}

// ---- the steps -----------------------------------------------------------

// The block's matrices into their tiles, every word once, coalesced; the
// words of matrices past the batch are zeros.
QD_FN void stage_in(const Ctx& c) {
  uint64_t rm[kWordsPerThread], rs[kWordsPerThread];
  LANES_UNROLL
  for (int k = 0; k < kWordsPerThread; ++k) {
    const int w = c.t + k * kThreads;
    int b, cell;
    int64_t at;
    bool ok;
    word_place(c, w, b, cell, at, ok);
    ok = ok && w < kWords;
    rm[k] = ok ? load_word(c.a.mags + at) : 0;
    rs[k] = ok ? load_word(c.a.signs + at) : 0;
  }
  LANES_UNROLL
  for (int k = 0; k < kWordsPerThread; ++k) {
    const int w = c.t + k * kThreads;
    if (w >= kWords) continue;
    int b, cell;
    int64_t at;
    bool ok;
    word_place(c, w, b, cell, at, ok);
    const Tile tb = tile_of(c.smem, b);
    tb.mag[(cell / N) * S + cell % N] = rm[k];
    tb.sgn[(cell / N) * S + cell % N] = int(rs[k]);
  }
}

// Lane j < n-1: the argmax of |M[i][j]| over rows i >= j, the magnitude-only
// blend of the reference (the running maximum keeps row j's sign).
QD_FN void pivot_scan(const Ctx& c) {
  const int j = c.lane;
  if (j >= N - 1) return;
  const Tile& tl = c.tile;
  uint64_t mx = tl.mag[j * S + j];
  const int sx = tl.sgn[j * S + j] * tl.sgn[j * S + j];
  int r = j;
  for (int i = j + 1; i < N; ++i) {
    const uint64_t m = tl.mag[i * S + j];
    const int s = tl.sgn[i * S + j] * tl.sgn[i * S + j];
    LANES_COUNT(kGt);
    const int is_gt = gt(m, s, mx, sx);
    LANES_COUNT(kBlend);
    mx = blend(is_gt, m, mx);
    r = is_gt ? i : r;
  }
  tl.piv[j] = r;
}

// Lane i: the row of M that the scans' swaps (row j <-> row piv[j], in
// order) bring to position i, and P.M's row i from it: one sadd with a zero.
QD_FN void gather(const Ctx& c, Lane& me) {
  const int i = c.lane;
  if (i >= N) return;
  const Tile& tl = c.tile;
  int pos = i;
  for (int j = N - 2; j >= 0; --j) {
    const int r = tl.piv[j];
    pos = pos == j ? r : pos == r ? j : pos;
  }
  tl.perm[i] = pos;
  LANES_UNROLL
  for (int col = 0; col < N; ++col) {
    const Val v = add(tl.mag[pos * S + col], tl.sgn[pos * S + col], 0, 0, me.ovf);
    me.m[col] = v.m;
    me.s[col] = v.s;
  }
}

// Lane i: P.M's row into row i of the tile, where L and U take its place;
// U's row 0 is P.M's, and lane 0 makes its diagonal's reciprocal.
QD_FN void store_pm(const Ctx& c, Lane& me) {
  const int i = c.lane;
  if (i >= N) return;
  const Tile& tl = c.tile;
  LANES_UNROLL
  for (int col = 0; col < N; ++col) {
    tl.mag[i * S + col] = me.m[col];
    tl.sgn[i * S + col] = me.s[col];
  }
  if (!kTrueDiv && i == 0) tl.inv[0] = reciprocal(me.m[0], me.ovf);
}

// Phase k of the LU (1 <= k < n), lanes i >= k: L[i][k-1], then the term
// U[k-1][j] L[i][k-1] of each cell (i, j >= k); lane k then writes U's row k.
QD_FN void lu_phase(const Ctx& c, Lane& me, int k) {
  const int i = c.lane;
  if (i >= N || i < k) return;
  const Tile& tl = c.tile;
  const int p = k - 1;
  // l_ip = (pm_ip - sum_{q<p} u_qp l_iq) / u_pp
  Val num{tl.mag[i * S + p], tl.sgn[i * S + p]};
  if (p > 0) num = add(num.m, num.s, me.m[p], -me.s[p], me.ovf);
  const uint64_t lm = quotient(num.m, tl.mag[p * S + p], tl.inv[p], me.ovf);
  const int ls = num.s * tl.sgn[p * S + p];
  tl.mag[i * S + p] = lm;
  tl.sgn[i * S + p] = ls;
  LANES_UNROLL
  for (int j = 1; j < N; ++j) {
    if (j < k) continue;
    const uint64_t tm = mul_cells(tl.mag[p * S + j], lm, me.ovf);
    const int ts = tl.sgn[p * S + j] * ls;
    if (p == 0) {
      me.m[j] = tm;
      me.s[j] = ts;
    } else {
      const Val v = add(me.m[j], me.s[j], tm, ts, me.ovf);
      me.m[j] = v.m;
      me.s[j] = v.s;
    }
  }
  if (i != k) return;
  // u_kj = pm_kj - sum_{q<k} u_qj l_kq
  LANES_UNROLL
  for (int j = 1; j < N; ++j) {
    if (j < k) continue;
    const Val u = add(tl.mag[k * S + j], tl.sgn[k * S + j], me.m[j], -me.s[j], me.ovf);
    tl.mag[k * S + j] = u.m;
    tl.sgn[k * S + j] = u.s;
  }
  if (!kTrueDiv) tl.inv[k] = reciprocal(tl.mag[k * S + k], me.ovf);
}

// Lane i: row i of Y (L Y = P^T) and then of X (U X = Y), in the lane's
// registers, X over Y.
QD_FN void substitute(const Ctx& c, Lane& me) {
  const int i = c.lane;
  if (i >= N) return;
  const Tile& tl = c.tile;
  // Y[i][0] is the SignedBinary P^T[i][0]: its products are sign multiplies
  const int y0 = tl.perm[0] == i ? 1 : 0;
  LANES_UNROLL
  for (int j = 1; j < N; ++j) {
    uint64_t dm = tl.mag[j * S];
    int ds = tl.sgn[j * S] * y0;
    LANES_UNROLL
    for (int k = 1; k < N; ++k) {
      if (k >= j) continue;
      const uint64_t tm = mul_cells(tl.mag[j * S + k], me.m[k], me.ovf);
      const Val v = add(dm, ds, tm, tl.sgn[j * S + k] * me.s[k], me.ovf);
      dm = v.m;
      ds = v.s;
    }
    // y_ij = P^T[i][j] - dot
    const Val y = add(dm, -ds, kUnit, tl.perm[j] == i ? 1 : 0, me.ovf);
    me.m[j] = y.m;
    me.s[j] = y.s;
  }
  {
    constexpr int j = N - 1;
    const int us = tl.sgn[j * S + j];
    me.m[j] = quotient(me.m[j], tl.mag[j * S + j], tl.inv[j], me.ovf);
    me.s[j] = me.s[j] * us;
  }
  LANES_UNROLL
  for (int j = N - 2; j >= 0; --j) {
    uint64_t dm = mul_cells(tl.mag[j * S + j + 1], me.m[j + 1], me.ovf);
    int ds = tl.sgn[j * S + j + 1] * me.s[j + 1];
    LANES_UNROLL
    for (int k = 2; k < N; ++k) {
      if (k < j + 2) continue;
      const uint64_t tm = mul_cells(tl.mag[j * S + k], me.m[k], me.ovf);
      const Val v = add(dm, ds, tm, tl.sgn[j * S + k] * me.s[k], me.ovf);
      dm = v.m;
      ds = v.s;
    }
    // x_ij = (y_ij - dot) / u_jj; y_i0 is the SignedBinary
    const Val t = j == 0 ? add(dm, -ds, kUnit, y0, me.ovf)
                         : add(dm, -ds, me.m[j], me.s[j], me.ovf);
    me.m[j] = quotient(t.m, tl.mag[j * S + j], tl.inv[j], me.ovf);
    me.s[j] = t.s * tl.sgn[j * S + j];
  }
}

// Lane i: X's row i as column i of the inverse, into the tile; its flag.
QD_FN void put_out(const Ctx& c, const Lane& me) {
  const int i = c.lane;
  if (i >= N) return;
  const Tile& tl = c.tile;
  LANES_UNROLL
  for (int r = 0; r < N; ++r) {
    tl.mag[r * S + i] = me.m[r];
    tl.sgn[r * S + i] = me.s[r];
  }
  tl.flag[i] = me.ovf;
}

// The block's outputs from the tiles, coalesced; tracked, lane 0 of each
// group ORs its lanes' flags.
QD_FN void drain(const Ctx& c) {
  LANES_UNROLL
  for (int k = 0; k < kWordsPerThread; ++k) {
    const int w = c.t + k * kThreads;
    int b, cell;
    int64_t at;
    bool ok;
    word_place(c, w, b, cell, at, ok);
    if (w >= kWords || !ok) continue;
    const Tile tb = tile_of(c.smem, b);
    store_word(c.a.omags + at, tb.mag[(cell / N) * S + cell % N]);
    store_word(c.a.osigns + at, uint64_t(int64_t(tb.sgn[(cell / N) * S + cell % N])));
  }
  if (kTrack && c.lane == 0 && c.g < c.live) {
    int f = 0;
    for (int i = 0; i < N; ++i) f |= c.tile.flag[i];
    c.a.oflags[c.first + c.g] = f;
  }
}

// The steps in order.  `r.group(f)` runs f on every thread of the block,
// then a barrier of the group; `r.block(f)` then a barrier of the block.
template <class R>
QD_FN void program(R& r) {
  r.block([](const Ctx& c, Lane&) { stage_in(c); });
  r.group([](const Ctx& c, Lane&) { pivot_scan(c); });
  r.group([](const Ctx& c, Lane& me) { gather(c, me); });
  r.group([](const Ctx& c, Lane& me) { store_pm(c, me); });
  LANES_UNROLL
  for (int k = 1; k < N; ++k) r.group([k](const Ctx& c, Lane& me) { lu_phase(c, me, k); });
  r.group([](const Ctx& c, Lane& me) { substitute(c, me); });
  r.block([](const Ctx& c, Lane& me) { put_out(c, me); });
  r.last([](const Ctx& c, Lane&) { drain(c); });
}

// Thread t's group and lane: in a warp, groups of n lanes from its first
// lane on; the lanes after the last whole group are in none.
QD_FN Ctx context(const Arrays& a, int64_t first, uint64_t* smem, int t) {
  const int64_t left = a.batch - first;
  const int w = t % 32;
  const bool grouped = kBlockGroup || w < kWarpMats * N;
  Ctx c{a, first, int(left < kMats ? left : kMats), smem, t,
        kBlockGroup ? 0 : grouped ? t / 32 * kWarpMats + w / N : kNoGroup,
        kBlockGroup ? t : grouped ? w % N : N, Tile{}};
  if (grouped) c.tile = tile_of(smem, c.g);
  return c;
}

inline Arrays arrays(const void* mags, const void* signs, void* omags, void* osigns,
                     void* oflags, int64_t batch) {
  return Arrays{static_cast<const int64_t*>(mags), static_cast<const int64_t*>(signs),
                static_cast<int64_t*>(omags), static_cast<int64_t*>(osigns),
                static_cast<int32_t*>(oflags), batch};
}

}  // namespace qlanes

#ifdef __CUDACC__

namespace qlanes {

// The group barrier: the warp (a group of 32 lanes or fewer lies in one
// warp, and every thread of the block runs every step), or the block.
QD_FN void group_sync() {
  if constexpr (kBlockGroup) {
    __syncthreads();
  } else {
    __syncwarp();
  }
}

struct DeviceRunner {
  const Ctx& c;
  Lane& me;
  template <class F>
  QD_FN void group(F f) {
    f(c, me);
    group_sync();
  }
  template <class F>
  QD_FN void block(F f) {
    f(c, me);
    __syncthreads();
  }
  template <class F>
  QD_FN void last(F f) {
    f(c, me);
  }
};

__global__ void __launch_bounds__(kThreads) lanes_kernel(Arrays a) {
  extern __shared__ uint64_t smem[];
  const Ctx c = context(a, int64_t(blockIdx.x) * kMats, smem, threadIdx.x);
  Lane me;
  me.ovf = 0;
  DeviceRunner r{c, me};
  program(r);
}

inline int launch(const Arrays& a, void* stream) {
  if (a.batch <= 0) return 0;
  if (kSmemBytes > 48 * 1024) {
    // the opt-in is per device
    static bool opted[64] = {};
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return int(err);
    if (device < 64 && !opted[device]) {
      err = cudaFuncSetAttribute(lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemBytes);
      if (err != cudaSuccess) return int(err);
      opted[device] = true;
    }
  }
  const int64_t blocks = (a.batch + kMats - 1) / kMats;
  lanes_kernel<<<unsigned(blocks), kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

}  // namespace qlanes

#define LANES_ENTRY(name) LANES_CAT(name, _launch)
#define LANES_STREAM_PARAM , void* stream
#define LANES_RUN(arrays) qlanes::launch(arrays, stream)

#else

namespace qlanes {

// The host form: every step as a loop over the block's threads.
struct HostRunner {
  std::vector<Ctx>& cs;
  std::vector<Lane>& lanes;
  template <class F>
  void group(F f) {
    for (int t = 0; t < kThreads; ++t) f(cs[t], lanes[t]);
  }
  template <class F>
  void block(F f) {
    group(f);
  }
  template <class F>
  void last(F f) {
    group(f);
  }
};

inline int run_host(const Arrays& a) {
  std::vector<uint64_t> smem(kMats * kMatWords);
  std::vector<Ctx> cs(kThreads);
  std::vector<Lane> lanes(kThreads);
  for (int64_t first = 0; first < a.batch; first += kMats) {
    for (int t = 0; t < kThreads; ++t) {
      cs[t] = context(a, first, smem.data(), t);
      lanes[t] = Lane{};
    }
    HostRunner r{cs, lanes};
    program(r);
  }
  return 0;
}

}  // namespace qlanes

#define LANES_ENTRY(name) LANES_CAT(name, _host)
#define LANES_STREAM_PARAM
#define LANES_RUN(arrays) qlanes::run_host(arrays)

// The host build's calls of each primitive since the last call (sadd, mul,
// divide, invert, gt, blend; tracked: sadd_t, mul_window_t, divide_t,
// invert_t), into out[6]; the counts start again from 0.
extern "C" void fused_inverse_lanes_counts(int64_t* out) {
  for (int p = 0; p < qlanes::kPrims; ++p) {
    out[p] = qlanes::g_counts[p];
    qlanes::g_counts[p] = 0;
  }
}

#endif  // __CUDACC__

// The entry point, as fused_inverse.cu's: row-major (batch, n*n) int64
// magnitudes and signs in, the same out, and tracked the (batch,) int32
// flags; on `stream` of the card (*_launch, returning the launch's
// cudaError_t) or on the host (*_host).
extern "C" int fused_inverse_lanes_block_threads() { return qlanes::kThreads; }
extern "C" int fused_inverse_lanes_mats_per_block() { return qlanes::kMats; }
extern "C" int fused_inverse_lanes_smem_bytes() { return qlanes::kSmemBytes; }

#define LANES_CAT_(a, b) a##b
#define LANES_CAT(a, b) LANES_CAT_(a, b)
#if LANES_TRACK
#define LANES_STEM fused_inverse_lanes_tracked
#define LANES_FLAGS_PARAM , void* oflags
#define LANES_FLAGS oflags
#else
#define LANES_STEM fused_inverse_lanes
#define LANES_FLAGS_PARAM
#define LANES_FLAGS nullptr
#endif

extern "C" int LANES_ENTRY(LANES_STEM)(const void* mags, const void* signs, void* omags,
                                       void* osigns LANES_FLAGS_PARAM,
                                       int64_t batch LANES_STREAM_PARAM) {
  return LANES_RUN(qlanes::arrays(mags, signs, omags, osigns, LANES_FLAGS, batch));
}
