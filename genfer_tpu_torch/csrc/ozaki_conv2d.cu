// K5, the ozaki route's product (sm_90a): the truncated 2-D Cauchy product
// of f64 matrices from the exact chunk passes of
// genfer_tpu_torch/ops/ozaki_conv.py, over a batch.  With the chunks ca_t
// and cb_u and the column exponents ea, eb of ozaki_split.cu,
//
//   c[k0, k1] = sum_{i1} sum_{s <= P} 2^-7(s+2) 2^(ea[i1] + eb[k1 - i1])
//               * sum_{t + u = s} sum_{j0} ca_t[k0 - j0, i1] cb_u[j0, k1 - i1]
//
// Replaces genfer_tpu/ops/ozaki_conv.py::ozaki_conv2d_traced (192), with
// ozaki_conv2d_guarded (334) around it, which ran in XLA on the TPU.
//
// The numerics are the method's: for each a column i1 and diagonal s, the
// exact integer sum over t + u = s and j0, then one f64 weight 2^(ea[i1] +
// eb[l] - 7(s+2)) for each column l (ozaki.cuh::pow2), added into an f64
// accumulator.  Each term carries its own scale, which can only be applied
// after the exact integer sum, so the contraction axis is j0, not K1's i1.
// Only the order of the f64 additions is the kernel's: the result depends
// on the shapes alone (the same bits run to run, every batch entry equal
// to its single-pair call).
//
// The guard: where ``flags`` is given, every block of a product whose flag
// the split set returns at once, writing nothing; the first block of such
// a product adds one to ``guarded`` (the count on the device that
// ozaki_conv.py::guarded_count reads).  ozaki_conv.py launches K1
// predicated on the same flags and selects its result for those products.
//
// What bounds it on the H100: the dense body, the integer tensor-core
// multiply-adds, pair passes times the useful multiply-adds (36 at P = 7)
// over the int8 rate (1,979 TOPS dense, NVIDIA's data sheet: 989.5e12
// multiply-adds a second; bf16 half that); the small body, bytes.  What
// held the previous design (mma.sync, 32-row stages, byte-wise staging) at
// 12-16% of that bound, measured by ablation on the card (PERF.md), and
// what this one does about each:
//
//   * the f64 flush (1.03 of 4.29 ms at order 512): a stage is G = 64
//     rows of j0, so a Horner pair's int32 sums cover
//     twice the rows before they are converted and weighted.  A row adds
//     at most 8 pairs of |C_t C_u| <= 2^12, 2^15, so a Horner pair over G
//     rows stays below 2^7 2^15 G + 2^15 G < 2^31 up to G = 256.  G is 64
//     because the A fragments of every chunk of a stage column are kept in
//     registers (4 G / 32 x 8 registers) beside the int32 and f64
//     accumulators (32 + 64): 256 rows would need 256 of them.  Each
//     weight is built from its exponent's bits where all of a stage
//     column's weights are normal (normal_weights); ozaki.cuh::pow2, which
//     alone cost 1.65 ms at 512 (PERF.md), takes the rest.
//   * the staging (0.56 ms): cp.async in 16-byte pieces of whole rows,
//     straight from the split's layout (a's columns reversed there, so its
//     window is a run of ascending bytes), double-buffered: the next
//     stage's copies run under this stage's products.  A piece outside a,
//     or outside the unit's b columns or j0 range, is zero-filled by the
//     copy itself (source size 0); the plan cuts j0 at multiples of 16.
//   * A, B and the issue path: int8 runs wgmma.mma_async m64n64k32 s8, one
//     warpgroup a 64x64 output tile.  A comes from registers: the Toeplitz
//     A[m][k] = ca_t[K0 + m - (g0 + k), i1] of a reversed window column,
//     built once a stage column with __byte_perm of two aligned words, in
//     the mma.sync m16n8k32 A layout for the 16 rows of each warp.  B comes
//     from shared memory through a descriptor, no swizzle, K-major: the
//     window is stored as G / 16 planes of XW columns of 16 bytes (16 rows
//     of j0), so the 8-column x 16-byte core matrices are contiguous, the
//     next 8 columns 128 bytes on (SBO) and the next 16 rows a plane on
//     (LBO), and the descriptor's start moves by one window column (16
//     bytes) for each a column.  tune_port.py probe 14 checks this layout
//     and the shifted start on the card.  No per-byte index arithmetic and
//     no B loads remain in the loop.  bf16 keeps mma.sync m16n8k16 (A from
//     two words, B two 32-bit loads of the same planes) on the new staging.
//   * small products: the small body (the smaller operand at most
//     SMALL_LIMIT coefficients: the main path's 2x2 stencils and the
//     serving walks' products) takes no plan and no tensor core: each
//     thread sums its outputs' exact int32 products on the CUDA cores and
//     flushes them as the dense body does, one launch over (batch entry,
//     32x32 output tile).
//
// Dense body, int8, in detail (bf16 differs where said):
//
//   * work units: K1's dense plan (ops/conv2d.py::plan_units, cut_j1 =
//     False) with j0 ranges of at least 64 rows cut at multiples of 16
//     (ozaki_conv.py::plan), the smaller operand as b; a tile's units own
//     consecutive workspace slots, added in slot order by conv2d_unit.cuh's
//     sum_units_kernel.  The grid is unit-major over (unit, batch entry).
//   * stages: g0 (G rows from the unit's j0_lo) outer, then I (IB = 16 a
//     columns; bf16 4); a stage holds, for every chunk, the IB reversed a
//     columns over window entries y = 0 .. 64 + G - 1 (a's row K0 + 63 -
//     g0 - y) and the XW = 64 + IB - 1 b window columns (b's column K1 -
//     (I + IB - 1) + x) over rows g0 .. g0 + G - 1, and the stage's
//     exponents.  Two stages: 2 x 57.2 KB (int8), two blocks an SM; bf16
//     stages 64 rows of 4 a columns (2 x 77.1 KB, one block an SM), which
//     halves its flushes a row against 32-row stages.
//   * for each stage column i (a column i1 = I + i): the A fragments of
//     every chunk and both k-slices (64 registers); then for each Horner
//     pair (s - 1, s), s odd: the wgmma of diagonal s - 1 (scale-d 0 on the
//     first), wait, the int32 sums times 2^7, the wgmma of diagonal s on
//     top, wait, and one flush: acc += f64(sum) 2^(ea + eb - 7(s+2)) for
//     each of the thread's 32 outputs (a last even diagonal alone).
//     bf16: f32 sums of each diagonal (exact integers: 8 pairs x 64 rows x
//     2^12 = 2^21), taken to int32 with an FADD (exact_int), a flush a
//     diagonal.
//   * the accumulator layout (wgmma m64nN, and mma.sync for each 16x8
//     tile): register 4 j + 2 h + q of lane 4 g + tq in warp w is row 16 w
//     + 8 h + g, column 8 j + 2 tq + q.
//
// Pair passes t + u = s, s <= P: 21 at P = 5, 28 at 6, 36 at 7.

#include <cuda_bf16.h>

#include <climits>
#include <cstdint>

#include "conv2d_unit.cuh"
#include "ozaki.cuh"

namespace {

constexpr int NO_COL = INT_MIN;  // a window column outside the unit's b
// the exponent sum such a column takes: its int32 sums are 0 (the staging
// zero-filled its B column), so any finite weight adds exactly 0; this one
// keeps every weight 2^(600 - 7(s+2)) normal
constexpr int NO_COL_EX = 600;

template <typename E>
struct OzGeo;

template <>
struct OzGeo<int8_t> {
  static constexpr int G = 64;   // j0 rows a stage
  static constexpr int IB = 16;  // a columns a stage
};

template <>
struct OzGeo<__nv_bfloat16> {
  // f32 sums of 64 rows stay exact (8 x 2^12 x 64 = 2^21 < 2^22, the bound
  // of exact_int); 4 a columns keep two stages at 2 x 77.1 KB
  static constexpr int G = 64;
  static constexpr int IB = 4;
};

// the shared-memory layout of one stage
template <typename E>
struct OzStage {
  static constexpr int G = OzGeo<E>::G;
  static constexpr int IB = OzGeo<E>::IB;
  static constexpr int ESZ = static_cast<int>(sizeof(E));
  static constexpr int PR = 16 / ESZ;       // rows a 16-byte piece
  static constexpr int PLANES = G / PR;     // pieces a window column
  static constexpr int XW = BN + IB - 1;    // b window columns
  static constexpr int A_LEN = BM + G;      // window entries (63 + G used)
  static constexpr int A_BYTES = A_LEN * ESZ;
  static constexpr int A_PIECES = A_BYTES / 16;
  static constexpr int PLANE = XW * 16;     // bytes a plane: the LBO
  static constexpr int B_CHUNK = PLANES * PLANE;
  static constexpr int A_CHUNK = IB * A_BYTES;
  __host__ __device__ static constexpr int bytes(int n_t) {
    return (n_t * (A_CHUNK + B_CHUNK) + 4 * (IB + XW) + 15) / 16 * 16;
  }
};

// the descriptor's strides (bytes): the next 8 window columns (SBO) and
// the next 16 rows of j0 (LBO), tune_port.py probe 14
constexpr int K5_SBO = 128;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the copies of stage (g0, I) into ``buf`` (this thread's share) and
// store its exponents.  ``ca`` / ``cb``: this product's chunks; ``pos0``:
// a's position of window entry 0 (P_a - 64 - K0 + g0), ``col0``: b's column
// of window column 0.
template <typename E>
__device__ __forceinline__ void stage_copies(
    const unsigned char* __restrict__ ca, const unsigned char* __restrict__ cb,
    const int* __restrict__ ea, const int* __restrict__ eb, int n_t, int a1,
    int Pa, int b1, int Pb, int pos0, int col0, int g0, int j0_hi, int I,
    int n_i, int j1_lo, int j1_hi, unsigned char* buf) {
  using S = OzStage<E>;
  unsigned char* sA = buf;
  unsigned char* sB = buf + n_t * S::A_CHUNK;
  int* sEa = reinterpret_cast<int*>(sB + n_t * S::B_CHUNK);
  int* sEb = sEa + S::IB;
  for (int e = threadIdx.x; e < n_t * S::IB * S::A_PIECES; e += NT) {
    const int q = e % S::A_PIECES;
    const int rest = e / S::A_PIECES;
    const int i = rest % S::IB;
    const int t = rest / S::IB;
    const int p = pos0 + q * S::PR;  // a multiple of PR, as Pa is
    const bool ok = i < n_i && p >= 0 && p < Pa;
    const unsigned char* src =
        ok ? ca + (static_cast<size_t>(t * a1 + I + i) * Pa + p) * S::ESZ
           : ca;
    cp_async16(sA + (t * S::IB + i) * S::A_BYTES + 16 * q, src, ok);
  }
  for (int e = threadIdx.x; e < n_t * S::PLANES * S::XW; e += NT) {
    const int x = e % S::XW;
    const int rest = e / S::XW;
    const int kc = rest % S::PLANES;
    const int u = rest / S::PLANES;
    const int l = col0 + x;
    const int r = g0 + kc * S::PR;  // r < j0_hi <= b0 <= Pb - PR + 1
    const bool ok = l >= j1_lo && l < j1_hi && r < j0_hi;
    const unsigned char* src =
        ok ? cb + (static_cast<size_t>(u * b1 + l) * Pb + r) * S::ESZ : cb;
    cp_async16(sB + u * S::B_CHUNK + kc * S::PLANE + 16 * x, src, ok);
  }
  for (int i = threadIdx.x; i < S::IB; i += NT)
    sEa[i] = i < n_i ? ea[I + i] : 0;
  for (int x = threadIdx.x; x < S::XW; x += NT) {
    const int l = col0 + x;
    sEb[x] = l >= j1_lo && l < j1_hi ? eb[l] : NO_COL;
  }
}

// Four consecutive bytes of a staged a column starting at byte ``y``
// (any alignment): two aligned words and a __byte_perm
__device__ __forceinline__ unsigned window_word(const unsigned* w, int y,
                                                unsigned sel) {
  return __byte_perm(w[y >> 2], w[(y >> 2) + 1], sel);
}

// an f32 sum of the bf16 impl (an integer, |x| < 2^22) as an exact int32:
// x + 1.5 2^23 holds x + 2^22 in its low mantissa bits (no conversion
// unit: an FADD and an IADD)
__device__ __forceinline__ int exact_int(float x) {
  return __float_as_int(x + 12582912.0f) - 0x4B400000;
}

__device__ __forceinline__ int exact_int(int x) { return x; }

// Whether every weight 2^(ex - 7(s+2)) of these exponent sums, s < n_s,
// is a normal f64 (then ``flush`` builds it from the bits; otherwise it
// takes ozaki.cuh::pow2, which also gives the subnormal, zero and inf
// weights exactly).
__device__ __forceinline__ bool normal_weights(const int (&ex)[8][2],
                                               int n_s) {
  const int lo = OZ_CHUNK_BITS * (n_s + 1) - 1022;
  bool ok = true;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      ok = ok && static_cast<unsigned>(ex[j][q] - lo) <=
                     static_cast<unsigned>(1023 + 2 * OZ_CHUNK_BITS - lo);
  return ok;
}

// The flush of a diagonal (or Horner pair) s: the 32 int32 (f32) sums to
// f64, weighted by 2^(ex - 7(s+2)) a column, into the accumulator;
// register 4 j + 2 h + q is column 8 j + 2 tq + q.  ``normal``: see
// normal_weights.
template <typename Acc>
__device__ __forceinline__ void flush(const Acc (&c)[32],
                                      const int (&ex)[8][2], int s,
                                      bool normal, double (&acc)[32]) {
  const int shift = OZ_CHUNK_BITS * (s + 2);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = ex[j][q] - shift;
      const double w =
          normal ? __hiloint2double((e + 1023) << 20, 0) : pow2(e);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 4 * j + 2 * h + q;
        acc[k] = fma(to_f64(exact_int(c[k])), w, acc[k]);
      }
    }
}

// ---------------------------------------------------------------- int8

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// the accumulator's registers are written by the tensor cores between the
// issue and the wait: pin every use of them behind the wait
__device__ __forceinline__ void pin(int (&d)[32]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) asm volatile("" : "+r"(d[k])::"memory");
}

// the descriptor of a K-major, unswizzled B operand starting at ``p``
__device__ __forceinline__ uint64_t b_desc(const void* p, int lbo) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(K5_SBO >> 4) << 32;
}

// d (+)= A (64x32 s8, this warp's 16 rows in a) * B (32x64 s8 at desc)
__device__ __forceinline__ void wgmma_s8(int (&d)[32], const unsigned (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}

// The wgmma of diagonal s (every pair t + u = s, both k-slices) into d,
// the first of them replacing d unless ``keep``.
template <int S>
__device__ __forceinline__ void diagonal_s8(int (&d)[32],
                                            const unsigned (&af)[8][2][4],
                                            uint64_t desc0, bool keep) {
  using L = OzStage<int8_t>;
  wgmma_fence();
  bool first = !keep;
#pragma unroll
  for (int t = 0; t < OZ_N_CHUNKS; ++t) {
    const int u = S - t;
    if (u < 0 || u >= OZ_N_CHUNKS) continue;
#pragma unroll
    for (int ks = 0; ks < L::G / 32; ++ks) {
      const uint64_t off = (u * L::B_CHUNK + 2 * ks * L::PLANE) >> 4;
      wgmma_s8(d, af[t][ks], desc0 + off, first ? 0 : 1);
      first = false;
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  pin(d);
}

// One stage of a unit, int8: every stage column into ``acc``.
__device__ __forceinline__ void stage_s8(const unsigned char* buf, int n_t,
                                         int n_s, int n_i,
                                         double (&acc)[32]) {
  using L = OzStage<int8_t>;
  const unsigned char* sA = buf;
  const unsigned char* sB = buf + n_t * L::A_CHUNK;
  const int* sEa = reinterpret_cast<const int*>(sB + n_t * L::B_CHUNK);
  const int* sEb = sEa + L::IB;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;
  const int tq = lane % 4;
  // entry 63 - m + 4 tq (+ 32 ks) of row m = 16 warp + gid, whose byte
  // within its aligned word is (3 - gid) & 3
  const unsigned sel = 0x3210u + 0x1111u * static_cast<unsigned>((3 - gid) &
                                                                 3);
  const int y0 = 63 - (16 * warp + gid) + 4 * tq;
  for (int i = 0; i < n_i; ++i) {
    // this thread's columns n = 8 j + 2 tq + q read window column n + IB -
    // 1 - i
    int ex[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int e_b = sEb[8 * j + 2 * tq + q + L::IB - 1 - i];
        ex[j][q] = e_b == NO_COL ? NO_COL_EX : sEa[i] + e_b;
      }
    const bool normal = normal_weights(ex, n_s);
    // A (16 rows of this warp, 32 k) of every chunk and k-slice: a0 .. a3
    // at entries y, y - 8, y + 16, y + 8 (rows g, g + 8; k 4 tq, 16 + 4 tq)
    unsigned af[8][2][4];
#pragma unroll
    for (int t = 0; t < OZ_N_CHUNKS; ++t) {
      if (t < n_t) {
        const unsigned* w =
            reinterpret_cast<const unsigned*>(sA + (t * L::IB + i) * L::A_BYTES);
#pragma unroll
        for (int ks = 0; ks < L::G / 32; ++ks) {
          const int y = y0 + 32 * ks;
          af[t][ks][0] = window_word(w, y, sel);
          af[t][ks][1] = window_word(w, y - 8, sel);
          af[t][ks][2] = window_word(w, y + 16, sel);
          af[t][ks][3] = window_word(w, y + 8, sel);
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < L::G / 32; ++ks)
#pragma unroll
          for (int r = 0; r < 4; ++r) af[t][ks][r] = 0u;
      }
    }
    const uint64_t desc0 = b_desc(sB + 16 * (L::IB - 1 - i), L::PLANE);
    int c[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) c[k] = 0;
#pragma unroll
    for (int s = 0; s < 2 * OZ_N_CHUNKS - 1; s += 2) {
      if (s >= n_s) break;
      switch (s) {  // the diagonal's pairs as compile-time indices
#define OZ_DIAG(S)                                   \
  case S:                                            \
    diagonal_s8<S>(c, af, desc0, false);             \
    if (S + 1 < n_s) {                               \
      for (int k = 0; k < 32; ++k) c[k] *= 128;      \
      diagonal_s8<S + 1>(c, af, desc0, true);        \
    }                                                \
    break;
        OZ_DIAG(0)
        OZ_DIAG(2)
        OZ_DIAG(4)
        OZ_DIAG(6)
        OZ_DIAG(8)
        OZ_DIAG(10)
        OZ_DIAG(12)
        OZ_DIAG(14)
#undef OZ_DIAG
      }
      flush(c, ex, min(s + 1, n_s - 1), normal, acc);
    }
  }
}

// ---------------------------------------------------------------- bf16

// d[4 J ..] += A (16x16 bf16) * B (16x8 bf16), f32 sums
template <int J>
__device__ __forceinline__ void mma_bf16(float (&d)[32],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[4 * J]), "+f"(d[4 * J + 1]), "+f"(d[4 * J + 2]),
        "+f"(d[4 * J + 3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the eight 16x8 tiles of a warp's 16 x 64 (window column of tile J's lane
// column at ``col`` + 128 J)
template <int J>
__device__ __forceinline__ void mma_bf16_row(float (&d)[32],
                                             const unsigned (&a)[4],
                                             const unsigned char* col,
                                             int plane0) {
  using L = OzStage<__nv_bfloat16>;
  const unsigned char* p = col + 16 * 8 * J;
  const unsigned b[2] = {
      *reinterpret_cast<const unsigned*>(p + plane0),
      *reinterpret_cast<const unsigned*>(p + plane0 + L::PLANE)};
  mma_bf16<J>(d, a, b);
  if constexpr (J + 1 < 8) mma_bf16_row<J + 1>(d, a, col, plane0);
}

// One stage of a unit, bf16: four warps, each 16 rows (warp) x 64 columns
// (eight 16x8 mma tiles, register 4 j + 2 h + q as in the int8 body), the
// A fragments of each pair read with it: a0 .. a3 at entries y, y - 8,
// y + 8, y (rows g, g + 8; k 2 tq, 8 + 2 tq), y = 63 - m + 16 ks + 2 tq;
// b0 and b1 word tq of planes 2 ks and 2 ks + 1 of the lane's window column
__device__ __forceinline__ void stage_bf16(const unsigned char* buf, int n_t,
                                           int n_s, int n_i,
                                           double (&acc)[32]) {
  using L = OzStage<__nv_bfloat16>;
  const unsigned char* sA = buf;
  const unsigned char* sB = buf + n_t * L::A_CHUNK;
  const int* sEa = reinterpret_cast<const int*>(sB + n_t * L::B_CHUNK);
  const int* sEb = sEa + L::IB;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;
  const int tq = lane % 4;
  // entry 63 - m (m = 16 warp + gid) is odd where gid is even: its two
  // bytes start at byte 2 of the aligned word
  const unsigned sel = (gid & 1) ? 0x3210u : 0x5432u;
  const int y0 = 2 * (63 - (16 * warp + gid) + 2 * tq);  // bytes
  for (int i = 0; i < n_i; ++i) {
    int ex[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int e_b = sEb[8 * j + 2 * tq + q + L::IB - 1 - i];
        ex[j][q] = e_b == NO_COL ? NO_COL_EX : sEa[i] + e_b;
      }
    const bool normal = normal_weights(ex, n_s);
    // window column of mma tile j's lane column 8 j + gid
    const unsigned char* pb = sB + 16 * (gid + L::IB - 1 - i) + 4 * tq;
    float c[32];
    for (int s = 0; s < n_s; ++s) {
#pragma unroll
      for (int k = 0; k < 32; ++k) c[k] = 0.f;
      const int t_lo = max(0, s - (OZ_N_CHUNKS - 1));
      const int t_hi = min(s, n_t - 1);
      for (int t = t_lo; t <= t_hi; ++t) {
        const unsigned* w = reinterpret_cast<const unsigned*>(
            sA + (t * L::IB + i) * L::A_BYTES);
        const unsigned char* pu = pb + (s - t) * L::B_CHUNK;
#pragma unroll
        for (int ks = 0; ks < L::G / 16; ++ks) {
          const int y = y0 + 32 * ks;
          const unsigned af[4] = {
              window_word(w, y, sel), window_word(w, y - 16, sel),
              window_word(w, y + 16, sel), window_word(w, y, sel)};
          // a3 = A[g + 8][8 + 2 tq]: entry y - 8 + 8 = y (bytes: + 0)
          mma_bf16_row<0>(c, af, pu, 2 * ks * L::PLANE);
        }
      }
      flush(c, ex, s, normal, acc);
    }
  }
}

// ---------------------------------------------------------------- units

// One unit: the tile at (K0, K1) summed over j0 in [j0_lo, j0_hi) (j0_lo a
// multiple of 16) and b columns in [j1_lo, j1_hi).  ``to_slot``: ``out`` is
// a dense BM x BN workspace tile, written whole; otherwise it is this
// product's c (row-major c0 x c1), written where k < (c0, c1).  ``smem``
// holds two stages.
template <typename E>
__device__ __forceinline__ void ozaki_unit(
    const E* __restrict__ ca, const E* __restrict__ cb,
    const int* __restrict__ ea, const int* __restrict__ eb,
    double* __restrict__ out, bool to_slot, int n_t, int n_s, int a1,
    int Pa, int b1, int Pb, int c0, int c1, int K0, int K1, int j0_lo,
    int j0_hi, int j1_lo, int j1_hi, unsigned char* __restrict__ smem) {
  using L = OzStage<E>;
  const int buf_bytes = L::bytes(n_t);
  // a's columns whose band meets the unit's b columns
  const int i1_lo = max(0, K1 - j1_hi + 1);
  const int i1_hi = min(a1, K1 + BN - j1_lo);
  const int n_I = (i1_hi - i1_lo + L::IB - 1) / L::IB;
  const int n_st = (j0_hi - j0_lo + L::G - 1) / L::G * n_I;
  const unsigned char* pa = reinterpret_cast<const unsigned char*>(ca);
  const unsigned char* pb = reinterpret_cast<const unsigned char*>(cb);

  double acc[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.0;

  auto issue = [&](int st) {
    const int g0 = j0_lo + st / n_I * L::G;
    const int I = i1_lo + st % n_I * L::IB;
    stage_copies<E>(pa, pb, ea, eb, n_t, a1, Pa, b1, Pb, Pa - BM - K0 + g0,
                    K1 - (I + L::IB - 1), g0, j0_hi, I,
                    min(L::IB, i1_hi - I), j1_lo, j1_hi,
                    smem + (st & 1) * buf_bytes);
    cp_async_commit();
  };
  issue(0);
  for (int st = 0; st < n_st; ++st) {
    if (st + 1 < n_st) {
      issue(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // the copies are generic-proxy writes; wgmma reads through the async
    // proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int I = i1_lo + st % n_I * L::IB;
    const unsigned char* buf = smem + (st & 1) * buf_bytes;
    if constexpr (sizeof(E) == 1)
      stage_s8(buf, n_t, n_s, min(L::IB, i1_hi - I), acc);
    else
      stage_bf16(buf, n_t, n_s, min(L::IB, i1_hi - I), acc);
    __syncthreads();  // every thread is done with this buffer
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;
  const int tq = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * warp + 8 * h + gid;
      const int n = 8 * j + 2 * tq;
      const double x0 = acc[4 * j + 2 * h];
      const double x1 = acc[4 * j + 2 * h + 1];
      if (to_slot) {
        *reinterpret_cast<double2*>(out + m * BN + n) = make_double2(x0, x1);
      } else if (K0 + m < c0) {
        double* row = out + static_cast<size_t>(K0 + m) * c1 + K1 + n;
        if (K1 + n < c1) row[0] = x0;
        if (K1 + n + 1 < c1) row[1] = x1;
      }
    }
}

template <typename E>
__global__ void __launch_bounds__(NT, 2)
ozaki_conv2d_kernel(const E* __restrict__ ca, const E* __restrict__ cb,
                    const int* __restrict__ ea, const int* __restrict__ eb,
                    const int* __restrict__ flags,
                    unsigned long long* __restrict__ guarded,
                    double* __restrict__ c, double* __restrict__ work,
                    const int4* __restrict__ units, int batch, int slots,
                    int n_t, int n_s, int a0, int a1, int Pa, int b0, int b1,
                    int Pb, int c0, int c1) {
  extern __shared__ __align__(128) unsigned char smem8[];
  const int u = blockIdx.x / batch;
  const int z = blockIdx.x - u * batch;
  if (flags != nullptr && flags[z] != 0) {
    if (u == 0 && threadIdx.x == 0) atomicAdd(guarded, 1ull);
    return;
  }
  const int4 p = units[2 * u];
  const int4 q = units[2 * u + 1];
  const bool to_slot = q.z >= 0;
  double* out =
      to_slot ? work + (static_cast<size_t>(z) * slots + q.z) * TILE_WORDS
              : c + static_cast<size_t>(z) * c0 * c1;
  ozaki_unit<E>(ca + static_cast<size_t>(z) * n_t * a1 * Pa,
                cb + static_cast<size_t>(z) * n_t * b1 * Pb,
                ea + static_cast<size_t>(z) * a1,
                eb + static_cast<size_t>(z) * b1, out, to_slot, n_t, n_s, a1,
                Pa, b1, Pb, c0, c1, p.x, p.y, p.z, p.w, q.x, q.y, smem8);
}

// ---------------------------------------------------------- small body

constexpr int OS_NT = 256;    // threads a block
constexpr int OS_T = 32;      // output rows and columns a tile
constexpr int OS_RPT = OS_T / (OS_NT / OS_T);  // rows a thread: 4
constexpr int OS_LIMIT = 64;  // most coefficients of the smaller operand

template <typename E>
__device__ __forceinline__ int chunk_int(E v);

template <>
__device__ __forceinline__ int chunk_int<int8_t>(int8_t v) {
  return v;
}

template <>
__device__ __forceinline__ int chunk_int<__nv_bfloat16>(__nv_bfloat16 v) {
  return static_cast<int>(__bfloat162float(v));
}

// shared memory of the small body: a's window and b's packed table
__host__ __device__ constexpr size_t small_smem(int b0, int b1, int n_s) {
  return sizeof(uint2) * ((OS_T + b0 - 1) * (OS_T + b1 - 1) +
                          static_cast<size_t>(b0) * b1 * n_s);
}

// The small body: one block a (batch entry, 32 x 32 output tile), each
// thread 4 rows of one output column (a warp: 32 consecutive columns, so
// that it reads the window and writes c in consecutive words).  It stages
// a's window (the tile and b0 - 1 rows, b1 - 1 columns of halo, zero
// outside a) with a's 8 chunks of an entry packed in 8 bytes (int8, also
// for bf16: the chunks are integers in [-64, 64]), and a table of b:
// for each (j0, j1, s) the 8 bytes cb_{s-t}[j0, j1], t = 0 .. 7 (zero
// where s - t is no chunk), so that S_s, the exact int32 sum over t + u =
// s, is two __dp4a of the packed words a (j0, j1).  For each b column j1
// ascending (a column i1 = k1 - j1): S_s over j0, their Horner pairs, and
// acc = fma(f64(pair), 2^(ea[i1] + eb[j1] - 7(s+2)), acc), s odd (or the
// last); |S_s| <= 2^15 64, so a pair stays below 2^31.
template <typename E, int NS>
__global__ void __launch_bounds__(OS_NT)
ozaki_small_kernel(const E* __restrict__ ca, const E* __restrict__ cb,
                   const int* __restrict__ ea, const int* __restrict__ eb,
                   const int* __restrict__ flags,
                   unsigned long long* __restrict__ guarded,
                   double* __restrict__ c, int tiles1, int tiles, int n_t,
                   int n_s, int a0, int a1, int Pa, int b0, int b1, int Pb,
                   int c0, int c1) {
  extern __shared__ __align__(16) uint2 small8[];
  const int z = blockIdx.x / tiles;
  const int tl = blockIdx.x - z * tiles;
  if (flags != nullptr && flags[z] != 0) {
    if (tl == 0 && threadIdx.x == 0) atomicAdd(guarded, 1ull);
    return;
  }
  const int K0 = tl / tiles1 * OS_T;
  const int K1 = tl % tiles1 * OS_T;
  const int WR = OS_T + b0 - 1;  // window rows: a's K0 - b0 + 1 + r
  const int WC = OS_T + b1 - 1;  // window columns: a's K1 - b1 + 1 + q
  uint2* win = small8;
  uint2* table = small8 + WR * WC;
  const E* caz = ca + static_cast<size_t>(z) * n_t * a1 * Pa;
  const E* cbz = cb + static_cast<size_t>(z) * n_t * b1 * Pb;
  // the window: a thread an entry, its 8 chunks loaded together (from 8
  // planes; consecutive threads on consecutive positions of a's reversed
  // columns) and stored as one 8-byte word
  const size_t plane_a = static_cast<size_t>(a1) * Pa;
  for (int e = threadIdx.x; e < WC * WR; e += OS_NT) {
    const int q = e / WR;
    const int r = e - q * WR;
    const int ra = K0 - b0 + 1 + r;
    const int qa = K1 - b1 + 1 + q;
    const bool ok = ra >= 0 && ra < a0 && qa >= 0 && qa < a1;
    const E* src = caz + static_cast<size_t>(qa) * Pa + Pa - 1 - ra;
    int v[OZ_N_CHUNKS];
#pragma unroll
    for (int t = 0; t < OZ_N_CHUNKS; ++t)
      v[t] = ok && t < n_t ? chunk_int<E>(src[t * plane_a]) : 0;
    unsigned w[2] = {0u, 0u};
#pragma unroll
    for (int t = 0; t < OZ_N_CHUNKS; ++t)
      w[t / 4] |= (static_cast<unsigned>(v[t]) & 0xffu) << (8 * (t % 4));
    win[r * WC + q] = make_uint2(w[0], w[1]);
  }
  for (int e = threadIdx.x; e < b0 * b1 * n_s; e += OS_NT) {
    const int s = e % n_s;
    const int jj = e / n_s;  // j0 b1 + j1
    const int j0 = jj / b1;
    const int j1 = jj % b1;
    int v[OZ_N_CHUNKS];
#pragma unroll
    for (int t = 0; t < OZ_N_CHUNKS; ++t) {
      const int u = s - t;
      v[t] = t < n_t && u >= 0 && u < n_t
                 ? chunk_int<E>(
                       cbz[(static_cast<size_t>(u) * b1 + j1) * Pb + j0])
                 : 0;
    }
    unsigned w[2] = {0u, 0u};
#pragma unroll
    for (int t = 0; t < OZ_N_CHUNKS; ++t)
      w[t / 4] |= (static_cast<unsigned>(v[t]) & 0xffu) << (8 * (t % 4));
    table[e] = make_uint2(w[0], w[1]);
  }
  __syncthreads();
  const int tx = threadIdx.x % OS_T;
  const int ty = threadIdx.x / OS_T;
  const int k1 = K1 + tx;
  const int* eaz = ea + static_cast<size_t>(z) * a1;
  const int* ebz = eb + static_cast<size_t>(z) * b1;
  double acc[OS_RPT];
#pragma unroll
  for (int r = 0; r < OS_RPT; ++r) acc[r] = 0.0;
  for (int j1 = 0; j1 < b1; ++j1) {
    const int i1 = k1 - j1;
    if (i1 < 0) break;
    if (i1 >= a1) continue;
    int S[OS_RPT][NS];
#pragma unroll
    for (int r = 0; r < OS_RPT; ++r)
#pragma unroll
      for (int s = 0; s < NS; ++s) S[r][s] = 0;
    for (int j0 = 0; j0 < b0; ++j0) {
      const uint2* tb = table + (j0 * b1 + j1) * n_s;
      uint2 va[OS_RPT];
#pragma unroll
      for (int r = 0; r < OS_RPT; ++r)
        va[r] = win[(OS_RPT * ty + r + b0 - 1 - j0) * WC + tx + b1 - 1 - j1];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        if (s >= n_s) break;
        const uint2 bt = tb[s];
#pragma unroll
        for (int r = 0; r < OS_RPT; ++r)
          S[r][s] = __dp4a(static_cast<int>(va[r].y), static_cast<int>(bt.y),
                           __dp4a(static_cast<int>(va[r].x),
                                  static_cast<int>(bt.x), S[r][s]));
      }
    }
    const int ex = eaz[i1] + ebz[j1];
    const bool normal = ex - OZ_CHUNK_BITS * (n_s + 1) >= -1022 &&
                        ex - 2 * OZ_CHUNK_BITS <= 1023;
#pragma unroll
    for (int s = 0; s < NS; s += 2) {
      if (s >= n_s) break;
      const bool pair = s + 1 < n_s;
      const int e = ex - OZ_CHUNK_BITS * (s + (pair ? 3 : 2));
      const double w =
          normal ? __hiloint2double((e + 1023) << 20, 0) : pow2(e);
#pragma unroll
      for (int r = 0; r < OS_RPT; ++r) {
        const int h = pair ? S[r][s] * 128 + S[r][s + 1] : S[r][s];
        acc[r] = fma(to_f64(h), w, acc[r]);
      }
    }
  }
  if (k1 < c1)
#pragma unroll
    for (int r = 0; r < OS_RPT; ++r) {
      const int k0 = K0 + OS_RPT * ty + r;
      if (k0 < c0) c[(static_cast<size_t>(z) * c0 + k0) * c1 + k1] = acc[r];
    }
}

template <typename E>
cudaError_t launch_dense(const void* ca, const void* cb, const int* ea,
                         const int* eb, const int* flags,
                         unsigned long long* guarded, double* c, double* work,
                         const int4* units, int n_units, int batch, int slots,
                         int n_t, int n_s, int a0, int a1, int Pa, int b0,
                         int b1, int Pb, int c0, int c1, cudaStream_t st) {
  static bool allowed[64] = {};
  const cudaError_t err =
      allow_smem(ozaki_conv2d_kernel<E>,
                 2 * static_cast<size_t>(OzStage<E>::bytes(OZ_N_CHUNKS)),
                 allowed);
  if (err != cudaSuccess) return err;
  ozaki_conv2d_kernel<E><<<static_cast<unsigned>(n_units) * batch, NT,
                           2 * OzStage<E>::bytes(n_t), st>>>(
      static_cast<const E*>(ca), static_cast<const E*>(cb), ea, eb, flags,
      guarded, c, work, units, batch, slots, n_t, n_s, a0, a1, Pa, b0, b1, Pb,
      c0, c1);
  return cudaGetLastError();
}

}  // namespace

// Launches on ``stream``; returns the first non-zero CUDA error (0 when
// every launch was accepted).  ``ca`` batch x n_t x a1 x Pa and ``cb`` batch
// x n_t x b1 x Pb chunks (int8, or bf16 where ``bf16``) and ``ea`` (batch x
// a1), ``eb`` (batch x b1) int32 exponents as ozaki_split lays them out (Pa
// = oz_padded(a0), Pb = oz_padded(b0)); ``flags`` (batch int32, the
// split's) and ``guarded`` (one uint64) both given, or both null (no
// guard); ``c`` batch x c0 x c1 f64; ``units`` n_units x 8 and ``sums``
// n_sums x 4 int32 as ozaki_conv.py::plan lays them out for one pair
// (16-byte aligned); ``work`` batch x ``slots`` tiles of 64x64 f64 (not
// read when n_sums == 0).  Keeps the chunk pairs t + u <= pair_bits, 1 <=
// n_t <= 8.  Output tiles that no unit names are left as they are.
extern "C" int ozaki_conv2d(const void* ca, const void* cb, const int* ea,
                            const int* eb, const int* flags, void* guarded,
                            double* c, double* work, const void* units,
                            int n_units, const void* sums, int n_sums,
                            int slots, int batch, int n_t, int pair_bits,
                            int bf16, int a0, int a1, int Pa, int b0, int b1,
                            int Pb, int c0, int c1, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(batch) * n_units > INT_MAX || n_t < 1 ||
      n_t > OZ_N_CHUNKS)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_s = min(2 * OZ_N_CHUNKS - 1, pair_bits + 1);
  const int4* u = static_cast<const int4*>(units);
  unsigned long long* g = static_cast<unsigned long long*>(guarded);
  const cudaError_t err =
      bf16 ? launch_dense<__nv_bfloat16>(ca, cb, ea, eb, flags, g, c, work, u,
                                         n_units, batch, slots, n_t, n_s, a0,
                                         a1, Pa, b0, b1, Pb, c0, c1, st)
           : launch_dense<int8_t>(ca, cb, ea, eb, flags, g, c, work, u,
                                  n_units, batch, slots, n_t, n_s, a0, a1, Pa,
                                  b0, b1, Pb, c0, c1, st);
  if (err != cudaSuccess || n_sums == 0) return static_cast<int>(err);
  return static_cast<int>(sum_units(work, c, static_cast<const int4*>(sums),
                                    n_sums, slots, batch, c0, c1, st));
}

// The small body: the same arguments for the chunks, exponents, guard and
// ``c``; b0 * b1 <= 64 (the kernel's b is the smaller operand).  Every
// output word of an unflagged product is written.
extern "C" int ozaki_small(const void* ca, const void* cb, const int* ea,
                           const int* eb, const int* flags, void* guarded,
                           double* c, int batch, int n_t, int pair_bits,
                           int bf16, int a0, int a1, int Pa, int b0, int b1,
                           int Pb, int c0, int c1, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b0 * b1 > OS_LIMIT || n_t < 1 || n_t > OZ_N_CHUNKS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles1 = (c1 + OS_T - 1) / OS_T;
  const long long tiles =
      static_cast<long long>((c0 + OS_T - 1) / OS_T) * tiles1;
  if (tiles * batch > INT_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_s = min(2 * OZ_N_CHUNKS - 1, pair_bits + 1);
  const unsigned grid = static_cast<unsigned>(tiles * batch);
  unsigned long long* g = static_cast<unsigned long long*>(guarded);
  const size_t smem = small_smem(b0, b1, n_s);  // <= 32 KB
  // the diagonals' sums in registers: 8 at pair_bits <= 7 (the default),
  // else all 15
#define OZ_SMALL(E, NS)                                                     \
  ozaki_small_kernel<E, NS><<<grid, OS_NT, smem, st>>>(                    \
      static_cast<const E*>(ca), static_cast<const E*>(cb), ea, eb, flags, \
      g, c, tiles1, static_cast<int>(tiles), n_t, n_s, a0, a1, Pa, b0, b1,  \
      Pb, c0, c1)
  if (bf16 && n_s <= 8)
    OZ_SMALL(__nv_bfloat16, 8);
  else if (bf16)
    OZ_SMALL(__nv_bfloat16, 2 * OZ_N_CHUNKS - 1);
  else if (n_s <= 8)
    OZ_SMALL(int8_t, 8);
  else
    OZ_SMALL(int8_t, 2 * OZ_N_CHUNKS - 1);
#undef OZ_SMALL
  return static_cast<int>(cudaGetLastError());
}
