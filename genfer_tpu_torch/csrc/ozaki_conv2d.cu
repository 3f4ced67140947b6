// K5, the ozaki route's product on Hopper's integer (or bf16) tensor cores
// (sm_90a): the truncated 2-D Cauchy product of two f64 matrices from the
// exact chunk passes of genfer_tpu_torch/ops/ozaki_conv.py.  With the
// chunks ca_t (n_t x a0 x a1) and cb_u (n_t x b0 x b1) and the column
// exponents ea, eb of ozaki_split.cu,
//
//   c[k0, k1] = sum_{i1} sum_{s <= P} 2^-7(s+2) 2^(ea[i1] + eb[k1 - i1])
//               * sum_{t + u = s} sum_{j0} ca_t[k0 - j0, i1] cb_u[j0, k1 - i1]
//
// Replaces genfer_tpu/ops/ozaki_conv.py::ozaki_conv2d_traced (192), with
// ozaki_conv2d_guarded (334) around it, which ran in XLA on the TPU.
//
// The contraction axis is j0, not K1's i1 (conv2d_trunc_f64.cu contracts
// over a's columns): each term carries its own scale 2^(ea[i1] + eb[l]),
// which can only be applied after the exact integer sum, so for each a
// column i1 and diagonal s the tensor cores compute
//
//   C_s[m, n] = sum_{j0} ca_t[K0 + m - j0, i1] cb_u[j0, K1 + n - i1]
//
// an exact int32 sum over t + u = s (f32 for bf16: exact integers below
// 2^24), then convert it to f64, weight it by 2^(ea[i1] + eb[K1 + n - i1]
// - 7(s+2)) (one exact power of two a column, ozaki.cuh::pow2) and add it
// into the f64 accumulator of the output tile.
//
// What bounds it on the H100: at best the integer tensor-core
// multiply-adds, pair passes times the useful multiply-adds (36 at P = 7)
// over the int8 rate (1,979 TOPS dense, NVIDIA's data sheet: 989.5e12
// multiply-adds a second; bf16 half that).  As built, the instructions
// around the mma bound it (PERF.md section 6: at order 512, with its mma
// removed it still takes 94% of its time): the f64 epilogue of every
// (stage column, Horner pair) on the FP64 pipe, the byte-wise staging, the
// B loads.  This design is simple and exact, not fast (wgmma is later
// work):
//
//   * work units: K1's dense body's plan (ops/conv2d.py::unit_plan with
//     cut_j1=False: 64x64 output tile at (K0, K1), j0 range, j1 range, the
//     smaller operand as b) with j0 ranges of at least 32 rows
//     (ops/ozaki_conv.py::plan), since a 16-row range would leave half of
//     every 32-deep mma empty.  A tile's units own consecutive workspace
//     slots, added in slot order by conv2d_unit.cuh's f64 sum_units_kernel:
//     the result depends on the shapes alone, the same bits run to run.
//   * 128 threads, a warp owns 32x32 of the tile: 2 x 4 mma tiles of 16x8,
//     one diagonal's int32 fragments (32 registers) and the f64
//     accumulator (64) live; the diagonals loop outside the j0 slices.
//   * int8: for each stage column, every chunk's A fragments are built
//     once (64 registers) and kept across the diagonals, whose chunk
//     pairs are unrolled; only B is read per pair, one 64-bit load a
//     fragment.  (A first design read A for every pair: it spent more
//     time on shared-memory loads and byte permutes than the mma take.)
//     bf16 reads both per pair: its two k-slices would double the cache.
//   * stages: G = 32 rows of j0 (one m16n8k32 slice; two m16n8k16 slices
//     for bf16) x IB = 32 columns of a, staged into shared memory with
//     plain loads, zero where a or the unit's part of b ends:
//       - a: for every chunk t and stage column i, the column i1 = I + i
//         of ca_t over rows R0 - y, y = 0 .. 94 (R0 = K0 + 63 - g0),
//         stored reversed, so that A[m][k] = ca_t[K0 + m - (g0 + k), i1]
//         is entry y = 63 - m + k and the 4 consecutive k of an A
//         register are 4 consecutive bytes; their alignment is (3 - g) & 3
//         for lane group g, so each register is built from two aligned
//         32-bit words with __byte_perm (a misaligned 32-bit shared load
//         would fault);
//       - b: for every chunk u and window column x (b column l = K1 - (I +
//         IB - 1) + x), the 32 rows j0 = g0 .. g0 + 31 in one column, so a
//         B register (4 consecutive k of one column) is one aligned word;
//         the words are stored in the order 0 4 1 5 2 6 3 7 (of each 8),
//         so that a lane's b0 and b1 are one 64-bit load;
//   * Horner pairs (int8): diagonal s - 1 is scaled by 2^7 in the int32
//     registers and diagonal s (odd) added on top, |2^7 C_{s-1} + C_s| <=
//     2^27 + 2^20, so half the diagonals reach the f64 epilogue; the
//     int32 -> f64 conversion adds the sum to 2^52 + 2^31 in the bits.
//
// Pair passes t + u = s, s <= P: 21 at P = 5, 28 at 6, 36 at 7.

#include <cuda_bf16.h>

#include <climits>
#include <cstdint>

#include "conv2d_unit.cuh"
#include "ozaki.cuh"

namespace {

constexpr int NO_COL = INT_MIN;  // a window column outside the unit's b

template <typename E>
struct OzGeo {
  static constexpr int G = 32;   // j0 rows a stage
  static constexpr int IB = 32;  // a columns a stage
  static constexpr int MT = 2;   // 16-row mma tiles down a warp tile
  static constexpr int NTL = 4;  // 8-column mma tiles across it
  static constexpr int A_LEN = BM + G;  // window entries a column (95 used)
  static constexpr int A_PITCH = A_LEN * static_cast<int>(sizeof(E));
  static constexpr int XW = BN + IB;  // b window columns (95 used)
  // bytes a b window column: its G rows, no padding.  int8: 8 words, so
  // the 64-bit B loads of a half warp (4 columns, 4 word pairs each) fall
  // in 32 distinct banks; bf16: 16 words, two columns of a half warp share
  // banks (a 2-way conflict, which keeps two blocks an SM)
  static constexpr int B_PITCH = G * static_cast<int>(sizeof(E));
  static constexpr size_t smem(int n_t) {
    return static_cast<size_t>(n_t) * (IB * A_PITCH + XW * B_PITCH) +
           sizeof(int) * (IB + XW);
  }
};

// d += A (16x32 s8, fragment a) * B (32x8 s8, fragment b), int32 sums
__device__ __forceinline__ void mma_pass(int (&d)[4],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A (16x16 bf16) * B (16x8 bf16), f32 sums
__device__ __forceinline__ void mma_pass(float (&d)[4],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// an exact int32 as f64: 2^52 + 2^31 + x in the bits, less 2^52 + 2^31
__device__ __forceinline__ double to_f64(int x) {
  return __hiloint2double(0x43300000, x ^ INT_MIN) - 4503601774854144.0;
}

__device__ __forceinline__ double to_f64(float x) {
  return static_cast<double>(x);
}

template <typename E>
struct OzPass;

// int8: one m16n8k32 slice a stage; A register = 4 consecutive window
// bytes, B register = one word
template <>
struct OzPass<int8_t> {
  using Acc = int;
  static constexpr int K_SLICES = 1;
  static constexpr bool HORNER = true;
  // a0 .. a3 at entries y0, y0 - 8, y0 + 16, y0 + 8 (y0 = 63 - m + 4 tq)
  __device__ static void load_a(const unsigned* w, int y0, unsigned sel,
                                int, unsigned (&a)[4]) {
    const int off[4] = {0, -8, 16, 8};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int y = y0 + off[r];
      a[r] = __byte_perm(w[y >> 2], w[(y >> 2) + 1], sel);
    }
  }
  // b0, b1: rows 4 tq .. 4 tq + 3 and 16 + 4 tq .. of the window column,
  // stored as the word pair 2 tq, 2 tq + 1 (b_word)
  __device__ static void load_b(const unsigned* col, int tq, int,
                                unsigned (&b)[2]) {
    const uint2 v = reinterpret_cast<const uint2*>(col)[tq];
    b[0] = v.x;
    b[1] = v.y;
  }
  // where row kk of a window column is stored: byte kk & 3 of word
  // b_word(kk >> 2)
  __device__ static int b_byte(int kk) {
    const int w = kk >> 2;
    return 4 * (((w & 3) << 1) | (w >> 2)) + (kk & 3);
  }
  __device__ static int entry0(int m, int tq, int) {
    return 63 - m + 4 * tq;
  }
  __device__ static unsigned selector(int gid) {
    return 0x3210u + 0x1111u * static_cast<unsigned>((3 - gid) & 3);
  }
};

// bf16: two m16n8k16 slices a stage; A register = 2 consecutive window
// entries (4 bytes at an even or odd entry), B register = one word
template <>
struct OzPass<__nv_bfloat16> {
  using Acc = float;
  static constexpr int K_SLICES = 2;
  static constexpr bool HORNER = false;
  // a0 .. a3 at entries y0, y0 - 8, y0 + 8, y0 (y0 = 63 - m + 16 ks + 2 tq)
  __device__ static void load_a(const unsigned* w, int y0, unsigned sel,
                                int, unsigned (&a)[4]) {
    const int off[4] = {0, -8, 8, 0};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int y = y0 + off[r];
      a[r] = __byte_perm(w[y >> 1], w[(y >> 1) + 1], sel);
    }
  }
  // b0, b1: rows 16 ks + 2 tq, + 1 and 16 ks + 8 + 2 tq, + 1, stored as
  // the word pair 8 ks + 2 tq, + 1
  __device__ static void load_b(const unsigned* col, int tq, int ks,
                                unsigned (&b)[2]) {
    const uint2 v = reinterpret_cast<const uint2*>(col)[4 * ks + tq];
    b[0] = v.x;
    b[1] = v.y;
  }
  // where row kk of a window column is stored (bytes): half kk & 1 of
  // word 8 (kk >> 4) + b_word((kk & 15) >> 1)
  __device__ static int b_byte(int kk) {
    const int w = (kk & 15) >> 1;
    return 4 * (8 * (kk >> 4) + (((w & 3) << 1) | (w >> 2))) +
           2 * (kk & 1);
  }
  __device__ static int entry0(int m, int tq, int ks) {
    return 63 - m + 16 * ks + 2 * tq;
  }
  __device__ static unsigned selector(int gid) {
    return (gid & 1) ? 0x3210u : 0x5432u;  // entry 63 - gid odd: shifted
  }
};

// The flush of a diagonal (or Horner pair) s: the int32 (f32) sums to
// f64, weighted by 2^(ea + eb - 7(s+2)) a column, into the accumulator.
// Accumulator 2 h + q of mma tile (M, N): row 8 h + gid, column 2 tq + q.
template <typename Acc, int MT, int NTL>
__device__ __forceinline__ void flush_diagonal(const Acc (&c)[MT][NTL][4],
                                               const int (&ex)[NTL][2],
                                               int s,
                                               double (&acc)[MT][NTL][4]) {
  const int shift = OZ_CHUNK_BITS * (s + 2);
  double w[NTL][2];
#pragma unroll
  for (int N = 0; N < NTL; ++N)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      w[N][q] = ex[N][q] == NO_COL ? 0.0 : pow2(ex[N][q] - shift);
#pragma unroll
  for (int M = 0; M < MT; ++M)
#pragma unroll
    for (int N = 0; N < NTL; ++N)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc[M][N][k] = fma(to_f64(c[M][N][k]), w[N][k & 1], acc[M][N][k]);
}

// One stage column (``pa``: its staged a column of chunk 0; ``pb``: the
// window column of the lane's mma column in tile 0, chunk 0) into ``acc``,
// int8: every chunk's A fragments are loaded once and kept in registers
// across the diagonals, whose pairs are unrolled so that they stay there.
template <typename E>
__device__ __forceinline__ void ozaki_column_cached(
    const unsigned char* pa, const unsigned char* pb,
    const int (&ex)[OzGeo<E>::NTL][2], unsigned sel, int mb, int gid, int tq,
    int n_t, int n_s, double (&acc)[OzGeo<E>::MT][OzGeo<E>::NTL][4]) {
  using L = OzGeo<E>;
  using P = OzPass<E>;
  using Acc = typename P::Acc;
  unsigned af[OZ_N_CHUNKS][L::MT][4];
#pragma unroll
  for (int t = 0; t < OZ_N_CHUNKS; ++t)
    if (t < n_t) {
      const unsigned* wa =
          reinterpret_cast<const unsigned*>(pa + t * L::IB * L::A_PITCH);
#pragma unroll
      for (int M = 0; M < L::MT; ++M)
        P::load_a(wa, P::entry0(mb + 16 * M + gid, tq, 0), sel, 0, af[t][M]);
    }
  Acc c[L::MT][L::NTL][4];
#pragma unroll
  for (int s = 0; s < 2 * OZ_N_CHUNKS - 1; ++s) {
    if (s >= n_s) break;
    const bool fresh = !P::HORNER || s % 2 == 0;
#pragma unroll
    for (int M = 0; M < L::MT; ++M)
#pragma unroll
      for (int N = 0; N < L::NTL; ++N)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          c[M][N][k] = fresh ? Acc(0) : c[M][N][k] * Acc(128);
#pragma unroll
    for (int t = 0; t < OZ_N_CHUNKS; ++t) {
      const int u = s - t;
      if (u < 0 || u >= OZ_N_CHUNKS || t >= n_t) continue;
      const unsigned char* pu = pb + u * L::XW * L::B_PITCH;
      unsigned bf[L::NTL][2];
#pragma unroll
      for (int N = 0; N < L::NTL; ++N)
        P::load_b(reinterpret_cast<const unsigned*>(pu + 8 * N * L::B_PITCH),
                  tq, 0, bf[N]);
#pragma unroll
      for (int M = 0; M < L::MT; ++M)
#pragma unroll
        for (int N = 0; N < L::NTL; ++N) mma_pass(c[M][N], af[t][M], bf[N]);
    }
    if (!P::HORNER || s % 2 == 1 || s == n_s - 1)
      flush_diagonal(c, ex, s, acc);
  }
}

// The same for bf16 (two k-slices a stage, whose cached fragments would
// not fit the registers): the A fragments of each pair are loaded with it.
template <typename E>
__device__ __forceinline__ void ozaki_column(
    const unsigned char* pa, const unsigned char* pb,
    const int (&ex)[OzGeo<E>::NTL][2], unsigned sel, int mb, int gid, int tq,
    int n_t, int n_s, double (&acc)[OzGeo<E>::MT][OzGeo<E>::NTL][4]) {
  using L = OzGeo<E>;
  using P = OzPass<E>;
  using Acc = typename P::Acc;
  Acc c[L::MT][L::NTL][4];
  for (int s = 0; s < n_s; ++s) {
    const bool fresh = !P::HORNER || s % 2 == 0;
#pragma unroll
    for (int M = 0; M < L::MT; ++M)
#pragma unroll
      for (int N = 0; N < L::NTL; ++N)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          c[M][N][k] = fresh ? Acc(0) : c[M][N][k] * Acc(128);
    const int t_lo = max(0, s - (OZ_N_CHUNKS - 1));
    const int t_hi = min(s, n_t - 1);
    for (int t = t_lo; t <= t_hi; ++t) {
      const unsigned* wa =
          reinterpret_cast<const unsigned*>(pa + t * L::IB * L::A_PITCH);
      const unsigned char* pu = pb + (s - t) * L::XW * L::B_PITCH;
#pragma unroll
      for (int ks = 0; ks < P::K_SLICES; ++ks) {
        unsigned af[L::MT][4];
        unsigned bf[L::NTL][2];
#pragma unroll
        for (int M = 0; M < L::MT; ++M)
          P::load_a(wa, P::entry0(mb + 16 * M + gid, tq, ks), sel, ks, af[M]);
#pragma unroll
        for (int N = 0; N < L::NTL; ++N)
          P::load_b(
              reinterpret_cast<const unsigned*>(pu + 8 * N * L::B_PITCH), tq,
              ks, bf[N]);
#pragma unroll
        for (int M = 0; M < L::MT; ++M)
#pragma unroll
          for (int N = 0; N < L::NTL; ++N) mma_pass(c[M][N], af[M], bf[N]);
      }
    }
    if (!P::HORNER || s % 2 == 1 || s == n_s - 1)
      flush_diagonal(c, ex, s, acc);
  }
}

// One unit: the tile at (K0, K1) summed over j0 in [j0_lo, j0_hi) and b
// columns in [j1_lo, j1_hi) (both nonempty and inside b).  ``to_slot``:
// ``out`` is a dense BM x BN workspace tile, written whole; otherwise it is
// c (row-major c0 x c1), written where k < (c0, c1).  ``smem`` holds
// OzGeo<E>::smem(n_t) bytes.
template <typename E>
__device__ __forceinline__ void ozaki_unit(
    const E* __restrict__ ca, const E* __restrict__ cb,
    const int* __restrict__ ea, const int* __restrict__ eb,
    double* __restrict__ out, bool to_slot, int n_t, int n_s, int a0,
    int a1, int b0, int b1, int c0, int c1, int K0, int K1, int j0_lo,
    int j0_hi, int j1_lo, int j1_hi, unsigned char* __restrict__ smem) {
  using L = OzGeo<E>;
  using P = OzPass<E>;
  using Acc = typename P::Acc;
  constexpr int G = L::G;
  constexpr int IB = L::IB;
  constexpr int XW = L::XW;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane / 4;  // the fragment layouts' group and
  const int tq = lane % 4;   // thread in group
  const int mb = (warp / 2) * 32;  // the warp's rows mb .. mb + 31
  const int nb = (warp % 2) * 32;  // and columns nb .. nb + 31
  const unsigned sel = P::selector(gid);

  unsigned char* sA = smem;
  unsigned char* sB = sA + n_t * IB * L::A_PITCH;
  int* sEa = reinterpret_cast<int*>(sB + n_t * XW * L::B_PITCH);
  int* sEb = sEa + IB;

  // a's columns whose band meets the unit's b columns
  const int i1_lo = max(0, K1 - j1_hi + 1);
  const int i1_hi = min(a1, K1 + BN - j1_lo);

  double acc[L::MT][L::NTL][4];
#pragma unroll
  for (int M = 0; M < L::MT; ++M)
#pragma unroll
    for (int N = 0; N < L::NTL; ++N)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[M][N][i] = 0.0;

  for (int g0 = j0_lo; g0 < j0_hi; g0 += G) {
    const int n_dj = min(G, j0_hi - g0);
    const int R0 = K0 + BM - 1 - g0;  // a's row of window entry y: R0 - y
    for (int I = i1_lo; I < i1_hi; I += IB) {
      const int n_i = min(IB, i1_hi - I);
      const int col0 = K1 - (I + IB - 1);  // b's column of window entry 0
      __syncthreads();  // every thread is done with the last stage
      for (int e = tid; e < n_t * L::A_LEN * IB; e += NT) {
        const int i = e % IB;
        const int rest = e / IB;
        const int y = rest % L::A_LEN;
        const int t = rest / L::A_LEN;
        const int r = R0 - y;
        E v{};
        if (i < n_i && r >= 0 && r < a0)
          v = ca[(static_cast<size_t>(t) * a0 + r) * a1 + I + i];
        reinterpret_cast<E*>(sA + (t * IB + i) * L::A_PITCH)[y] = v;
      }
      for (int e = tid; e < n_t * G * XW; e += NT) {
        const int x = e % XW;
        const int rest = e / XW;
        const int kk = rest % G;
        const int u = rest / G;
        const int l = col0 + x;
        E v{};
        if (kk < n_dj && l >= j1_lo && l < j1_hi)
          v = cb[(static_cast<size_t>(u) * b0 + g0 + kk) * b1 + l];
        *reinterpret_cast<E*>(sB + (u * XW + x) * L::B_PITCH +
                              P::b_byte(kk)) = v;
      }
      for (int i = tid; i < IB; i += NT) sEa[i] = i < n_i ? ea[I + i] : 0;
      for (int x = tid; x < XW; x += NT) {
        const int l = col0 + x;
        sEb[x] = l >= j1_lo && l < j1_hi ? eb[l] : NO_COL;
      }
      __syncthreads();

      for (int i = 0; i < n_i; ++i) {
        // this thread's columns n = nb + 8 N + 2 tq + q read window
        // column x = n + IB - 1 - i
        int ex[L::NTL][2];
#pragma unroll
        for (int N = 0; N < L::NTL; ++N)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int e_b = sEb[nb + 8 * N + 2 * tq + q + IB - 1 - i];
            ex[N][q] = e_b == NO_COL ? NO_COL : sEa[i] + e_b;
          }
        const unsigned char* pa = sA + i * L::A_PITCH;
        // window column of mma tile N's lane column nb + 8 N + gid
        const unsigned char* pb =
            sB + (nb + gid + IB - 1 - i) * L::B_PITCH;
        if constexpr (P::K_SLICES == 1)
          ozaki_column_cached<E>(pa, pb, ex, sel, mb, gid, tq, n_t, n_s, acc);
        else
          ozaki_column<E>(pa, pb, ex, sel, mb, gid, tq, n_t, n_s, acc);
      }
    }
  }

#pragma unroll
  for (int M = 0; M < L::MT; ++M)
#pragma unroll
    for (int N = 0; N < L::NTL; ++N)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mb + 16 * M + 8 * h + gid;
        const int n = nb + 8 * N + 2 * tq;
        const double x0 = acc[M][N][2 * h];
        const double x1 = acc[M][N][2 * h + 1];
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
                    double* __restrict__ c, double* __restrict__ work,
                    const int4* __restrict__ units, int n_t, int n_s, int a0,
                    int a1, int b0, int b1, int c0, int c1) {
  extern __shared__ __align__(16) unsigned char smem8[];
  const int4 p = units[2 * blockIdx.x];
  const int4 q = units[2 * blockIdx.x + 1];
  const bool to_slot = q.z >= 0;
  double* out = to_slot ? work + static_cast<size_t>(q.z) * TILE_WORDS : c;
  ozaki_unit<E>(ca, cb, ea, eb, out, to_slot, n_t, n_s, a0, a1, b0, b1, c0,
                c1, p.x, p.y, p.z, p.w, q.x, q.y, smem8);
}

template <typename E>
cudaError_t launch(const void* ca, const void* cb, const int* ea,
                   const int* eb, double* c, double* work, const int4* units,
                   int n_units, int n_t, int n_s, int a0, int a1, int b0,
                   int b1, int c0, int c1, cudaStream_t st) {
  static bool allowed[64] = {};
  const cudaError_t err = allow_smem(ozaki_conv2d_kernel<E>,
                                     OzGeo<E>::smem(OZ_N_CHUNKS), allowed);
  if (err != cudaSuccess) return err;
  ozaki_conv2d_kernel<E><<<n_units, NT, OzGeo<E>::smem(n_t), st>>>(
      static_cast<const E*>(ca), static_cast<const E*>(cb), ea, eb, c, work,
      units, n_t, n_s, a0, a1, b0, b1, c0, c1);
  return cudaGetLastError();
}

}  // namespace

// Launches on ``stream``; returns the first non-zero CUDA error (0 when
// every launch was accepted).  ``ca`` n_t x a0 x a1 and ``cb`` n_t x b0 x
// b1 chunks (int8, or bf16 where ``bf16``) and ``ea`` (a1), ``eb`` (b1)
// int32 exponents as ozaki_split lays them out; ``c`` c0 x c1 f64;
// ``units`` n_units x 8 and ``sums`` n_sums x 4 int32 as
// ops/conv2d.py::unit_plan(cut_j1=False) lays them out for these operands
// (16-byte aligned); ``work`` ``slots`` tiles of 64x64 f64 (not read when
// n_sums == 0).  Keeps the chunk pairs t + u <= pair_bits, 1 <= n_t <= 8.
// Output tiles that no unit names are left as they are.
extern "C" int ozaki_conv2d(const void* ca, const void* cb, const int* ea,
                            const int* eb, double* c, double* work,
                            const void* units, int n_units, const void* sums,
                            int n_sums, int slots, int n_t, int pair_bits,
                            int bf16, int a0, int a1, int b0, int b1, int c0,
                            int c1, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_s = min(2 * OZ_N_CHUNKS - 1, pair_bits + 1);
  const int4* u = static_cast<const int4*>(units);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(ca, cb, ea, eb, c, work, u, n_units, n_t,
                                   n_s, a0, a1, b0, b1, c0, c1, st)
           : launch<int8_t>(ca, cb, ea, eb, c, work, u, n_units, n_t, n_s,
                            a0, a1, b0, b1, c0, c1, st);
  if (err != cudaSuccess || n_sums == 0) return static_cast<int>(err);
  return static_cast<int>(sum_units(work, c, static_cast<const int4*>(sums),
                                    n_sums, slots, 1, c0, c1, st));
}
