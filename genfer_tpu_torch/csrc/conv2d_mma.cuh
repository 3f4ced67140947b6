// Device code of the tensor-core truncated 2-D product kernels K4a (tile,
// conv2d_trunc_f32_tile.cu) and K4b (grouped, conv2d_trunc_f32_grouped.cu)
// on Hopper (sm_90a): one *work unit* of
//
//     c[k0, k1] = sum_{j0, j1} a[k0 - j0, k1 - j1] * b[j0, j1]
//
// as split-TF32 matrix products.  A unit is (64x64 output tile at (K0, K1),
// j0 range, j1 range), a row of the table of ops/conv2d.py::unit_plan with
// cut_j1=False.  Replaces, with those two files, the TPU kernels
// genfer_tpu/ops/pallas_conv2d.py::_build2d and ::_build2d_grouped, which
// are that package's matrix-unit kernels: products of an a window with a
// Toeplitz tile of one b row.  The same product here, for each j0 of the
// unit and each 8-wide slice of a's columns starting at i1:
//
//     C[m, n] += A[m, k] * T[k, n]
//     A[m, k] = a[K0 + m - j0, i1 + k]
//     T[k, n] = b[j0, K1 + n - (i1 + k)]     (zero outside the unit's j1)
//
// as mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.  T is never built:
// a thread reads its two B-fragment values from the staged b row at offset
// n - k (the lanes of one fragment touch 11 consecutive words, equal
// addresses broadcast: no bank conflict).
//
// What bounds it on the H100: tensor-core TF32 multiply-adds, three per f32
// multiply-add, at the rate mma.sync reaches (about two thirds of the
// card's TF32 rate: tune_port.py's probe), then shared-memory loads of the
// fragments.  What the design does about accuracy and about each:
//
//   * split once, at staging.  Every staged word x goes to shared memory as
//     two planes, hi = tf32(x) (cvt.rna) and lo = tf32((x - hi) * 2^11); the
//     product is hi*hi + 2^-11 (hi*lo + lo*hi), lo*lo (2^-22 relative) is
//     dropped.  The scale is exact and keeps lo's products out of the
//     subnormal range where the operands' columns are as small as 1e-30.
//     (The split of Ootomo and Yokota, "Recovering single precision accuracy
//     from Tensor Cores while surpassing the FP32 theoretical peak
//     performance", 2022.)
//   * short chains, sums outside the tensor core.  The tensor core's own
//     f32 accumulation does not round to nearest, and one running f32 sum
//     over order^2 terms drifts whatever the rounding.  An mma chain starts
//     from zero and runs over eight steps (64 terms); hi*hi and the two
//     cross products have separate accumulators; at its end
//     grp += hh + 2^-11 cr in FFMA / FADD.  grp is added to acc once a
//     stage, and a tile's units are added in slot order by sum_units: the
//     three levels of conv2d_unit.cuh above the chain.
//   * register blocking.  128 threads; a warp owns 32x32 of the tile (2 x 4
//     mma tiles), so a k-slice is 24 mma for 16 + 16 fragment words, each
//     one conflict-free LDS.32: the a window's row pitch is KB + 4 words,
//     which puts the 8 rows x 4 columns of an A fragment on 32 banks.
//     About 220 registers, two blocks an SM.
//   * clipping.  The unit's j1 range meets a's columns i1 in
//     [K1 - j1_hi + 1, K1 + 64 - j1_lo), clipped to a: n1 + 63 columns for
//     n1 of b, which is why the plan cuts j0 only.  A warp skips the j0 at
//     which its 32 window rows lie outside a and the k-slices whose band
//     misses its 32 columns: on the diagonal tiles of a dense product that
//     is a quarter of the tile.
//   * staging: per (G = 16 rows of j0, KB = 64 columns of a) the window
//     (79 rows) and the b block (16 rows of KB + 63 words) come from global
//     memory (L2: the operands are a few MB) by cp.async into raw buffers
//     while the stage before is multiplied; then one pass splits them into
//     the planes.  A stage whose k-slices are all live runs its chains
//     without a branch, so the fragment loads of a slice issue under the
//     mma of the one before.
//
// ORDER (a template parameter) is the j0 order inside a stage:
//   * ASCENDING (K4a): j0 ascending, a chain per j0 over the stage's eight
//     k-slices, the A fragments loaded at every j0.
//   * RESIDUE (K4b): residue-major: dj mod 8 outer, then the k-slice, then
//     dj = r + 8 q, a chain per (class, four k-slices) over its two q.
//     Stepping j0 by 8 moves the window down by 8 rows, and in the m16n8k8
//     A fragment a thread holds rows g and g + 8 of each 16-row tile, so
//     the operand is carried in registers: half h of the next j0 is half
//     h - 1 of this one, and only the top half (one of four at a 32-row
//     warp tile) is loaded.  B fragments are fresh per j0.
//
// A b of fewer than 8 columns has a band narrower than one mma tile; those
// shapes run conv2d_unit.cuh's FFMA body on the same table (CJ = 1 for a
// one-column b, CJ = 8 otherwise), in both kernels: see the .cu files.
//
// This is the three-pass product (highest=True) only.  The one-pass mode
// of both kernels (the TPU kernels' highest=False) runs conv2d_wgmma.cuh's
// body in the same two orders, which shares neither this staging nor its
// fragment loads.

#pragma once

#include <type_traits>

#include "conv2d_unit.cuh"

namespace {

constexpr int MMA_MIN_COLS = 8;  // b columns below which the FFMA body runs
constexpr int WM = 32;           // warp tile rows
constexpr int WN = 32;           // warp tile columns
constexpr int MT = WM / 16;      // mma tiles down a warp tile
constexpr int NTL = WN / 8;      // mma tiles across a warp tile
constexpr float LO_SCALE = 2048.f;          // 2^11
constexpr float LO_UNSCALE = 1.f / 2048.f;  // 2^-11

struct MmaGeo {
  static constexpr int G = 16;      // j0 rows a stage
  static constexpr int KB = 64;     // a columns a stage
  static constexpr int S = KB / 8;  // k-slices a stage
  static constexpr int A_ROWS = BM + G - 1;
  static constexpr int A_PITCH = KB + 4;  // window rows 4 banks apart
  static constexpr int B_PITCH = KB + BN;  // KB + BN - 1 words in use
  static constexpr int A_PLANE = A_ROWS * A_PITCH;
  static constexpr int B_PLANE = G * B_PITCH;
  static constexpr int A_RAW = A_ROWS * KB;
  // two planes of each operand, and the next stage's words as they come
  static constexpr size_t SMEM =
      sizeof(float) * (2 * (A_PLANE + B_PLANE) + A_RAW + B_PLANE);
  static_assert(KB % 32 == 0, "a lane stages KB / 32 words of a row");
};

__device__ __forceinline__ uint32_t tf32_rn(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + 2^-11 lo to 2^-22 relative, both representable in TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rn(x);
  lo = tf32_rn((x - __uint_as_float(hi)) * LO_SCALE);
}

// d += A (16x8, row-major fragment a[4]) * B (8x8, column fragment b0, b1)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One unit: the tile at (K0, K1) summed over j0 in [j0_lo, j0_hi) and j1
// in [j1_lo, j1_hi) (both nonempty and inside b).  ``to_slot``: ``out`` is
// a dense BM x BN workspace tile, written whole; otherwise it is c
// (row-major c0 x c1), written where k < (c0, c1).  ``smem`` holds
// MmaGeo::SMEM bytes.
template <Order ORDER>
__device__ __forceinline__ void mma_unit(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ out, bool to_slot, int a0, int a1, int b1, int c0,
    int c1, int K0, int K1, int j0_lo, int j0_hi, int j1_lo, int j1_hi,
    float* __restrict__ smem) {
  using L = MmaGeo;
  constexpr int G = L::G;
  constexpr int KB = L::KB;
  constexpr int S = L::S;
  // k-slices a chain: all of one j0 (K4a), or half of them for the two j0
  // of one class (K4b): eight mma steps either way
  constexpr int CHAIN = ORDER == ASCENDING ? S : S / 2;
  constexpr int A_PITCH = L::A_PITCH;
  constexpr int B_PITCH = L::B_PITCH;
  uint32_t* sAh = reinterpret_cast<uint32_t*>(smem);
  uint32_t* sAl = sAh + L::A_PLANE;
  uint32_t* sBh = sAl + L::A_PLANE;
  uint32_t* sBl = sBh + L::B_PLANE;
  float* rawA = reinterpret_cast<float*>(sBl + L::B_PLANE);
  float* rawB = rawA + L::A_RAW;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // the fragment layouts' group and
  const int t = lane % 4;  // thread in group
  const int mb = (warp / 2) * WM;  // the warp's rows mb .. mb + 31
  const int nb = (warp % 2) * WN;  // and columns nb .. nb + 31

  // a's columns whose band meets the unit's j1 range
  const int i1_lo = max(0, K1 - j1_hi + 1);
  const int i1_hi = min(a1, K1 + BN - j1_lo);
  const int n_blocks = (i1_hi - i1_lo + KB - 1) / KB;
  const int n_stages = (j0_hi - j0_lo + G - 1) / G * n_blocks;
  // the j0 at which the warp's window rows K0 + mb + (0..31) - j0 meet
  // [0, a0)
  const int w_lo = max(j0_lo, K0 + mb - a0 + 1);
  const int w_hi = min(j0_hi, K0 + mb + WM);

  // cp.async of the stage (j0 group at g0, a's columns from i1_0) into
  // the raw buffers, zero where a or the unit's part of b ends.
  // Window row r, word k: a[K0 - (g0 + G - 1) + r][i1_0 + k]; j0 = g0 + dj
  // and tile row m read window row m - dj + G - 1, so a group of fewer
  // than G rows (a unit's last) leaves its first window rows unstaged.
  // b row dj, word x: b[g0 + dj][K1 - i1_0 - KB + 1 + x]; T[k, n] of the
  // k-slice at kk is word n - kk - k + KB - 1.
  auto issue = [&](int g0, int i1_0) {
    const int n_dj = min(G, j0_hi - g0);
    const int row0 = K0 - (g0 + G - 1);
    for (int r = G - n_dj + warp; r < L::A_ROWS; r += NT / 32) {
      const int ar = row0 + r;
      const bool row_ok = ar >= 0 && ar < a0;
      const float* arow = a + static_cast<size_t>(row_ok ? ar : 0) * a1;
#pragma unroll
      for (int k = lane; k < KB; k += 32) {
        const bool ok = row_ok && i1_0 + k < a1;
        copy_async<4>(rawA + r * KB + k, ok ? arow + i1_0 + k : a, ok);
      }
    }
    const int col0 = K1 - i1_0 - KB + 1;
    for (int e = tid; e < n_dj * B_PITCH; e += NT) {
      const int dj = e / B_PITCH;
      const int j1 = col0 + e - dj * B_PITCH;
      const bool ok = j1 >= j1_lo && j1 < j1_hi;
      copy_async<4>(rawB + e,
                    ok ? b + static_cast<size_t>(g0 + dj) * b1 + j1 : b, ok);
    }
    commit_group();
  };

  float acc[MT][NTL][4];
  float grp[MT][NTL][4];
  float hh[MT][NTL][4];
  float cr[MT][NTL][4];
#pragma unroll
  for (int M = 0; M < MT; ++M)
#pragma unroll
    for (int N = 0; N < NTL; ++N)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[M][N][i] = 0.f;
        grp[M][N][i] = 0.f;
        hh[M][N][i] = 0.f;
        cr[M][N][i] = 0.f;
      }

  // chain end: grp += hh + 2^-11 cr, and the chain starts again from zero
  auto flush = [&]() {
#pragma unroll
    for (int M = 0; M < MT; ++M)
#pragma unroll
      for (int N = 0; N < NTL; ++N)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          grp[M][N][i] += fmaf(cr[M][N][i], LO_UNSCALE, hh[M][N][i]);
          cr[M][N][i] = 0.f;
          hh[M][N][i] = 0.f;
        }
  };

  // B fragments of the k-slice at kk, row dj: T[t][g], T[t + 4][g] of
  // every 8-column tile, both planes; then the 24 mma of the slice
  auto slice = [&](int dj, int kk, const uint32_t (&ah)[MT][4],
                   const uint32_t (&al)[MT][4]) {
    const int x = dj * B_PITCH + nb + g - kk - t + KB - 1;
    uint32_t bh[NTL][2];
    uint32_t bl[NTL][2];
#pragma unroll
    for (int N = 0; N < NTL; ++N) {
      bh[N][0] = sBh[x + 8 * N];
      bh[N][1] = sBh[x + 8 * N - 4];
      bl[N][0] = sBl[x + 8 * N];
      bl[N][1] = sBl[x + 8 * N - 4];
    }
#pragma unroll
    for (int M = 0; M < MT; ++M)
#pragma unroll
      for (int N = 0; N < NTL; ++N) {
        mma_tf32(hh[M][N], ah[M], bh[N][0], bh[N][1]);
        mma_tf32(cr[M][N], ah[M], bl[N][0], bl[N][1]);
        mma_tf32(cr[M][N], al[M], bh[N][0], bh[N][1]);
      }
  };

  // K4a: the k-slice at kk of j0 = g0 + dj, A fragments loaded.  Fragment
  // of mma tile M: rows g, g + 8, columns t, t + 4 of its 16 x 8.
  auto ascending_slice = [&](int dj, int kk) {
    const int w = (mb + g - dj + G - 1) * A_PITCH + kk + t;
    uint32_t ah[MT][4];
    uint32_t al[MT][4];
#pragma unroll
    for (int M = 0; M < MT; ++M) {
      const int wm = w + 16 * M * A_PITCH;
      ah[M][0] = sAh[wm];
      ah[M][1] = sAh[wm + 8 * A_PITCH];
      ah[M][2] = sAh[wm + 4];
      ah[M][3] = sAh[wm + 8 * A_PITCH + 4];
      al[M][0] = sAl[wm];
      al[M][1] = sAl[wm + 8 * A_PITCH];
      al[M][2] = sAl[wm + 4];
      al[M][3] = sAl[wm + 8 * A_PITCH + 4];
    }
    slice(dj, kk, ah, al);
  };

  // K4b: the k-slice at kk of every j0 = g0 + r + 8 q of class r that lies
  // in the warp's [dj_lo, dj_hi) (``all``: every one does, no check).
  // Halves h = 0 .. 2 MT - 1 of the warp's rows: rows mb + 8 h + g of the
  // tile, columns t and t + 4.
  auto residue_slice = [&](int r, int kk, int dj_lo, int dj_hi, auto all) {
    const int w = (mb + g - r + G - 1) * A_PITCH + kk + t;
    uint32_t hi[2 * MT][2];
    uint32_t lo[2 * MT][2];
#pragma unroll
    for (int h = 0; h < 2 * MT; ++h) {
      hi[h][0] = sAh[w + 8 * h * A_PITCH];
      hi[h][1] = sAh[w + 8 * h * A_PITCH + 4];
      lo[h][0] = sAl[w + 8 * h * A_PITCH];
      lo[h][1] = sAl[w + 8 * h * A_PITCH + 4];
    }
#pragma unroll
    for (int q = 0; q < G / 8; ++q) {
      const int dj = r + 8 * q;
      if (q > 0) {
        // the window has moved down 8 rows: half h is the old half h - 1,
        // and the top half is loaded
#pragma unroll
        for (int h = 2 * MT - 1; h > 0; --h) {
          hi[h][0] = hi[h - 1][0];
          hi[h][1] = hi[h - 1][1];
          lo[h][0] = lo[h - 1][0];
          lo[h][1] = lo[h - 1][1];
        }
        const int wq = w - 8 * q * A_PITCH;
        hi[0][0] = sAh[wq];
        hi[0][1] = sAh[wq + 4];
        lo[0][0] = sAl[wq];
        lo[0][1] = sAl[wq + 4];
      }
      if constexpr (!decltype(all)::value)
        if (dj < dj_lo || dj >= dj_hi) continue;  // uniform over the warp
      uint32_t ah[MT][4];
      uint32_t al[MT][4];
#pragma unroll
      for (int M = 0; M < MT; ++M) {
        ah[M][0] = hi[2 * M][0];
        ah[M][1] = hi[2 * M + 1][0];
        ah[M][2] = hi[2 * M][1];
        ah[M][3] = hi[2 * M + 1][1];
        al[M][0] = lo[2 * M][0];
        al[M][1] = lo[2 * M + 1][0];
        al[M][2] = lo[2 * M][1];
        al[M][3] = lo[2 * M + 1][1];
      }
      slice(dj, kk, ah, al);
    }
  };

  // stages: j0 groups outer, a's column blocks inner
  int next_g0 = j0_lo;
  int next_ib = 0;
  auto issue_next = [&]() {
    issue(next_g0, i1_lo + next_ib * KB);
    if (++next_ib == n_blocks) {
      next_ib = 0;
      next_g0 += G;
    }
  };

  issue_next();
  int g0 = j0_lo;
  int ib = 0;
  for (int stage = 0; stage < n_stages; ++stage) {
    const int i1_0 = i1_lo + ib * KB;
    const int n_dj = min(G, j0_hi - g0);
    wait_group<0>();
    // this stage's words have landed, and every thread has read the
    // planes of the one before
    __syncthreads();
    for (int e = (G - n_dj) * KB + tid; e < L::A_RAW; e += NT) {
      const int w = e / KB * A_PITCH + e % KB;
      uint32_t hi, lo;
      split_tf32(rawA[e], hi, lo);
      sAh[w] = hi;
      sAl[w] = lo;
    }
    for (int e = tid; e < n_dj * B_PITCH; e += NT) {
      uint32_t hi, lo;
      split_tf32(rawB[e], hi, lo);
      sBh[e] = hi;
      sBl[e] = lo;
    }
    __syncthreads();  // the planes are whole, the raw buffers free
    if (stage + 1 < n_stages) issue_next();  // in flight under the products

    // the warp's j0 of this group, and the k-slices [ks_lo, ks_hi) whose
    // band K1 + n - (i1_0 + kk + k) meets the unit's j1 range for some of
    // the warp's columns (>> 3 floors)
    const int dj_lo = max(0, w_lo - g0);
    const int dj_hi = min(G, w_hi - g0);
    const int ks_lo = max(0, ((K1 + nb - 7 - i1_0 - j1_hi) >> 3) + 1);
    const int ks_hi = min(S, ((K1 + nb + WN - 1 - i1_0 - j1_lo) >> 3) + 1);
    if (dj_lo < dj_hi && ks_lo < ks_hi) {
      const bool whole = ks_lo == 0 && ks_hi == S;
      if constexpr (ORDER == ASCENDING) {
        if (whole) {  // no branch between the slices of a chain
          for (int dj = dj_lo; dj < dj_hi; ++dj) {
#pragma unroll
            for (int ks = 0; ks < S; ++ks) ascending_slice(dj, 8 * ks);
            flush();
          }
        } else {
          for (int dj = dj_lo; dj < dj_hi; ++dj) {
#pragma unroll 1
            for (int ks = ks_lo; ks < ks_hi; ++ks) ascending_slice(dj, 8 * ks);
            flush();
          }
        }
      } else {
        for (int r = 0; r < 8; ++r) {
          // the class has a j0 of the warp's range in this stage
          if (r + (dj_lo - r + 7) / 8 * 8 >= dj_hi) continue;
          if (whole && dj_lo == 0 && dj_hi == G) {  // no branch in a chain
#pragma unroll 1
            for (int k0 = 0; k0 < KB; k0 += 8 * CHAIN) {
#pragma unroll
              for (int ks = 0; ks < CHAIN; ++ks)
                residue_slice(r, k0 + 8 * ks, 0, G, std::true_type{});
              flush();
            }
          } else {
#pragma unroll 1
            for (int ks = ks_lo; ks < ks_hi; ++ks) {
              residue_slice(r, 8 * ks, dj_lo, dj_hi, std::false_type{});
              if (ks % CHAIN == CHAIN - 1 || ks == ks_hi - 1) flush();
            }
          }
        }
      }
      // a stage ends a group
#pragma unroll
      for (int M = 0; M < MT; ++M)
#pragma unroll
        for (int N = 0; N < NTL; ++N)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[M][N][i] += grp[M][N][i];
            grp[M][N][i] = 0.f;
          }
    }
    if (++ib == n_blocks) {
      ib = 0;
      g0 += G;
    }
  }

  // accumulator i of mma tile (M, N): row g (+ 8 for i >= 2), column
  // 2 t + (i & 1)
#pragma unroll
  for (int M = 0; M < MT; ++M)
#pragma unroll
    for (int N = 0; N < NTL; ++N)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = mb + 16 * M + g + 8 * half;
        const int n = nb + 8 * N + 2 * t;
        const float x = acc[M][N][2 * half];
        const float y = acc[M][N][2 * half + 1];
        if (to_slot) {
          *reinterpret_cast<float2*>(out + m * BN + n) = make_float2(x, y);
        } else if (K0 + m < c0) {
          float* row = out + static_cast<size_t>(K0 + m) * c1 + K1 + n;
          if (K1 + n < c1) row[0] = x;
          if (K1 + n + 1 < c1) row[1] = y;
        }
      }
}

// The unit table's row u, as conv2d_unit.cuh::run_unit reads it.
template <Order ORDER>
__device__ __forceinline__ void run_mma_unit(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ c, float* __restrict__ work,
    const int4* __restrict__ units, int u, int a0, int a1, int b1, int c0,
    int c1, float* __restrict__ smem) {
  const int4 p = units[2 * u];
  const int4 q = units[2 * u + 1];
  const bool to_slot = q.z >= 0;
  float* out = to_slot ? work + static_cast<size_t>(q.z) * TILE_WORDS : c;
  mma_unit<ORDER>(a, b, out, to_slot, a0, a1, b1, c0, c1, p.x, p.y, p.z,
                  p.w, q.x, q.y, smem);
}

}  // namespace
