// Device code of the truncated 2-D product kernels K2 (single pair,
// conv2d_trunc_f32.cu) and K3 (batched, conv2d_trunc_f32_batched.cu) on
// Hopper (sm_90a): one *work unit* of
//
//     c[k0, k1] = sum_{j0, j1} a[k0 - j0, k1 - j1] * b[j0, j1]
//
// in IEEE f32 with FMA, and the pass that adds the units of one output
// tile.  A unit is (64x64 output tile at (K0, K1), j0 range, j1 range);
// the table of units comes from ops/conv2d.py::unit_plan, which clips the
// ranges to where a and b are nonzero and cuts them to about equal
// multiply-add counts.  Replaces, with those two files, the TPU kernels
// genfer_tpu/ops/pallas_conv2d.py::_build2d_rowstrip and ::_build2d_batched.
//
// What bounds it on the H100: issued f32 FMAs.  An SM issues one warp
// instruction per scheduler per clock, and an FMA is one, so every load,
// address or add in the inner loop is an FMA not issued; shared memory
// delivers 128 B/clk against 128 FMA/clk.  The design therefore spends
// registers to keep both far below the FMA count:
//
//   * thread map: 128 threads, thread (ty, tx) owns TM = 4 contiguous rows
//     4 ty .. 4 ty + 3 and TN = 8 contiguous columns 8 tx .. 8 tx + 7.
//   * the loop runs over the *stream* s = j0 - i (i the thread's row):
//     row i at j0 = s + i reads a row K0 + 4 ty - s for every i, so one
//     window row, loaded once into registers (TN + CJ - 1 = 39 words as
//     ten 16-byte LDS for CJ = 32), serves TM successive j0, each with a
//     CJ-wide b row (eight broadcast 16-byte LDS): 42 loads for 1024
//     FMAs, 0.07 shared-memory bytes moved per FMA per thread.  The j1
//     slide is a static register index in the unrolled loop, not a move.
//   * banks: a 16-byte load is served a quarter warp (8 lanes) at a time,
//     conflict-free when the 8 lanes cover 8 distinct 16-byte bank groups.
//     Lanes 0-7 of a quarter share ty (one window row) and have tx 0..7,
//     so load k reads words 8 tx + 4 k: groups (2 tx + k) mod 8, only four
//     distinct values.  The window is therefore stored with the two
//     16-byte halves of every 8-word group swapped inside odd 32-word
//     blocks (word w lives at w ^ 4 where bit 5 of w is set): lanes whose
//     word falls in an odd block change the parity of their group, so
//     even-block lanes keep parity k and odd-block lanes take the other
//     one; lanes of one parity are 2 to 14 groups apart, never 8, so the 8
//     lanes cover all 8 groups.  Rows need no padding: two rows are never
//     read by one quarter warp.
//     The b loads are broadcasts (all lanes one address).
//   * staging: per (CJ-wide j1 chunk, G = 24 stream steps) the a window
//     (84 rows x 96 words) and the b block go to shared memory with
//     cp.async (16-byte where a's rows are 16-byte aligned, 4-byte
//     otherwise and for b; out-of-range parts zero-filled by a source size
//     of 0), into two stages: stage k + 1 is in flight while stage k is
//     computed.  A warp stages one row at a time, so the row's bounds and
//     address are computed once a row and no staged word costs a divide;
//     a unit's last, shorter stage leaves the rows it will not read.
//   * the window's column origin is K1 - jb - SH with SH = CJ - 1 rounded
//     up to 4 and jb a multiple of 4, so a 16-byte chunk is wholly inside
//     or wholly outside a's row; b is masked to the unit's exact ranges,
//     which is what makes units disjoint.
//   * a warp (16 output rows) skips the stream steps at which its window
//     rows lie wholly outside a: on diagonal tiles that removes part of
//     the zero triangle the tile-level clipping leaves.
//   * sums at three levels: FMAs run into `grp` for FL = 8 stream steps
//     (8 x CJ terms), `grp` is added to `acc` (one addition per 8 steps
//     and chunk of the unit), and a tile's units are added in slot order
//     by sum_units.  One running f32 sum over order^2 terms would drift
//     to ~1e-5.
//   * CJ = 1 serves a one-column b (thin operands issue no FMA on
//     padding); the wrapper passes the smaller operand as b.  Its units
//     are few and bound by latency, so its step has no branch (b is
//     staged as zero outside the unit) and its stages hold 64 steps.
//   * 142-143 registers under __launch_bounds__(128, 3) and 71 KB of
//     dynamic shared memory: three blocks, twelve warps, an SM.
//
// The tensor-core kernels (conv2d_mma.cuh) run this body where their b is
// too thin for an mma tile; in their one-pass mode with TF32 set, which
// rounds every operand word to TF32 as it leaves shared memory.  K2, K3
// and the slot sum leave TF32 off and compile as they did without it.
//
// K2 and K3 run this same code on the same per-pair table, so a batch
// entry equals the single pair bit for bit, and the result depends on
// neither the SM count nor the order in which blocks run.  The compiled
// step is 1024 FFMA and 42 LDS.128 (cuobjdump -sass); what it
// reaches of the card's FMA rate is in PERF.md.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BM = 64;        // output tile rows
constexpr int BN = 64;        // output tile columns
constexpr int TM = 4;         // contiguous rows per thread
constexpr int TN = 8;         // contiguous columns per thread
constexpr int TY = BM / TM;   // 16 thread rows
constexpr int TX = BN / TN;   // 8 thread columns
constexpr int NT = TX * TY;   // 128 threads
constexpr int FL = 8;         // stream steps between flushes of grp
constexpr int STAGES = 2;
constexpr int TILE_WORDS = BM * BN;

// the j0 order inside a stage of the tensor-core bodies (conv2d_mma.cuh,
// conv2d_wgmma.cuh): ascending (K4a, the tile kernel), or residue-major,
// dj mod 8 outer (K4b, the grouped kernel)
enum Order { ASCENDING, RESIDUE };

template <int CJ>
struct Geo {
  // stream steps per stage: 24 keeps two CJ = 32 stages at 71 KB, so
  // three blocks share an SM; a one-column b has small stages and few,
  // latency-bound units, which 64 steps cover in one or two stages
  static constexpr int G = CJ == 1 ? 64 : 24;
  static constexpr int ROWS = TM * (TY - 1) + G;  // a-window rows
  static constexpr int BROWS = G + TM - 1;        // b rows
  static constexpr int SH = (CJ + 2) / 4 * 4;  // CJ - 1 rounded up to 4
  static constexpr int WW = BN + SH;           // window words in use
  static constexpr int NV = (TN + SH) / 4;     // 16-byte loads per row
  static constexpr int BP = CJ;                // b row pitch
  static constexpr int A_WORDS = ROWS * WW;
  // the next stage starts 16-byte aligned
  static constexpr int STAGE_WORDS = A_WORDS + (BROWS * BP + 3) / 4 * 4;
  static constexpr size_t SMEM = sizeof(float) * STAGES * STAGE_WORDS;
};

// where window word w is stored in its row
__device__ __forceinline__ int swizzle(int w) { return w ^ ((w >> 3) & 4); }

// cp.async of BYTES (4, 8 or 16) from global to shared; zero-fills when
// !ok
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? BYTES : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(BYTES), "r"(n)
               : "memory");
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 (10 stored mantissa bits, to nearest, ties away from
// zero: cvt.rna) as an f32 word, its 13 low bits cleared
__device__ __forceinline__ float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

// One unit: the tile at (K0, K1) summed over j0 in [j0_lo, j0_hi) and j1
// in [j1_lo, j1_hi) (both nonempty and inside b).  ``to_slot``: ``out`` is
// a dense BM x BN workspace tile, written whole; otherwise it is c
// (row-major c0 x c1), written where k < (c0, c1).  VEC: a is 16-byte
// aligned and a1 a multiple of 4.  ``smem`` holds Geo<CJ>::SMEM bytes.
// TF32: every operand word is rounded to TF32 (cvt.rna, the low 13 bits
// cleared) as it leaves shared memory, so that each FMA adds the exact
// product of two TF32 values: the one-pass mode of the tensor-core
// kernels (conv2d_mma.cuh) on a b too thin for an mma tile.
template <int CJ, bool VEC, bool TF32 = false>
__device__ __forceinline__ void product_unit(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ out, bool to_slot, int a0, int a1, int b1, int c0,
    int c1, int K0, int K1, int j0_lo, int j0_hi, int j1_lo, int j1_hi,
    float* __restrict__ smem) {
  using L = Geo<CJ>;
  constexpr int G = L::G;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // stream steps s = j0 - i, i < TM; this warp's window rows K0 + 4 ty - s
  // (ty in 4 warp .. 4 warp + 3) meet [0, a0) only for s in [ws_lo, ws_hi)
  const int s_lo = j0_lo - (TM - 1);
  const int ws_lo = max(s_lo, K0 + 4 * TM * warp - a0 + 1);
  const int ws_hi = min(j0_hi, K0 + 4 * TM * warp + 3 * TM + 1);
  const int jbase = j1_lo & ~3;
  const int n_sblocks = (j0_hi - s_lo + G - 1) / G;
  const int n_chunks = (j1_hi - jbase + CJ - 1) / CJ;
  const int n_stages = n_sblocks * n_chunks;

  int off[L::NV];
#pragma unroll
  for (int k = 0; k < L::NV; ++k) off[k] = swizzle(TN * tx + 4 * k);

  // stage the a window and the b block of (chunk at jb, stream block at
  // s0) into buffer ``buf``
  auto issue = [&](int buf, int jb, int s0) {
    float* sA = smem + buf * L::STAGE_WORDS;
    float* sB = sA + L::A_WORDS;
    // window row r, word w holds a[K0 - (s0 + G - 1) + r][K1 - jb - SH + w];
    // step s0 + ds reads rows TM ty + G - 1 - ds, so a stage of fewer than
    // G steps (a unit's last) leaves its first rows unread and unstaged
    const int row0 = K0 - (s0 + G - 1);
    const int col0 = K1 - jb - L::SH;
    constexpr int CH = VEC ? L::WW / 4 : L::WW;  // copies per window row
    // a warp stages a row at a time: the row's checks and address are
    // uniform over the warp, a lane's copies 32 apart
    for (int r = max(0, G - (j0_hi - s0)) + warp; r < L::ROWS; r += NT / 32) {
      const int ar = row0 + r;
      const bool row_ok = ar >= 0 && ar < a0;
      const float* arow = a + static_cast<size_t>(row_ok ? ar : 0) * a1;
      float* srow = sA + r * L::WW;
#pragma unroll
      for (int ch = lane; ch < CH; ch += 32) {
        const int w = VEC ? 4 * ch : ch;
        const int ac = col0 + w;
        const bool ok = row_ok && ac >= 0 && ac < a1;
        copy_async<VEC ? 16 : 4>(srow + swizzle(w), ok ? arow + ac : a, ok);
      }
    }
    // b row tt, word jj holds b[s0 + tt][jb + jj], masked to the unit
    for (int e = tid; e < L::BROWS * CJ; e += NT) {
      const int tt = e / CJ;
      const int jj = e - tt * CJ;
      const int t = s0 + tt;
      const int j1 = jb + jj;
      const bool ok = t >= j0_lo && t < j0_hi && j1 >= j1_lo && j1 < j1_hi;
      const float* src = ok ? b + static_cast<size_t>(t) * b1 + j1 : b;
      copy_async<4>(sB + tt * L::BP + jj, src, ok);
    }
    commit_group();
  };

  float acc[TM][TN];
  float grp[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      acc[i][q] = 0.f;
      grp[i][q] = 0.f;
    }

  // the stage being issued: chunk-major, stream blocks inner
  int issue_jb = jbase;
  int issue_sb = 0;
  auto issue_next = [&](int buf) {
    issue(buf, issue_jb, s_lo + issue_sb * G);
    if (++issue_sb == n_sblocks) {
      issue_sb = 0;
      issue_jb += CJ;
    }
  };

  issue_next(0);
  int sb = 0;
  for (int k = 0; k < n_stages; ++k) {
    if (k + 1 < n_stages) {
      issue_next((k + 1) & 1);
      wait_group<1>();
    } else {
      wait_group<0>();
    }
    __syncthreads();  // stage k has landed for every thread

    const float* sA = smem + (k & 1) * L::STAGE_WORDS;
    const float* sB = sA + L::A_WORDS;
    const int s0 = s_lo + sb * G;
    const int ds_lo = max(0, ws_lo - s0);
    const int ds_hi = min(G, ws_hi - s0);
    for (int ds = ds_lo; ds < ds_hi; ++ds) {
      const float* wrow = sA + (TM * ty + G - 1 - ds) * L::WW;
      float win[4 * L::NV];
#pragma unroll
      for (int v = 0; v < L::NV; ++v) {
        const float4 x = *reinterpret_cast<const float4*>(wrow + off[v]);
        win[4 * v] = x.x;
        win[4 * v + 1] = x.y;
        win[4 * v + 2] = x.z;
        win[4 * v + 3] = x.w;
      }
      if constexpr (TF32) {
#pragma unroll
        for (int w = 0; w < 4 * L::NV; ++w) win[w] = tf32_round(win[w]);
      }
      if constexpr (CJ == 1) {
        // one b value per row, zero outside the unit's j0 range: no
        // branch, so the four loads issue with the window's
        float bv[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) bv[i] = sB[ds + i];
        if constexpr (TF32) {
#pragma unroll
          for (int i = 0; i < TM; ++i) bv[i] = tf32_round(bv[i]);
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int q = 0; q < TN; ++q)
            grp[i][q] = fmaf(win[q], bv[i], grp[i][q]);
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int t = s0 + ds + i;
          if (t < j0_lo || t >= j0_hi) continue;  // uniform over the block
          const float* brow = sB + (ds + i) * L::BP;
          float bv[CJ];
#pragma unroll
          for (int v = 0; v < CJ / 4; ++v) {
            const float4 x = *reinterpret_cast<const float4*>(brow + 4 * v);
            bv[4 * v] = x.x;
            bv[4 * v + 1] = x.y;
            bv[4 * v + 2] = x.z;
            bv[4 * v + 3] = x.w;
          }
          if constexpr (TF32) {
#pragma unroll
            for (int jj = 0; jj < CJ; ++jj) bv[jj] = tf32_round(bv[jj]);
          }
          // output column 8 tx + q at chunk offset jj reads window word
          // 8 tx + q + SH - jj
#pragma unroll
          for (int jj = 0; jj < CJ; ++jj)
#pragma unroll
            for (int q = 0; q < TN; ++q)
              grp[i][q] = fmaf(win[q + L::SH - jj], bv[jj], grp[i][q]);
        }
      }
      if ((ds & (FL - 1)) == FL - 1) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int q = 0; q < TN; ++q) {
            acc[i][q] += grp[i][q];
            grp[i][q] = 0.f;
          }
      }
    }
    // a stage ends a group whatever its last step was
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int q = 0; q < TN; ++q) {
        acc[i][q] += grp[i][q];
        grp[i][q] = 0.f;
      }
    if (++sb == n_sblocks) sb = 0;
    __syncthreads();  // every thread has read stage k: its buffer is free
  }

  if (to_slot) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float4* row =
          reinterpret_cast<float4*>(out + (TM * ty + i) * BN + TN * tx);
      row[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      row[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int k0 = K0 + TM * ty + i;
      if (k0 >= c0) continue;
#pragma unroll
      for (int q = 0; q < TN; ++q) {
        const int k1 = K1 + TN * tx + q;
        if (k1 < c1) out[static_cast<size_t>(k0) * c1 + k1] = acc[i][q];
      }
    }
  }
}

// The unit table's row u (two int4): K0, K1, j0_lo, j0_hi | j1_lo, j1_hi,
// slot (-1: the unit writes c), 0.  ``c`` and ``work`` are those of the
// unit's batch entry.
template <int CJ, bool VEC, bool TF32 = false>
__device__ __forceinline__ void run_unit(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ c, float* __restrict__ work,
    const int4* __restrict__ units, int u, int a0, int a1, int b1, int c0,
    int c1, float* __restrict__ smem) {
  const int4 p = units[2 * u];
  const int4 q = units[2 * u + 1];
  const bool to_slot = q.z >= 0;
  float* out = to_slot ? work + static_cast<size_t>(q.z) * TILE_WORDS : c;
  product_unit<CJ, VEC, TF32>(a, b, out, to_slot, a0, a1, b1, c0, c1, p.x,
                              p.y, p.z, p.w, q.x, q.y, smem);
}

// One block per (batch entry g, tile of several units m, quarter of the
// tile): the tile's slots added in slot order, 4 outputs a thread.  sums
// row m: K0, K1, first slot, slots.  T is float (K2-K6) or double (K1).
// c holds the window [w0, c0) x [w1, c1) of each entry's output (c1 - w1
// words a row; K1's row window, w0 = w1 = 0 elsewhere).
constexpr int SUM_NT = TILE_WORDS / 16;  // threads of a quarter tile

// the four consecutive words at p (16-byte aligned), in one or two loads
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void load4(const double* p, double (&x)[4]) {
  const double2 v = reinterpret_cast<const double2*>(p)[0];
  const double2 w = reinterpret_cast<const double2*>(p)[1];
  x[0] = v.x;
  x[1] = v.y;
  x[2] = w.x;
  x[3] = w.y;
}

template <typename T>
__global__ void __launch_bounds__(SUM_NT)
sum_units_kernel(const T* __restrict__ work, T* __restrict__ c,
                 const int4* __restrict__ sums, int n_sums, int slots,
                 int c0, int c1, int w0, int w1) {
  const int quarter = blockIdx.x % 4;
  const int m = blockIdx.x / 4 % n_sums;
  const int g = blockIdx.x / 4 / n_sums;
  const int4 s = sums[m];
  const int e = 4 * (quarter * SUM_NT + threadIdx.x);
  const T* part =
      work + (static_cast<size_t>(g) * slots + s.z) * TILE_WORDS + e;
  T sum[4] = {0, 0, 0, 0};
  // slot order, with 16 loads in flight: a thread's loads are its latency
#pragma unroll 16
  for (int z = 0; z < s.w; ++z) {
    T x[4];
    load4(part + z * TILE_WORDS, x);
#pragma unroll
    for (int i = 0; i < 4; ++i) sum[i] += x[i];
  }
  const int k0 = s.x + e / BN;
  const int k1 = s.y + e % BN;
  if (k0 < w0 || k0 >= c0) return;
  T* out = c + (static_cast<size_t>(g) * (c0 - w0) + k0 - w0) * (c1 - w1);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (k1 + i >= w1 && k1 + i < c1) out[k1 + i - w1] = sum[i];
}

// whether 16-byte cp.async may read rows of an array at ``p``
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Allow ``kernel`` ``bytes`` of dynamic shared memory (above the 48 KB
// default), once per device: ``done`` is the kernel's own flag array.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64 || !done[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < 64) done[dev] = true;
  }
  return cudaSuccess;
}

template <typename T>
inline cudaError_t sum_units(const T* work, T* c, const int4* sums,
                             int n_sums, int slots, int batch, int c0,
                             int c1, cudaStream_t stream, int w0 = 0,
                             int w1 = 0) {
  sum_units_kernel<T><<<4u * n_sums * batch, SUM_NT, 0, stream>>>(
      work, c, sums, n_sums, slots, c0, c1, w0, w1);
  return cudaGetLastError();
}

}  // namespace
