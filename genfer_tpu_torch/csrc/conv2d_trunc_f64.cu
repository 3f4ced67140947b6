// Truncated 2-D Cauchy products in IEEE f64 on Hopper's FP64 tensor cores
// (sm_90a), K1: for every batch entry g,
//
//     c[g, k0, k1] = sum_{j0, j1} a_g[k0 - j0, k1 - j1] * b_g[j0, j1]
//
// with a_g = a + g * a_stride and b_g = b + g * b_stride (a single pair is
// a batch of one).  Replaces the f64 2-axis product of genfer_tpu's
// JaxF64Backend, which ran in XLA, not in Pallas:
// genfer_tpu/taylor/backend.py::_conv_dense (its 2-axis branch, a Toeplitz
// tensor [c0, b0, a1] contracted into [c0, a1, b1] and an anti-diagonal
// sum) with its truncation staircase _conv_dense_2d_blocked; its >= 3-axis
// products batch every (i0, j0) pair of leading rows into one launch here.
//
// This is K1's dense body; ops/conv2d_f64.py::k1_route sends a product
// whose smaller operand holds at most SMALL_MAX_COEFFS coefficients to the
// small body (conv2d_small_f64.cu) instead, and runs this body on the
// transposed operands, c^T = K1(a^T, b^T), where that plan issues fewer
// multiply-adds: a thin, tall operand is then contracted along its long
// axis.
//
// The work units are those of K4a (ops/conv2d.py::unit_plan with
// cut_j1=False): (64x64 output tile at (K0, K1), j0 range, j1 range), the
// ranges clipped to where a and b are nonzero, which plays the part of
// the staircase.  For each j0 of a unit and each 8-wide slice of a's
// columns starting at i1:
//
//     C[m, n] += A[m, k] * T[k, n]
//     A[m, k] = a[K0 + m - j0, i1 + k]
//     T[k, n] = b[j0, K1 + n - (i1 + k)]     (zero outside the unit's j1)
//
// as mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64.  T is never built: a
// thread reads its B-fragment values from the staged b row at offset
// n - k, as conv2d_mma.cuh does for TF32.  Native f64 needs one pass and
// no split.
//
// What bounds it on the H100: FP64 tensor-core multiply-adds (67 TFLOP/s
// on the data sheet, 33.5e12 multiply-adds a second), which m16n8k8
// reaches and Ampere's m8n8k4 reaches half of (tune_port.py probe 9).
// Shared memory is not binding: a k-slice is 8 mma of 1024 multiply-adds
// for 16 fragment words a thread.  The design:
//
//   * register blocking: 128 threads; a warp owns 32x32 of the tile, 2 x 4
//     mma tiles of 16x8, so 32 f64 accumulators (64 registers) a thread.
//   * fragments (PTX's m16n8k8 .f64 layout, the one conv2d_mma.cuh uses
//     for TF32 with one f64 a register; tune_port.py probe 10 checks it on
//     the card), lane 4 g + t: A (row-major 16x8) a0 = A[g][t], a1 =
//     A[g + 8][t], a2 = A[g][t + 4], a3 = A[g + 8][t + 4]; B (column-major
//     8x8) b0 = T[t][g], b1 = T[t + 4][g]; C c0, c1 = C[g][2 t + i], c2, c3
//     = C[g + 8][2 t + i].  The window's row pitch is KB + 4 = 36 words (=
//     4 mod 16), so the 16 lanes of a half warp (g 0-3, t 0-3) read 16
//     distinct bank pairs; the B lanes of a half warp read 7 consecutive
//     words (g - t), equal words broadcast.
//   * staging: per (G = 16 rows of j0, KB = 32 columns of a) the window
//     (79 rows) and the b block (16 rows of KB + 63 words) come from global
//     memory (L2: the operands are a few MB) by 8-byte cp.async, zero where
//     a ends or the unit's j1 range does, into one of two stages, the next
//     in flight while this one is multiplied (4 k-slices of 8 a stage).
//     70 KB: three blocks an SM.
//   * one accumulator: f64 sums over a unit's j0 and columns (at most a few
//     hundred thousand terms at order 1024) stay far inside the f64 gate
//     without the f32 kernels' chains and flushes.
//   * determinism: each unit sums j0 ascending, then a's columns
//     ascending, in a fixed mma order; a tile's units own consecutive
//     slots, added in slot order by conv2d_unit.cuh's sum_units_kernel
//     (its f64 instance).  The result depends on the shapes alone: the same
//     bits on any card and run to run, and each batch entry equals the
//     single-pair call bit for bit.
//   * the batch goes on a one-dimensional grid over (unit, entry) pairs,
//     unit-major, as K3 does (conv2d_trunc_f32_batched.cu): every entry's
//     heavy units run before the light ones.

#include <climits>

#include "conv2d_unit.cuh"

namespace {

struct F64Geo {
  static constexpr int G = 16;       // j0 rows a stage
  static constexpr int KB = 32;      // a columns a stage
  static constexpr int S = KB / 8;   // k-slices a stage
  static constexpr int MT = 2;       // 16-row mma tiles down a warp tile
  static constexpr int NTL = 4;      // 8-column mma tiles across it
  static constexpr int A_ROWS = BM + G - 1;
  static constexpr int A_PITCH = KB + 4;
  static constexpr int B_USED = KB + BN - 1;
  static constexpr int B_PITCH = KB + BN;
  static constexpr int A_WORDS = A_ROWS * A_PITCH;
  static constexpr int STAGE_WORDS = A_WORDS + G * B_PITCH;
  static constexpr size_t SMEM = sizeof(double) * 2 * STAGE_WORDS;
  static_assert(KB == 32, "a lane stages one word of a window row");
};

// d += A (16x8, fragment a) * B (8x8, fragment b)
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// One unit: the tile at (K0, K1) summed over j0 in [j0_lo, j0_hi) and j1
// in [j1_lo, j1_hi) (both nonempty and inside b).  ``to_slot``: ``out`` is
// a dense BM x BN workspace tile, written whole; otherwise it is the
// window [w0, c0) x [w1, c1) of c (row-major, c1 - w1 words a row),
// written where w <= k < (c0, c1).  ``smem`` holds F64Geo::SMEM bytes.
__device__ __forceinline__ void f64_unit(
    const double* __restrict__ a, const double* __restrict__ b,
    double* __restrict__ out, bool to_slot, int a0, int a1, int b1, int c0,
    int c1, int w0, int w1, int K0, int K1, int j0_lo, int j0_hi, int j1_lo,
    int j1_hi, double* __restrict__ smem) {
  using L = F64Geo;
  constexpr int G = L::G;
  constexpr int KB = L::KB;
  constexpr int A_PITCH = L::A_PITCH;
  constexpr int B_PITCH = L::B_PITCH;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // the fragment layouts' group and
  const int t = lane % 4;  // thread in group
  const int mb = (warp / 2) * 32;  // the warp's rows mb .. mb + 31
  const int nb = (warp % 2) * 32;  // and columns nb .. nb + 31

  // a's columns whose band meets the unit's j1 range
  const int i1_lo = max(0, K1 - j1_hi + 1);
  const int i1_hi = min(a1, K1 + BN - j1_lo);
  const int n_blocks = (i1_hi - i1_lo + KB - 1) / KB;
  const int n_stages = (j0_hi - j0_lo + G - 1) / G * n_blocks;

  // cp.async of the stage (j0 group at g0, a's columns from i1_0) into
  // stage buffer ``buf``, zero where a or the unit's part of b ends.
  // Window row r, word k: a[K0 - (g0 + G - 1) + r][i1_0 + k]; j0 = g0 + dj
  // and tile row m read window row m - dj + G - 1, so a group of fewer
  // than G rows (a unit's last) leaves its first window rows unstaged.
  // b row dj, word x: b[g0 + dj][K1 - i1_0 - KB + 1 + x]; T[k, n] of the
  // k-slice at kk is word n - kk - k + KB - 1.
  auto issue = [&](int buf, int g0, int i1_0) {
    double* sA = smem + buf * L::STAGE_WORDS;
    double* sB = sA + L::A_WORDS;
    const int n_dj = min(G, j0_hi - g0);
    const int row0 = K0 - (g0 + G - 1);
    const bool col_ok = i1_0 + lane < a1;
    for (int r = G - n_dj + warp; r < L::A_ROWS; r += NT / 32) {
      const int ar = row0 + r;
      const bool ok = col_ok && ar >= 0 && ar < a0;
      copy_async<8>(sA + r * A_PITCH + lane,
                    ok ? a + static_cast<size_t>(ar) * a1 + i1_0 + lane : a,
                    ok);
    }
    const int col0 = K1 - i1_0 - KB + 1;
    for (int e = tid; e < n_dj * L::B_USED; e += NT) {
      const int dj = e / L::B_USED;
      const int x = e - dj * L::B_USED;
      const int j1 = col0 + x;
      const bool ok = j1 >= j1_lo && j1 < j1_hi;
      copy_async<8>(sB + dj * B_PITCH + x,
                    ok ? b + static_cast<size_t>(g0 + dj) * b1 + j1 : b, ok);
    }
    commit_group();
  };

  double acc[L::MT][L::NTL][4];
#pragma unroll
  for (int M = 0; M < L::MT; ++M)
#pragma unroll
    for (int N = 0; N < L::NTL; ++N)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[M][N][i] = 0.0;

  // stages: j0 groups outer, a's column blocks inner
  int next_g0 = j0_lo;
  int next_ib = 0;
  auto issue_next = [&](int buf) {
    issue(buf, next_g0, i1_lo + next_ib * KB);
    if (++next_ib == n_blocks) {
      next_ib = 0;
      next_g0 += G;
    }
  };

  issue_next(0);
  int g0 = j0_lo;
  int ib = 0;
  for (int stage = 0; stage < n_stages; ++stage) {
    const int buf = stage & 1;
    const int n_dj = min(G, j0_hi - g0);
    wait_group<0>();
    // this stage's words have landed, and every thread is done with the
    // buffer the next stage goes to (it held the stage before)
    __syncthreads();
    if (stage + 1 < n_stages) issue_next(buf ^ 1);  // under the products
    const double* sA = smem + buf * L::STAGE_WORDS;
    const double* sB = sA + L::A_WORDS;
    for (int dj = 0; dj < n_dj; ++dj) {
      // A[mb + 16 M + g (+ 8)][kk + t (+ 4)]: window row mb + 16 M + g
      // (+ 8) - dj + G - 1, word kk + t (+ 4);
      // T[kk + t (+ 4)][nb + 8 N + g]: b row dj, word nb + 8 N + g - kk -
      // t (- 4) + KB - 1
      const double* wa = sA + (mb + g - dj + G - 1) * A_PITCH + t;
      const double* wb = sB + dj * B_PITCH + nb + g - t + KB - 1;
#pragma unroll
      for (int ks = 0; ks < L::S; ++ks) {
        double af[L::MT][4];
        double bf[L::NTL][2];
#pragma unroll
        for (int M = 0; M < L::MT; ++M) {
          const double* p = wa + 16 * M * A_PITCH + 8 * ks;
          af[M][0] = p[0];
          af[M][1] = p[8 * A_PITCH];
          af[M][2] = p[4];
          af[M][3] = p[8 * A_PITCH + 4];
        }
#pragma unroll
        for (int N = 0; N < L::NTL; ++N) {
          bf[N][0] = wb[8 * N - 8 * ks];
          bf[N][1] = wb[8 * N - 8 * ks - 4];
        }
#pragma unroll
        for (int M = 0; M < L::MT; ++M)
#pragma unroll
          for (int N = 0; N < L::NTL; ++N) mma_f64(acc[M][N], af[M], bf[N]);
      }
    }
    if (++ib == n_blocks) {
      ib = 0;
      g0 += G;
    }
  }

  // accumulator 2 h + i of mma tile (M, N): row 8 h + g, column 2 t + i
#pragma unroll
  for (int M = 0; M < L::MT; ++M)
#pragma unroll
    for (int N = 0; N < L::NTL; ++N)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mb + 16 * M + 8 * h + g;
        const int n = nb + 8 * N + 2 * t;
        const double x0 = acc[M][N][2 * h];
        const double x1 = acc[M][N][2 * h + 1];
        const int k0 = K0 + m;
        const int k1 = K1 + n;
        if (to_slot) {
          *reinterpret_cast<double2*>(out + m * BN + n) = make_double2(x0, x1);
        } else if (k0 >= w0 && k0 < c0) {
          double* row = out + static_cast<size_t>(k0 - w0) * (c1 - w1);
          if (k1 >= w1 && k1 < c1) row[k1 - w1] = x0;
          if (k1 + 1 >= w1 && k1 + 1 < c1) row[k1 + 1 - w1] = x1;
        }
      }
}

__global__ void __launch_bounds__(NT, 3)
conv2d_trunc_f64_kernel(const double* __restrict__ a,
                        const double* __restrict__ b, double* __restrict__ c,
                        double* __restrict__ work,
                        const int4* __restrict__ units, int batch, int slots,
                        size_t a_stride, size_t b_stride, int a0, int a1,
                        int b1, int c0, int c1, int w0, int w1,
                        const int* __restrict__ flag) {
  extern __shared__ __align__(16) double smem64[];
  const int u = blockIdx.x / batch;
  const size_t g = blockIdx.x - u * batch;
  if (flag != nullptr && flag[g] == 0) return;  // the guard's predicate
  const int4 p = units[2 * u];
  const int4 q = units[2 * u + 1];
  const bool to_slot = q.z >= 0;
  double* out = to_slot ? work + (g * slots + q.z) * TILE_WORDS
                        : c + g * (c0 - w0) * (c1 - w1);
  f64_unit(a + g * a_stride, b + g * b_stride, out, to_slot, a0, a1, b1, c0,
           c1, w0, w1, p.x, p.y, p.z, p.w, q.x, q.y, smem64);
}

}  // namespace

// Launches on ``stream``; returns the first non-zero CUDA error (0 when
// every launch was accepted).  All sizes must be >= 1 and every pointer a
// contiguous array on the current device: a (batch entries a_stride
// apart) and b (b_stride apart) row-major f64, c batch * (c0 - w0) *
// (c1 - w1) f64: the window of output rows [w0, c0) and columns [w1, c1)
// of each product (0 <= w0 < c0, 0 <= w1 < c1; w0 = w1 = 0 and c0, c1 the
// output's shape for the whole product), which the units' tables may
// restrict to the tiles that meet it;
// ``units`` n_units x 8 and ``sums`` n_sums x 4 int32 as
// ops/conv2d.py::unit_plan(cut_j1=False) lays them out for one pair (16-byte
// aligned); ``work`` batch * slots tiles of 64x64 f64, ``slots`` being the
// slots one pair's table names (not read when n_sums == 0).  Output tiles
// that no unit names are left as they are.  batch * n_units must stay
// below 2^31.  ``flag`` (batch int32, or null): where given, the blocks of
// an entry whose flag is 0 return at once (the guard of ozaki_conv2d.cu),
// and that entry's slots and output are left unwritten by the units.
extern "C" int conv2d_trunc_f64_batched(
    const double* a, const double* b, double* c, double* work,
    const void* units, int n_units, const void* sums, int n_sums, int slots,
    size_t a_stride, size_t b_stride, int batch, int a0, int a1, int b1,
    int c0, int c1, int w0, int w1, const int* flag, void* stream) {
  if (static_cast<long long>(batch) * n_units > INT_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  static bool allowed[64] = {};
  cudaError_t err =
      allow_smem(conv2d_trunc_f64_kernel, F64Geo::SMEM, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv2d_trunc_f64_kernel<<<static_cast<unsigned>(n_units) * batch, NT,
                            F64Geo::SMEM, st>>>(
      a, b, c, work, static_cast<const int4*>(units), batch, slots, a_stride,
      b_stride, a0, a1, b1, c0, c1, w0, w1, flag);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_sums == 0) return static_cast<int>(err);
  return static_cast<int>(sum_units(work, c, static_cast<const int4*>(sums),
                                    n_sums, slots, batch, c0, c1, st, w0,
                                    w1));
}
