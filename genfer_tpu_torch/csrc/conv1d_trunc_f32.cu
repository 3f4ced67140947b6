// Truncated 1-D Cauchy product in IEEE f32 on Hopper (sm_90a), K6:
//
//     c[k] = sum_{j < lb} b[j] * a[k - j],   k < lc,
//
// with a read as zero outside [0, la).
//
// Replaces the TPU kernel genfer_tpu/ops/pallas_conv.py::_build (one
// program per 128-wide output tile, shift-and-accumulate over the b
// scalars read from SMEM, each sliding a window assembled from two aligned
// lane tiles and a dynamic rotate).  The rotate exists for Mosaic's
// aligned vector loads and does not carry over; neither does the
// shift-and-accumulate, which on this card is one FFMA per shared load.
//
// The fold.  With W = 64, k = W p + r and i = W q + s:
//
//     c[W p + r] = sum_d sum_{s < W} a[W (p - d) + s] * T_d[s, r],
//     T_d[s, r]  = b[W d + r - s]      (zero outside [0, lb)),
//
// so the 1-D product is a 2-D one: a folded into rows of W words, and for
// every block diagonal d one (rows x W) @ (W x W) product of a's rows slid
// down by d with a Toeplitz tile of b.  That is K4a's unit
// (conv2d_mma.cuh) with a single column block: the A operand is a window
// of a's rows, as K4a's a[K0 + m - j0], and T_d is read straight from a
// staged stretch of b at offset 64 dj + 63 + r - s, never built.  A staged
// group of G = 16 diagonals needs one contiguous stretch of 16 W + 63
// words of b (K4a's G rows of b overlap here), and every tile is a full
// band: the kernel issues 1 + W^2 / n times the useful multiply-adds of a
// dense product of length n (the diagonal tiles are full).
//
// What bounds it on the H100: tensor-core TF32 multiply-adds, three per
// f32 multiply-add, at the rate mma.sync reaches (160e12 multiply-adds/s
// on this card, about two thirds of its TF32 rate: tune_port.py probe 4).
// What the design does, with conv2d_mma.cuh's pieces:
//
//   * accuracy: the split at staging (hi = tf32(x), lo = tf32((x - hi)
//     2^11), three passes, lo*lo dropped), chains of eight mma.sync
//     m16n8k8 steps (one diagonal: 64 terms) from zero accumulators, and
//     sums at three levels in FFMA outside the tensor core: a chain into
//     grp, grp into acc once a staged group, a tile's units in slot order.
//   * balance: the triangle of (output tile, d) is cut into work units of
//     about equal multiply-adds by ops/conv1d.py::fold_plan (d ranges cut
//     at multiples of G, the lightest tiles finer), sorted heaviest first,
//     on a plain grid; a tile's units are added by sum_units_kernel in slot
//     order: the same bits on any card and from call to call.
//   * overlap: each group's a window (79 rows of W words) and b stretch
//     come by cp.async into raw buffers while the group before is
//     multiplied; one pass then splits them into the hi / lo planes.
//   * register blocking as K4a: 128 threads, a warp owns 32 x 32 of the
//     tile (2 x 4 mma tiles), conflict-free fragment loads (the window's
//     row pitch is W + 4; the lanes of one B fragment read 11 consecutive
//     words), two blocks an SM.  A warp skips the diagonals at which its 32
//     rows of the window lie outside a.
//
// A product of fewer than MMA_MIN_MACS useful multiply-adds, or whose
// shorter operand (the wrapper passes it as b) has fewer than MMA_MIN_LEN
// words, takes the FFMA body below instead (ops/conv1d.py::fold_body):
// one 128-thread block per 128 outputs, b chunk and a window in shared
// memory; its chains, as long as b, end before the tensor-core body's
// staging and slot sum do.
//
// The card's own time (torch.profiler, tune_port.py probe 8, one H100
// 80GB HBM3 at 700 W): 8.9 us at length 4096, of which 3.5 us is the slot
// sum (the FFMA kernel this replaces: 41.7 us); 0.89 ms at 262144, 47% of
// the TF32 x 3 bound (10.3 ms).  The other lengths are in PERF.md.

#include "conv2d_mma.cuh"

namespace {

// ---------------------------------------------------------------- FFMA body

constexpr int T1 = 128;  // outputs per block = threads
constexpr int J1 = 128;  // b values staged per pass

__global__ void __launch_bounds__(T1)
conv1d_ffma_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ c, int la, int lb, int lc) {
  __shared__ float sA[T1 + J1 - 1];
  __shared__ float sB[J1];
  const int K = blockIdx.x * T1;
  const int t = threadIdx.x;
  // a[k - j] is nonzero only for k - j < la, and k < K + T1
  const int j_lo = max(0, K - la + 1);
  const int j_hi = min(lb, K + T1);
  float acc = 0.f;
  for (int jb = j_lo; jb < j_hi; jb += J1) {
    __syncthreads();  // the previous chunk has been read
    // sA[w] = a[K - jb - (J1 - 1) + w]
    for (int e = t; e < T1 + J1 - 1; e += T1) {
      const int ar = K - jb - (J1 - 1) + e;
      sA[e] = (ar >= 0 && ar < la) ? a[ar] : 0.f;
    }
    const int j = jb + t;  // J1 == T1: one b value a thread
    sB[t] = j < j_hi ? b[j] : 0.f;
    __syncthreads();
    const int n = min(J1, j_hi - jb);
    float part = 0.f;
    for (int jj = 0; jj < n; ++jj)
      part = fmaf(sA[t - jj + J1 - 1], sB[jj], part);
    acc += part;
  }
  const int k = K + t;
  if (k < lc) c[k] = acc;
}

static_assert(J1 == T1, "each thread stages one b value");

// ------------------------------------------------------- tensor-core body

constexpr int FOLD_W = BN;  // fold width = the tile's columns

struct FoldGeo {
  static constexpr int G = MmaGeo::G;  // diagonals a staged group
  static constexpr int S = FOLD_W / 8;  // k-slices of a diagonal
  static constexpr int A_ROWS = BM + G - 1;
  static constexpr int A_PITCH = FOLD_W + 4;  // window rows 4 banks apart
  static constexpr int B_WORDS = (G + 1) * FOLD_W;  // G W + W - 1 in use
  static constexpr int A_PLANE = A_ROWS * A_PITCH;
  static constexpr int A_RAW = A_ROWS * FOLD_W;
  // two planes of each operand, and the next group's words as they come
  static constexpr size_t SMEM =
      sizeof(float) * (2 * (A_PLANE + B_WORDS) + A_RAW + B_WORDS);
};

// One unit: folded output rows P0 .. P0 + 63 summed over the diagonals d in
// [d_lo, d_hi) (nonempty, inside b's diagonals).  ``to_slot``: ``out`` is a
// dense BM x W workspace tile, written whole; otherwise it is c as rc rows
// of W, written where P0 + m < rc.  ``smem`` holds FoldGeo::SMEM bytes.
__device__ __forceinline__ void fold_unit(const float* __restrict__ a,
                                          const float* __restrict__ b,
                                          float* __restrict__ out,
                                          bool to_slot, int la, int lb,
                                          int rc, int P0, int d_lo, int d_hi,
                                          float* __restrict__ smem) {
  using L = FoldGeo;
  constexpr int G = L::G;
  constexpr int S = L::S;
  constexpr int A_PITCH = L::A_PITCH;
  uint32_t* sAh = reinterpret_cast<uint32_t*>(smem);
  uint32_t* sAl = sAh + L::A_PLANE;
  uint32_t* sBh = sAl + L::A_PLANE;
  uint32_t* sBl = sBh + L::B_WORDS;
  float* rawA = reinterpret_cast<float*>(sBl + L::B_WORDS);
  float* rawB = rawA + L::A_RAW;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // the fragment layouts' group and
  const int t = lane % 4;  // thread in group
  const int mb = (warp / 2) * WM;  // the warp's rows mb .. mb + 31
  const int nb = (warp % 2) * WN;  // and columns nb .. nb + 31

  const int ra = (la + FOLD_W - 1) / FOLD_W;  // a's folded rows
  const int n_stages = (d_hi - d_lo + G - 1) / G;
  // the d at which the warp's window rows P0 + mb + (0..31) - d meet
  // [0, ra)
  const int w_lo = max(d_lo, P0 + mb - ra + 1);
  const int w_hi = min(d_hi, P0 + mb + WM);

  // cp.async of the group at g0 into the raw buffers, zero outside a and
  // b.  Window word e = W r + s holds a[i0 + e] (window row r is a's folded
  // row P0 - (g0 + G - 1) + r; d = g0 + dj and tile row m read window row
  // m - dj + G - 1, so a group of fewer than G diagonals, a unit's last,
  // leaves its first rows unstaged).  Stretch word x holds
  // b[W g0 - (W - 1) + x]: T_d[s, r] is word W dj + W - 1 + r - s.
  auto issue = [&](int g0) {
    const int n_dj = min(G, d_hi - g0);
    const int i0 = FOLD_W * (P0 - (g0 + G - 1));
    for (int e = (G - n_dj) * FOLD_W + tid; e < L::A_RAW; e += NT) {
      const int i = i0 + e;
      const bool ok = i >= 0 && i < la;
      copy_async<4>(rawA + e, ok ? a + i : a, ok);
    }
    const int j0 = FOLD_W * g0 - (FOLD_W - 1);
    for (int x = tid; x < n_dj * FOLD_W + FOLD_W - 1; x += NT) {
      const int j = j0 + x;
      const bool ok = j >= 0 && j < lb;
      copy_async<4>(rawB + x, ok ? b + j : b, ok);
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

  // the k-slice at kk of d = g0 + dj: A fragments (rows g, g + 8, columns
  // t, t + 4 of each 16 x 8 mma tile) from the window, B fragments
  // (T[t][g], T[t + 4][g] of each 8-column tile) from the stretch, both
  // planes; then the 24 mma of the slice
  auto slice = [&](int dj, int kk) {
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
    const int x = dj * FOLD_W + nb + g - kk - t + FOLD_W - 1;
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

  issue(d_lo);
  int g0 = d_lo;
  for (int stage = 0; stage < n_stages; ++stage, g0 += G) {
    const int n_dj = min(G, d_hi - g0);
    wait_group<0>();
    // this group's words have landed, and every thread has read the
    // planes of the one before
    __syncthreads();
    for (int e = (G - n_dj) * FOLD_W + tid; e < L::A_RAW; e += NT) {
      uint32_t hi, lo;
      split_tf32(rawA[e], hi, lo);
      const int w = e / FOLD_W * A_PITCH + e % FOLD_W;
      sAh[w] = hi;
      sAl[w] = lo;
    }
    for (int x = tid; x < n_dj * FOLD_W + FOLD_W - 1; x += NT) {
      uint32_t hi, lo;
      split_tf32(rawB[x], hi, lo);
      sBh[x] = hi;
      sBl[x] = lo;
    }
    __syncthreads();  // the planes are whole, the raw buffers free
    if (stage + 1 < n_stages) issue(g0 + G);  // in flight under the products

    const int dj_lo = max(0, w_lo - g0);
    const int dj_hi = min(n_dj, w_hi - g0);
    if (dj_lo < dj_hi) {
      for (int dj = dj_lo; dj < dj_hi; ++dj) {
#pragma unroll
        for (int ks = 0; ks < S; ++ks) slice(dj, 8 * ks);
        // chain end: grp += hh + 2^-11 cr, the chain starts from zero
#pragma unroll
        for (int M = 0; M < MT; ++M)
#pragma unroll
          for (int N = 0; N < NTL; ++N)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              grp[M][N][i] += fmaf(cr[M][N][i], LO_UNSCALE, hh[M][N][i]);
              hh[M][N][i] = 0.f;
              cr[M][N][i] = 0.f;
            }
      }
      // a group ends a sum
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
        const float2 v =
            make_float2(acc[M][N][2 * half], acc[M][N][2 * half + 1]);
        if (to_slot)
          *reinterpret_cast<float2*>(out + m * FOLD_W + n) = v;
        else if (P0 + m < rc)
          *reinterpret_cast<float2*>(
              out + static_cast<size_t>(P0 + m) * FOLD_W + n) = v;
      }
}

// one block per row of the unit table: P0, d_lo, d_hi, slot (-1: the unit
// writes c)
__global__ void __launch_bounds__(NT, 2)
conv1d_mma_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, float* __restrict__ work,
                  const int4* __restrict__ units, int la, int lb, int rc) {
  extern __shared__ __align__(16) float smem[];
  const int4 u = units[blockIdx.x];
  const bool to_slot = u.w >= 0;
  float* out = to_slot ? work + static_cast<size_t>(u.w) * TILE_WORDS : c;
  fold_unit(a, b, out, to_slot, la, lb, rc, u.x, u.y, u.z, smem);
}

}  // namespace

// Launches on ``stream``; returns the first non-zero CUDA error (0 when
// every launch was accepted).  All lengths >= 1, every pointer a contiguous
// f32 array on the current device.  ``units`` / ``sums`` come from
// ops/conv1d.py::fold_plan: n_units == 0 runs the FFMA body (c of lc
// words), otherwise the tensor-core body on the table and, for n_sums > 0,
// the slot sum (c of ceil(lc / 64) * 64 words, 8-byte aligned).
extern "C" int conv1d_trunc_f32(const float* a, const float* b, float* c,
                                float* work, const void* units, int n_units,
                                const void* sums, int n_sums, int la, int lb,
                                int lc, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_units == 0) {
    const unsigned blocks = static_cast<unsigned>((lc + T1 - 1) / T1);
    conv1d_ffma_kernel<<<blocks, T1, 0, st>>>(a, b, c, la, lb, lc);
    return static_cast<int>(cudaGetLastError());
  }
  static bool allowed[64] = {};
  cudaError_t err = allow_smem(conv1d_mma_kernel, FoldGeo::SMEM, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = (lc + FOLD_W - 1) / FOLD_W;
  conv1d_mma_kernel<<<n_units, NT, FoldGeo::SMEM, st>>>(
      a, b, c, work, static_cast<const int4*>(units), la, lb, rc);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_sums == 0) return static_cast<int>(err);
  return static_cast<int>(sum_units(work, c, static_cast<const int4*>(sums),
                                    n_sums, 0, 1, rc, FOLD_W, st));
}
