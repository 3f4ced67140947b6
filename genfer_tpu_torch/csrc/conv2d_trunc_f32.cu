// Truncated 2-D Cauchy product in IEEE f32 on Hopper (sm_90a):
//
//     c[k0, k1] = sum_{j0 < b0, j1 < b1} a[k0 - j0, k1 - j1] * b[j0, j1]
//
// for k0 < c0, k1 < c1, with a read as zero outside [0, a0) x [0, a1).
// Any shapes: a0 > c0, c > a + b - 1 and length-1 axes are all allowed.
//
// Replaces the TPU kernel genfer_tpu/ops/pallas_conv2d.py::_build2d_rowstrip
// (a 128-row output strip per program, Toeplitz tiles of b built in VMEM
// with strided rolls, f32-HIGHEST MXU dots).  None of its alignment
// machinery carries over: the 144-row aligned slab and its sublane roll,
// the strided-roll Toeplitz build and the i32-only index math exist for
// Mosaic's (8, 128) layout, not for this function.
//
// What bounds it on the H100: issued f32 FMAs against the ~67 TFLOP/s
// non-tensor f32 rate.  The operands are tiny (orders <= 768: at most a
// few MB, L2-resident), and the MACs grow as order^4.  Tensor cores are
// not used: TF32 keeps 10 mantissa bits and cannot meet the rtol 5e-5 /
// atol 1e-6 bar against f64.
//
// Design (simple and right first):
//   * one 256-thread block per 64x64 output tile; each thread holds a
//     4x4 register tile (rows ty + 16 i, contiguous columns 4 tx + q);
//   * the j0 loop is bounded per tile to the rows where a is nonzero,
//     j0 in [K0 - a0 + 1, K0 + 64) intersected with [0, b0), and the j1
//     loop likewise, so the zero part of the triangle is never visited;
//   * per (CJ-wide j1 chunk, group of G = 32 j0 rows) one a window
//     (64 + G - 1 rows x 64 + CJ - 1 columns, shared by every j0 of the
//     group: a step in j0 is a step of one window row) and the G x CJ
//     block of b are staged in shared memory; ragged edges are masked
//     while staging;
//   * along j1 each thread slides a 4-wide register window over its a
//     row, so one shared load feeds 4 FMAs (the window is padded by one
//     word every 4 so the 16 column threads of a half-warp hit distinct
//     banks), and the b row is held in registers;
//   * sums are kept at three levels (one j1 chunk, one j0 group, the
//     rest) so no f32 accumulator takes more than max(CJ, G, groups x
//     chunks) additions: a single running sum over order^2 terms would
//     drift to ~1e-5;
//   * the wrapper (ops/conv2d.py) puts the smaller operand in b (the
//     product is symmetric), and CJ = 1 is used when b has one column,
//     so thin operands such as (308, 1) or (1, 274) issue no FMAs on
//     padding;
//   * load balance: a dense order-512 product has only 64 tiles for 132
//     SMs, and the tile with the largest k has the longest j0 range.
//     The wrapper splits the j0 axis into ``splits`` ranges of
//     ``split_rows`` rows (a multiple of G), one block per (tile, range);
//     each writes its partial tile to a workspace, and a second kernel
//     adds the partials in range order, so the result does not depend on
//     which block finishes first.
// Blocks run the heaviest tiles (largest k) first.  3xTF32 tensor-core
// splits, TMA staging and batching are later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 64;       // output tile rows
constexpr int BN = 64;       // output tile columns
constexpr int TM = 4;        // rows per thread, strided by TY
constexpr int TN = 4;        // contiguous columns per thread
constexpr int G = 32;        // j0 rows per staged group
constexpr int TY = BM / TM;  // 16 thread rows
constexpr int TX = BN / TN;  // 16 thread columns
constexpr int NT = TX * TY;  // 256 threads
constexpr int WR = BM + G - 1;  // a-window rows

// one spare word after every TN window words: thread column tx reads
// word 5 tx + const, so a half-warp touches 16 distinct banks
__host__ __device__ constexpr int padded(int w) { return w + w / TN; }

template <int CJ>
__global__ void __launch_bounds__(NT)
conv2d_trunc_f32_kernel(const float* __restrict__ a,
                        const float* __restrict__ b,
                        float* __restrict__ c,
                        int a0, int a1, int b0, int b1, int c0, int c1,
                        int split_rows) {
  constexpr int W = BN + CJ - 1;  // a-window columns
  constexpr int WP = padded(W - 1) + 1;
  __shared__ float sA[WR][WP];
  __shared__ __align__(16) float sB[G][CJ];

  const int K0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int K1 = (gridDim.x - 1 - blockIdx.x) * BN;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  // a[k0 - j0, .] is nonzero only for 0 <= k0 - j0 < a0, and k0 < K0 + BM,
  // k0 < c0; this block takes the j0 range of split blockIdx.z
  const int z0 = blockIdx.z * split_rows;
  const int j0_lo = max(max(0, K0 - a0 + 1), z0);
  const int j0_hi = min(min(b0, min(K0 + BM, c0)), z0 + split_rows);
  const int j1_lo = max(0, K1 - a1 + 1);
  const int j1_hi = min(b1, K1 + BN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[i][q] = 0.f;

  for (int jb = j1_lo; jb < j1_hi; jb += CJ) {
    for (int g0 = j0_lo; g0 < j0_hi; g0 += G) {
      __syncthreads();  // the previous pass has finished reading sA / sB
      // j0 = g0 + t and tile row i read a row K0 + i - g0 - t, which is
      // window row i - t + G - 1:
      // sA[r][w] = a[K0 - g0 - (G - 1) + r][K1 - jb - (CJ - 1) + w]
      const int row0 = K0 - g0 - (G - 1);
      const int col0 = K1 - jb - (CJ - 1);
      for (int e = tid; e < WR * W; e += NT) {
        const int r = e / W;
        const int w = e - r * W;
        const int ar = row0 + r;
        const int ac = col0 + w;
        float v = 0.f;
        if (ar >= 0 && ar < a0 && ac >= 0 && ac < a1)
          v = a[static_cast<size_t>(ar) * a1 + ac];
        sA[r][padded(w)] = v;
      }
      for (int e = tid; e < G * CJ; e += NT) {
        const int t = e / CJ;
        const int jj = e - t * CJ;
        const int j0 = g0 + t;
        const int j1 = jb + jj;
        sB[t][jj] = (j0 < j0_hi && j1 < b1)
                        ? b[static_cast<size_t>(j0) * b1 + j1]
                        : 0.f;
      }
      __syncthreads();

      const int nt = min(G, j0_hi - g0);
      float grp[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int q = 0; q < TN; ++q) grp[i][q] = 0.f;

      for (int t = 0; t < nt; ++t) {
        float bv[CJ];
        if constexpr (CJ % 4 == 0) {
#pragma unroll
          for (int jj = 0; jj < CJ; jj += 4) {
            const float4 v = *reinterpret_cast<const float4*>(&sB[t][jj]);
            bv[jj] = v.x;
            bv[jj + 1] = v.y;
            bv[jj + 2] = v.z;
            bv[jj + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int jj = 0; jj < CJ; ++jj) bv[jj] = sB[t][jj];
        }
        // output column 4 tx + q at chunk offset jj reads window word
        // 4 tx + q + CJ - 1 - jj
        const int rb = ty - t + G - 1;
        float win[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int q = 0; q < TN; ++q)
            win[i][q] = sA[rb + i * TY][padded(tx * TN + q + CJ - 1)];

        float part[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int q = 0; q < TN; ++q) part[i][q] = 0.f;

#pragma unroll
        for (int jj = 0; jj < CJ; ++jj) {
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int q = 0; q < TN; ++q)
              part[i][q] = fmaf(win[i][q], bv[jj], part[i][q]);
          if (jj + 1 < CJ) {
#pragma unroll
            for (int i = 0; i < TM; ++i) {
#pragma unroll
              for (int q = TN - 1; q > 0; --q) win[i][q] = win[i][q - 1];
              win[i][0] = sA[rb + i * TY][padded(tx * TN + CJ - 2 - jj)];
            }
          }
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int q = 0; q < TN; ++q) grp[i][q] += part[i][q];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int q = 0; q < TN; ++q) acc[i][q] += grp[i][q];
    }
  }

  c += static_cast<size_t>(blockIdx.z) * c0 * c1;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int k0 = K0 + ty + i * TY;
    if (k0 >= c0) continue;
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int k1 = K1 + tx * TN + q;
      if (k1 < c1) c[static_cast<size_t>(k0) * c1 + k1] = acc[i][q];
    }
  }
}

// c[i] = sum over z of part[z][i], in z order
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ c, int splits,
                                  size_t n) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[z * n + i];
    c[i] = s;
  }
}

}  // namespace

// Launches on ``stream``; returns the first non-zero cudaGetLastError()
// (0 when every launch was accepted).  All sizes must be >= 1, every
// pointer a contiguous row-major f32 array on the current device, and
// splits * split_rows >= min(b0, c0).  With splits > 1, ``work`` holds
// splits * c0 * c1 floats; with splits == 1 it is not read.
extern "C" int conv2d_trunc_f32(const float* a, const float* b, float* c,
                                float* work, int a0, int a1, int b0, int b1,
                                int c0, int c1, int splits, int split_rows,
                                void* stream) {
  const dim3 grid((c1 + BN - 1) / BN, (c0 + BM - 1) / BM, splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = splits > 1 ? work : c;
  if (b1 == 1)
    conv2d_trunc_f32_kernel<1><<<grid, NT, 0, st>>>(
        a, b, out, a0, a1, b0, b1, c0, c1, split_rows);
  else
    conv2d_trunc_f32_kernel<32><<<grid, NT, 0, st>>>(
        a, b, out, a0, a1, b0, b1, c0, c1, split_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(c0) * c1;
  const size_t blocks = (n + 255) / 256;
  sum_splits_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                      256, 0, st>>>(work, c, splits, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* conv2d_trunc_f32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
