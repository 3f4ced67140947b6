// Device code shared by the truncated 2-D product kernels (K2 rowstrip,
// K4a tile, K4b grouped, K3 batched): one 64x64 output tile of
//
//     c[k0, k1] = sum_{j0, j1} a[k0 - j0, k1 - j1] * b[j0, j1]
//
// in IEEE f32 with FMA, and the pass that adds the partial tiles of a
// j0 split.  Each kernel is its own __global__ in its own .cu file; this
// header is what they share.  The design notes are in
// conv2d_trunc_f32.cu.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 64;       // output tile rows
constexpr int BN = 64;       // output tile columns
constexpr int TM = 4;        // rows per thread, strided by TY
constexpr int TN = 4;        // contiguous columns per thread
constexpr int G = 32;        // j0 rows per staged group (stride 1)
constexpr int TY = BM / TM;  // 16 thread rows
constexpr int TX = BN / TN;  // 16 thread columns
constexpr int NT = TX * TY;  // 256 threads
constexpr int WR = BM + G - 1;  // a-window rows

// one spare word after every TN window words: thread column tx reads
// word 5 tx + const, so a half-warp touches 16 distinct banks
__host__ __device__ constexpr int padded(int w) { return w + w / TN; }

// The output tile at (K0, K1), summed over j0 in [z_lo, z_hi) (clipped to
// where a and b are nonzero), written to ``c`` (row-major, c0 x c1).
//
// S is the j0 order: S = 1 visits j0 in ascending groups of G rows; S = 8
// visits it in residue-major order, r = j0 mod 8 outer and j0 = r + 8q
// inner (the order of genfer_tpu's _build2d_grouped), in groups of GS
// rows of one class.  A group's rows share one staged a window, whose
// height BM + S (GS - 1) stays within WR.
template <int CJ, int S>
__device__ __forceinline__ void product_tile(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ c, int a0, int a1, int b0, int b1, int c0, int c1,
    int K0, int K1, int z_lo, int z_hi) {
  constexpr int GS = 1 + (G - 1) / S;  // j0 rows per staged group
  constexpr int R = BM + S * (GS - 1);  // a-window rows in use
  constexpr int W = BN + CJ - 1;  // a-window columns
  constexpr int WP = padded(W - 1) + 1;
  static_assert(R <= WR, "the a window must fit its shared array");
  __shared__ float sA[WR][WP];
  __shared__ __align__(16) float sB[GS][CJ];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  // a[k0 - j0, .] is nonzero only for 0 <= k0 - j0 < a0, and k0 < K0 + BM,
  // k0 < c0
  const int j0_lo = max(max(0, K0 - a0 + 1), z_lo);
  const int j0_hi = min(min(b0, min(K0 + BM, c0)), z_hi);
  const int j1_lo = max(0, K1 - a1 + 1);
  const int j1_hi = min(b1, K1 + BN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[i][q] = 0.f;

  for (int jb = j1_lo; jb < j1_hi; jb += CJ) {
    for (int r = 0; r < S; ++r) {
      // the first j0 >= j0_lo of residue class r mod S
      const int first = j0_lo + ((r - j0_lo) % S + S) % S;
      for (int g0 = first; g0 < j0_hi; g0 += S * GS) {
        __syncthreads();  // the previous pass has finished reading sA / sB
        // j0 = g0 + S t and tile row i read a row K0 + i - g0 - S t,
        // which is window row i - S t + S (GS - 1):
        // sA[r][w] = a[K0 - g0 - S (GS - 1) + r][K1 - jb - (CJ - 1) + w]
        const int row0 = K0 - g0 - S * (GS - 1);
        const int col0 = K1 - jb - (CJ - 1);
        for (int e = tid; e < R * W; e += NT) {
          const int rr = e / W;
          const int w = e - rr * W;
          const int ar = row0 + rr;
          const int ac = col0 + w;
          float v = 0.f;
          if (ar >= 0 && ar < a0 && ac >= 0 && ac < a1)
            v = a[static_cast<size_t>(ar) * a1 + ac];
          sA[rr][padded(w)] = v;
        }
        for (int e = tid; e < GS * CJ; e += NT) {
          const int t = e / CJ;
          const int jj = e - t * CJ;
          const int j0 = g0 + S * t;
          const int j1 = jb + jj;
          sB[t][jj] = (j0 < j0_hi && j1 < b1)
                          ? b[static_cast<size_t>(j0) * b1 + j1]
                          : 0.f;
        }
        __syncthreads();

        const int nt = min(GS, (j0_hi - g0 + S - 1) / S);
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
          const int rb = ty - S * t + S * (GS - 1);
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
  }

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

// c[g n + i] = sum over z of part[(g splits + z) n + i], in z order, for
// every batch entry g of ``total / n``
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ c, int splits,
                                  size_t n, size_t total) {
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t g = e / n;
    const float* p = part + g * splits * n + (e - g * n);
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += p[z * n];
    c[e] = s;
  }
}

// the second pass of a j0 split on ``stream``: work holds ``batch`` runs of
// ``splits`` partial (c0, c1) tiles
inline cudaError_t sum_splits(const float* work, float* c, int splits,
                              int batch, int c0, int c1,
                              cudaStream_t stream) {
  const size_t n = static_cast<size_t>(c0) * c1;
  const size_t total = n * batch;
  const size_t blocks = (total + 255) / 256;
  sum_splits_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                      256, 0, stream>>>(work, c, splits, n, total);
  return cudaGetLastError();
}

}  // namespace
