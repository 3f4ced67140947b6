// Truncated 2-D Cauchy product in IEEE f32 on Hopper (sm_90a), with the
// j0 sum taken in residue-major order:
//
//     c[k0, k1] = sum_{r < 8} sum_{q} sum_{j1} a[k0 - j0, k1 - j1] * b[j0, j1],
//     j0 = r + 8 q
//
// Replaces the TPU kernel genfer_tpu/ops/pallas_conv2d.py::_build2d_grouped
// (one program per 128-row output strip, j0 visited by residue class mod 8
// so that every a window of a class starts 8-row aligned and one slab load
// and one sublane rotation serve the whole class).  That order is the
// kernel's defining property and is kept.  Its reason is not: Hopper has
// no sublane alignment, so whether the order gains or loses here is a
// measurement (PERF.md).  It equals the tile kernel
// (conv2d_trunc_f32_tile.cu) to f32 rounding, not bit for bit.
//
// What bounds it: issued f32 FMAs, as for the other tile kernels.  One
// block per 64x64 output tile over the whole j0 range (no split).  Rows of
// one residue class lie 8 apart, so a staged a window of the shared
// height serves 4 of them (against 32 consecutive rows in the tile
// kernel): the staging traffic per FMA is about 8 times the tile
// kernel's.

#include "conv2d_tile.cuh"

namespace {

constexpr int RESIDUES = 8;  // j0 classes, as in _build2d_grouped

template <int CJ>
__global__ void __launch_bounds__(NT)
conv2d_trunc_f32_grouped_kernel(const float* __restrict__ a,
                                const float* __restrict__ b,
                                float* __restrict__ c, int a0, int a1,
                                int b0, int b1, int c0, int c1) {
  const int K0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int K1 = (gridDim.x - 1 - blockIdx.x) * BN;
  product_tile<CJ, RESIDUES>(a, b, c, a0, a1, b0, b1, c0, c1, K0, K1, 0,
                             b0);
}

}  // namespace

// Launches on ``stream``; returns cudaGetLastError().  All sizes >= 1,
// every pointer a contiguous row-major f32 array on the current device.
extern "C" int conv2d_trunc_f32_grouped(const float* a, const float* b,
                                        float* c, int a0, int a1, int b0,
                                        int b1, int c0, int c1,
                                        void* stream) {
  const dim3 grid((c1 + BN - 1) / BN, (c0 + BM - 1) / BM);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b1 == 1)
    conv2d_trunc_f32_grouped_kernel<1><<<grid, NT, 0, st>>>(
        a, b, c, a0, a1, b0, b1, c0, c1);
  else
    conv2d_trunc_f32_grouped_kernel<32><<<grid, NT, 0, st>>>(
        a, b, c, a0, a1, b0, b1, c0, c1);
  return static_cast<int>(cudaGetLastError());
}
