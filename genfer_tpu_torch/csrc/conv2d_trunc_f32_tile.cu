// Truncated 2-D Cauchy product in IEEE f32 on Hopper (sm_90a), one block
// per 64x64 output tile over the whole j0 range:
//
//     c[k0, k1] = sum_{j0 < b0, j1 < b1} a[k0 - j0, k1 - j1] * b[j0, j1]
//
// Replaces the TPU kernel genfer_tpu/ops/pallas_conv2d.py::_build2d (one
// program per 128x128 output tile, bit-identical there to the row-strip
// kernel).  On the H100 the row-strip kernel's counterpart
// (conv2d_trunc_f32.cu) cuts j0 over several blocks when the card has
// more SMs than tiles; this kernel never does, so it equals that kernel
// bit for bit when the split is 1 and to f32 rounding otherwise.
//
// What bounds it: issued f32 FMAs, as for conv2d_trunc_f32.cu, whose tile
// code (conv2d_tile.cuh) it runs.  With no split, a product with fewer
// tiles than SMs leaves SMs idle: that is the measurement this kernel is
// kept for (tile schedule against split schedule).

#include "conv2d_tile.cuh"

namespace {

template <int CJ>
__global__ void __launch_bounds__(NT)
conv2d_trunc_f32_tile_kernel(const float* __restrict__ a,
                             const float* __restrict__ b,
                             float* __restrict__ c, int a0, int a1, int b0,
                             int b1, int c0, int c1) {
  const int K0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int K1 = (gridDim.x - 1 - blockIdx.x) * BN;
  product_tile<CJ, 1>(a, b, c, a0, a1, b0, b1, c0, c1, K0, K1, 0, b0);
}

}  // namespace

// Launches on ``stream``; returns cudaGetLastError().  All sizes >= 1,
// every pointer a contiguous row-major f32 array on the current device.
extern "C" int conv2d_trunc_f32_tile(const float* a, const float* b,
                                     float* c, int a0, int a1, int b0,
                                     int b1, int c0, int c1, void* stream) {
  const dim3 grid((c1 + BN - 1) / BN, (c0 + BM - 1) / BM);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b1 == 1)
    conv2d_trunc_f32_tile_kernel<1><<<grid, NT, 0, st>>>(
        a, b, c, a0, a1, b0, b1, c0, c1);
  else
    conv2d_trunc_f32_tile_kernel<32><<<grid, NT, 0, st>>>(
        a, b, c, a0, a1, b0, b1, c0, c1);
  return static_cast<int>(cudaGetLastError());
}
