// A batch of truncated 2-D Cauchy products in IEEE f32 on Hopper
// (sm_90a): for every batch entry g,
//
//     c[g, k0, k1] = sum_{j0, j1} a_g[k0 - j0, k1 - j1] * b_g[j0, j1]
//
// with a_g = a + g * a_stride and b_g = b + g * b_stride: one operand is
// the batch and the other is shared (stride 0), in either order.
//
// Replaces the TPU kernel genfer_tpu/ops/pallas_conv2d.py::_build2d_batched
// (the batch on the leading grid axis, the shared b staged once in VMEM
// for the whole batch; its shared-LHS layout is the same kernel with the
// operands swapped at the call site).  Here the batch rides the grid's z
// axis beside the j0 split of the single-pair kernel
// (conv2d_trunc_f32.cu): each entry runs that kernel's tile code with the
// split its launch plan picks for one pair, and a second pass adds the
// partial tiles in split order, so every entry equals the single-pair
// result bit for bit.  The shared operand stays in L2 (at most a few MB)
// and is read by every block of every entry.
//
// What bounds it: issued f32 FMAs, as for the single-pair kernel; the
// batch fills the card where one pair of small order cannot.

#include "conv2d_tile.cuh"

namespace {

template <int CJ>
__global__ void __launch_bounds__(NT)
conv2d_trunc_f32_batched_kernel(const float* __restrict__ a,
                                const float* __restrict__ b,
                                float* __restrict__ c, size_t a_stride,
                                size_t b_stride, int a0, int a1, int b0,
                                int b1, int c0, int c1, int splits,
                                int split_rows) {
  const int K0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int K1 = (gridDim.x - 1 - blockIdx.x) * BN;
  const int g = blockIdx.z / splits;
  const int s = blockIdx.z - g * splits;
  const int z0 = s * split_rows;
  product_tile<CJ, 1>(a + g * a_stride, b + g * b_stride,
                      c + static_cast<size_t>(blockIdx.z) * c0 * c1, a0, a1,
                      b0, b1, c0, c1, K0, K1, z0, z0 + split_rows);
}

}  // namespace

// Launches on ``stream``; returns the first non-zero cudaGetLastError().
// All sizes >= 1, batch * splits <= 65535, every pointer a contiguous
// row-major f32 array on the current device, splits * split_rows >=
// min(b0, c0).  ``c`` holds batch * c0 * c1 floats; with splits > 1,
// ``work`` holds batch * splits * c0 * c1 (with splits == 1 it is not read).
extern "C" int conv2d_trunc_f32_batched(const float* a, const float* b,
                                        float* c, float* work,
                                        size_t a_stride, size_t b_stride,
                                        int batch, int a0, int a1, int b0,
                                        int b1, int c0, int c1, int splits,
                                        int split_rows, void* stream) {
  const dim3 grid((c1 + BN - 1) / BN, (c0 + BM - 1) / BM, batch * splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = splits > 1 ? work : c;
  if (b1 == 1)
    conv2d_trunc_f32_batched_kernel<1><<<grid, NT, 0, st>>>(
        a, b, out, a_stride, b_stride, a0, a1, b0, b1, c0, c1, splits,
        split_rows);
  else
    conv2d_trunc_f32_batched_kernel<32><<<grid, NT, 0, st>>>(
        a, b, out, a_stride, b_stride, a0, a1, b0, b1, c0, c1, splits,
        split_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(sum_splits(work, c, splits, batch, c0, c1, st));
}
