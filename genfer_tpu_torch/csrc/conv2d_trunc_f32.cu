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
// splits and TMA staging are later work.  The tile code is in
// conv2d_tile.cuh, shared with the tile (K4a), grouped (K4b) and batched
// (K3) kernels.

#include "conv2d_tile.cuh"

namespace {

// one block per (output tile, j0 range): heaviest tiles (largest k) first
template <int CJ>
__global__ void __launch_bounds__(NT)
conv2d_trunc_f32_kernel(const float* __restrict__ a,
                        const float* __restrict__ b,
                        float* __restrict__ c,
                        int a0, int a1, int b0, int b1, int c0, int c1,
                        int split_rows) {
  const int K0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int K1 = (gridDim.x - 1 - blockIdx.x) * BN;
  const int z0 = blockIdx.z * split_rows;
  product_tile<CJ, 1>(a, b, c + static_cast<size_t>(blockIdx.z) * c0 * c1,
                      a0, a1, b0, b1, c0, c1, K0, K1, z0, z0 + split_rows);
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
  return static_cast<int>(sum_splits(work, c, splits, 1, c0, c1, st));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
