// Truncated 2-D Cauchy product in IEEE f32 on Hopper (sm_90a), K2:
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
// few MB, L2-resident), and the MACs grow as order^4.  Plain TF32 tensor
// cores keep 10 mantissa bits and cannot meet the rtol 5e-5 / atol 1e-6
// bar against f64.
//
// Two things held the first version (one block per 64x64 tile and fixed
// j0 range, conv2d_tile.cuh) to a tenth of that rate; what this kernel
// does about each:
//   * load balance.  A tile's work grows with its k, and one wave of very
//     unequal blocks ends with its heaviest.  Here the product is cut into
//     work units of about equal multiply-add count (output tile, j0 range,
//     j1 range) by ops/conv2d.py::unit_plan, from the shapes alone.  The
//     table is sorted heaviest first and this kernel is a plain grid over
//     it: the hardware hands the next block to the first SM with room, so
//     the card drains the table like a queue and ends on the light units.
//     A tile of several units has a run of workspace slots, added in slot
//     order by a second kernel: the result is the same bits on any card,
//     in any block order.
//   * the inner loop.  conv2d_unit.cuh: 4x8 outputs a thread on contiguous
//     rows, a window row held in registers across four j0 and the whole j1
//     slide, conflict-free 16-byte shared loads, two cp.async stages.
// The wrapper puts the smaller operand in b, and a one-column b takes the
// CJ = 1 path, so thin operands such as (308, 1) issue no FMA on padding.

#include "conv2d_unit.cuh"

namespace {

template <int CJ, bool VEC>
__global__ void __launch_bounds__(NT, 3)
conv2d_trunc_f32_kernel(const float* __restrict__ a,
                        const float* __restrict__ b, float* __restrict__ c,
                        float* __restrict__ work,
                        const int4* __restrict__ units, int a0, int a1,
                        int b1, int c0, int c1) {
  extern __shared__ __align__(16) float smem[];
  run_unit<CJ, VEC>(a, b, c, work, units, blockIdx.x, a0, a1, b1, c0, c1,
                    smem);
}

template <int CJ, bool VEC>
cudaError_t launch(const float* a, const float* b, float* c, float* work,
                   const int4* units, int n_units, int a0, int a1, int b1,
                   int c0, int c1, cudaStream_t st) {
  static bool allowed[64] = {};
  auto kernel = conv2d_trunc_f32_kernel<CJ, VEC>;
  const cudaError_t err = allow_smem(kernel, Geo<CJ>::SMEM, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<n_units, NT, Geo<CJ>::SMEM, st>>>(a, b, c, work, units, a0, a1,
                                             b1, c0, c1);
  return cudaGetLastError();
}

}  // namespace

// Launches on ``stream``; returns the first non-zero CUDA error (0 when
// every launch was accepted).  All sizes must be >= 1 and every pointer a
// contiguous array on the current device: a, b, c row-major f32; ``units``
// n_units x 8 and ``sums`` n_sums x 4 int32 as ops/conv2d.py::unit_plan
// lays them out (16-byte aligned); ``work`` one 64x64 f32 tile per slot
// the table names (not read when n_sums == 0).  Output tiles that no unit
// names are left as they are.  b's row count is not passed: the table's
// ranges already lie inside b.
extern "C" int conv2d_trunc_f32(const float* a, const float* b, float* c,
                                float* work, const void* units, int n_units,
                                const void* sums, int n_sums, int a0, int a1,
                                int b1, int c0, int c1, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4* u = static_cast<const int4*>(units);
  const bool vec = aligned16(a) && a1 % 4 == 0;
  cudaError_t err;
  if (b1 == 1)
    err = vec ? launch<1, true>(a, b, c, work, u, n_units, a0, a1, b1, c0,
                                c1, st)
              : launch<1, false>(a, b, c, work, u, n_units, a0, a1, b1, c0,
                                 c1, st);
  else
    err = vec ? launch<32, true>(a, b, c, work, u, n_units, a0, a1, b1, c0,
                                 c1, st)
              : launch<32, false>(a, b, c, work, u, n_units, a0, a1, b1, c0,
                                  c1, st);
  if (err != cudaSuccess || n_sums == 0) return static_cast<int>(err);
  return static_cast<int>(sum_units(work, c, static_cast<const int4*>(sums),
                                    n_sums, 0, 1, c0, c1, st));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
