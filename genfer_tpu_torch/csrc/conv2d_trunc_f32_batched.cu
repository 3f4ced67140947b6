// A batch of truncated 2-D Cauchy products in IEEE f32 on Hopper
// (sm_90a), K3: for every batch entry g,
//
//     c[g, k0, k1] = sum_{j0, j1} a_g[k0 - j0, k1 - j1] * b_g[j0, j1]
//
// with a_g = a + g * a_stride and b_g = b + g * b_stride: one operand is
// the batch and the other is shared (stride 0), in either order.
//
// Replaces the TPU kernel genfer_tpu/ops/pallas_conv2d.py::_build2d_batched
// (the batch on the leading grid axis, the shared b staged once in VMEM
// for the whole batch; its shared-LHS layout is the same kernel with the
// operands swapped at the call site).  Here every entry runs the work
// units of the single-pair kernel (conv2d_trunc_f32.cu): the same table
// from ops/conv2d.py::unit_plan, the same unit code (conv2d_unit.cuh) and
// the same slot-ordered second pass, so every entry equals the
// single-pair result bit for bit.  The grid is one-dimensional over
// (unit, entry) pairs, unit-major: the table is sorted heaviest first, so
// the card works through all entries' heavy units before the light ones,
// and the batch size is bounded by the grid's 2^31 - 1 blocks only.  The
// shared operand stays in L2 (at most a few MB) and is read by every
// block of every entry.
//
// What bounds it: issued f32 FMAs, as for the single-pair kernel; the
// batch fills the card where one pair of small order cannot.

#include <climits>

#include "conv2d_unit.cuh"

namespace {

template <int CJ, bool VEC>
__global__ void __launch_bounds__(NT, 3)
conv2d_trunc_f32_batched_kernel(const float* __restrict__ a,
                                const float* __restrict__ b,
                                float* __restrict__ c,
                                float* __restrict__ work,
                                const int4* __restrict__ units, int batch,
                                int slots, size_t a_stride, size_t b_stride,
                                int a0, int a1, int b1, int c0, int c1) {
  extern __shared__ __align__(16) float smem[];
  const int u = blockIdx.x / batch;
  const size_t g = blockIdx.x - u * batch;
  run_unit<CJ, VEC>(a + g * a_stride, b + g * b_stride, c + g * c0 * c1,
                    work + g * slots * TILE_WORDS, units, u, a0, a1, b1, c0,
                    c1, smem);
}

template <int CJ, bool VEC>
cudaError_t launch(const float* a, const float* b, float* c, float* work,
                   const int4* units, int n_units, int batch, int slots,
                   size_t a_stride, size_t b_stride, int a0, int a1, int b1,
                   int c0, int c1, cudaStream_t st) {
  static bool allowed[64] = {};
  auto kernel = conv2d_trunc_f32_batched_kernel<CJ, VEC>;
  const cudaError_t err = allow_smem(kernel, Geo<CJ>::SMEM, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(n_units) * batch, NT, Geo<CJ>::SMEM, st>>>(
      a, b, c, work, units, batch, slots, a_stride, b_stride, a0, a1, b1, c0,
      c1);
  return cudaGetLastError();
}

}  // namespace

// Launches on ``stream``; returns the first non-zero CUDA error.  As
// conv2d_trunc_f32, for ``batch`` entries: ``c`` holds batch * c0 * c1
// floats and ``work`` batch * slots tiles of 64x64, ``slots`` being the
// slots one pair's table names; batch * n_units must stay below 2^31.
extern "C" int conv2d_trunc_f32_batched(
    const float* a, const float* b, float* c, float* work, const void* units,
    int n_units, const void* sums, int n_sums, int slots, size_t a_stride,
    size_t b_stride, int batch, int a0, int a1, int b1, int c0, int c1,
    void* stream) {
  if (static_cast<long long>(batch) * n_units > INT_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4* u = static_cast<const int4*>(units);
  // every entry's rows are 16-byte aligned when the first one's are
  const bool vec = aligned16(a) && a1 % 4 == 0;
  cudaError_t err;
  if (b1 == 1)
    err = vec ? launch<1, true>(a, b, c, work, u, n_units, batch, slots,
                                a_stride, b_stride, a0, a1, b1, c0, c1, st)
              : launch<1, false>(a, b, c, work, u, n_units, batch, slots,
                                 a_stride, b_stride, a0, a1, b1, c0, c1, st);
  else
    err = vec ? launch<32, true>(a, b, c, work, u, n_units, batch, slots,
                                 a_stride, b_stride, a0, a1, b1, c0, c1, st)
              : launch<32, false>(a, b, c, work, u, n_units, batch, slots,
                                  a_stride, b_stride, a0, a1, b1, c0, c1,
                                  st);
  if (err != cudaSuccess || n_sums == 0) return static_cast<int>(err);
  return static_cast<int>(sum_units(work, c, static_cast<const int4*>(sums),
                                    n_sums, slots, batch, c0, c1, st));
}
