// A batch of truncated 2-D Cauchy products in one TF32 pass on Hopper's
// tensor cores (sm_90a), the one-pass twin of K3: for every batch entry g,
//
//     c[g, k0, k1] = sum_{j0, j1} A_g[k0 - j0, k1 - j1] * B_g[j0, j1],
//     A_g = tf32(a_g), B_g = tf32(b_g)
//
// with a_g = a + g * a_stride and b_g = b + g * b_stride (one operand the
// batch, the other shared at stride 0, in either order), every product
// exact in f32 and the sums in f32.
//
// Replaces the TPU kernel genfer_tpu/ops/pallas_conv2d.py::_build2d_batched
// at highest=False (Precision.DEFAULT: one bf16 pass on the TPU's matrix
// unit; one TF32 pass here, 10 stored mantissa bits to bf16's 7).  K3
// (conv2d_trunc_f32_batched.cu) runs IEEE f32 FMAs; its one-pass mode has
// no FMA to drop, so it runs the one-pass tile kernel's unit code instead
// (conv2d_wgmma.cuh: wgmma on operands that the entry rounds once a call,
// the batched operand and the shared one in one launch of
// tf32_round_operands_kernel; conv2d_unit.cuh's FFMA body on
// TF32-rounded operands for a b of fewer than 8 columns) on that kernel's
// table (ops/conv2d.py::unit_plan(cut_j1=False)), with K3's grid: one
// block per (unit, entry), unit-major, so the card works through every
// entry's heavy units first.  A tile's units are added in slot order by
// sum_units per entry, so every entry equals the single-pair one-pass
// product (conv2d_trunc_f32_tile_1pass) bit for bit.
//
// What bounds it: TF32 tensor-core multiply-adds, one per f32 multiply-add.

#include <climits>

#include "conv2d_mma.cuh"
#include "conv2d_wgmma.cuh"

namespace {

// CJ = 0: the wgmma body on rounded operands; CJ = 1 or 8:
// conv2d_unit.cuh's FFMA body on TF32-rounded operands, with chunks of CJ
// columns of b
template <int CJ, bool VEC>
__global__ void __launch_bounds__(NT, CJ == 0 ? 2 : 3)
conv2d_trunc_f32_batched_1pass_kernel(const float* __restrict__ a,
                                      const float* __restrict__ b,
                                      float* __restrict__ c,
                                      float* __restrict__ work,
                                      const int4* __restrict__ units,
                                      int batch, int slots, size_t a_stride,
                                      size_t b_stride, int a0, int a1, int b1,
                                      int c0, int c1) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int u = blockIdx.x / batch;
  const size_t g = blockIdx.x - u * batch;
  const float* ag = a + g * a_stride;
  const float* bg = b + g * b_stride;
  float* cg = c + g * c0 * c1;
  float* wg = work + g * slots * TILE_WORDS;
  if constexpr (CJ == 0)
    run_wgmma_unit<ASCENDING>(ag, bg, cg, wg, units, u, a0, a1, b1, c0, c1,
                              smem);
  else
    run_unit<CJ, VEC, true>(ag, bg, cg, wg, units, u, a0, a1, b1, c0, c1,
                            reinterpret_cast<float*>(smem));
}

template <int CJ, bool VEC>
cudaError_t launch(const float* a, const float* b, float* c, float* work,
                   const int4* units, int n_units, int batch, int slots,
                   size_t a_stride, size_t b_stride, int a0, int a1, int b1,
                   int c0, int c1, cudaStream_t st) {
  static bool allowed[64] = {};
  constexpr size_t smem = CJ == 0 ? WgGeo::SMEM : Geo<CJ ? CJ : 1>::SMEM;
  auto kernel = conv2d_trunc_f32_batched_1pass_kernel<CJ, VEC>;
  const cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(n_units) * batch, NT, smem, st>>>(
      a, b, c, work, units, batch, slots, a_stride, b_stride, a0, a1, b1, c0,
      c1);
  return cudaGetLastError();
}

}  // namespace

// Launches on ``stream``; returns the first non-zero CUDA error.  The
// arguments are those of conv2d_trunc_f32_batched
// (conv2d_trunc_f32_batched.cu), with ``units`` and ``sums`` from
// ops/conv2d.py::unit_plan(cut_j1=False) for one pair, then b's row count
// ``b0`` and ``scratch``.  For b1 >= 8 the entry first rounds both operands
// into scratch (one launch: the rows of a, a0 of them or batch x a0 where
// a is the batched one, (a1 + 3) / 4 * 4 words apart; then b's the same
// way), which the wgmma body reads; for a thinner b scratch is unused.
extern "C" int conv2d_trunc_f32_batched_1pass(
    const float* a, const float* b, float* c, float* work, const void* units,
    int n_units, const void* sums, int n_sums, int slots, size_t a_stride,
    size_t b_stride, int batch, int a0, int a1, int b1, int c0, int c1,
    void* stream, int b0, float* scratch) {
  if (static_cast<long long>(batch) * n_units > INT_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4* u = static_cast<const int4*>(units);
  // every entry's rows are 16-byte aligned when the first one's are
  const bool vec = aligned16(a) && a1 % 4 == 0;
  cudaError_t err;
  if (b1 >= MMA_MIN_COLS) {
    const long long a_rows = a_stride ? static_cast<long long>(batch) * a0
                                      : a0;
    const long long b_rows = b_stride ? static_cast<long long>(batch) * b0
                                      : b0;
    const Rounded r = round_into(a, a_rows, a1, b, b_rows, b1, scratch, st);
    const size_t ra_stride = a_stride ? static_cast<size_t>(a0) *
                                            ((a1 + 3) & ~3)
                                      : 0;
    const size_t rb_stride = b_stride ? static_cast<size_t>(b0) *
                                            ((b1 + 3) & ~3)
                                      : 0;
    err = r.err != cudaSuccess
              ? r.err
              : launch<0, false>(r.a, r.b, c, work, u, n_units, batch, slots,
                                 ra_stride, rb_stride, a0, a1, b1, c0, c1,
                                 st);
  } else if (b1 == 1)
    err = vec ? launch<1, true>(a, b, c, work, u, n_units, batch, slots,
                                a_stride, b_stride, a0, a1, b1, c0, c1, st)
              : launch<1, false>(a, b, c, work, u, n_units, batch, slots,
                                 a_stride, b_stride, a0, a1, b1, c0, c1, st);
  else
    err = vec ? launch<8, true>(a, b, c, work, u, n_units, batch, slots,
                                a_stride, b_stride, a0, a1, b1, c0, c1, st)
              : launch<8, false>(a, b, c, work, u, n_units, batch, slots,
                                 a_stride, b_stride, a0, a1, b1, c0, c1, st);
  if (err != cudaSuccess || n_sums == 0) return static_cast<int>(err);
  return static_cast<int>(sum_units(work, c, static_cast<const int4*>(sums),
                                    n_sums, slots, batch, c0, c1, st));
}
