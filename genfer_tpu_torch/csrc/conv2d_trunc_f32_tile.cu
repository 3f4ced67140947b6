// Truncated 2-D Cauchy product of f32 matrices on Hopper's tensor cores
// (sm_90a), K4a:
//
//     c[k0, k1] = sum_{j0 < b0, j1 < b1} a[k0 - j0, k1 - j1] * b[j0, j1]
//
// Replaces the TPU kernel genfer_tpu/ops/pallas_conv2d.py::_build2d: one
// program per 128x128 output tile, j0 ascending, every j0 a matrix-unit
// product of an a window with a Toeplitz tile of one b row at
// Precision.HIGHEST (several bf16 passes, f32 accumulate).  Hopper's
// counterpart of that is a split-precision product on the tensor cores:
// conv2d_mma.cuh, three TF32 mma.sync passes over operands split into a
// high and a scaled low part, j0 ascending inside a unit.
//
// What bounds it on the H100: TF32 tensor-core multiply-adds (three per
// f32 multiply-add), and the schedule.  One block per output tile, as on
// the TPU, leaves the card's 132 SMs to 64 very unequal blocks at order
// 512; here the product is cut into work units of about equal
// multiply-add count by ops/conv2d.py::unit_plan(cut_j1=False): j0 ranges
// only, because a unit of n1 columns of b contracts over n1 + 63 columns
// of a.  The table is sorted heaviest first and the kernel is a plain grid
// over it; a tile's units own consecutive workspace slots, added in slot
// order by sum_units_kernel: the same bits on any card and from call to
// call.  It equals the FFMA kernel (conv2d_trunc_f32.cu) to f32 rounding.
//
// Which shapes take which body (the wrapper passes the smaller operand as
// b): b of at least 8 columns, the tensor-core body; a one-column b,
// conv2d_unit.cuh's FFMA body with CJ = 1; 2 to 7 columns, the same with
// CJ = 8 (a band narrower than one mma tile would be mostly zeros).
//
// conv2d_trunc_f32_tile_1pass is the one-pass mode: _build2d at
// highest=False (Precision.DEFAULT, one bf16 pass on the TPU), here one
// TF32 pass.  For b of at least 8 columns the entry rounds both operands
// once into scratch (conv2d_wgmma.cuh's tf32_round_operands_kernel) and
// runs conv2d_wgmma.cuh's body on them (wgmma m64n64k8, the tile product
// transposed, the a window read from shared memory); for a thinner b, the
// FFMA body on operands it rounds itself (conv2d_unit.cuh, TF32).
// ops/conv2d.py also launches it for conv2d_trunc_f32(..., highest=False):
// the row strip's one-pass mode.

#include "conv2d_mma.cuh"
#include "conv2d_wgmma.cuh"

namespace {

// CJ = 0: the split-TF32 body (three passes); CJ = 1 or 8: conv2d_unit.cuh's
// FFMA body with chunks of CJ columns of b, on TF32-rounded operands where
// TF32 (the one-pass mode)
template <int CJ, bool VEC, bool TF32>
__global__ void __launch_bounds__(NT, CJ == 0 ? 2 : 3)
conv2d_trunc_f32_tile_kernel(const float* __restrict__ a,
                             const float* __restrict__ b,
                             float* __restrict__ c, float* __restrict__ work,
                             const int4* __restrict__ units, int a0, int a1,
                             int b1, int c0, int c1) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (CJ == 0)
    run_mma_unit<ASCENDING>(a, b, c, work, units, blockIdx.x, a0, a1, b1, c0,
                            c1, smem);
  else
    run_unit<CJ, VEC, TF32>(a, b, c, work, units, blockIdx.x, a0, a1, b1, c0,
                            c1, smem);
}

template <int CJ, bool VEC, bool TF32>
cudaError_t launch(const float* a, const float* b, float* c, float* work,
                   const int4* units, int n_units, int a0, int a1, int b1,
                   int c0, int c1, cudaStream_t st) {
  static bool allowed[64] = {};
  constexpr size_t smem = CJ == 0 ? MmaGeo::SMEM : Geo<CJ ? CJ : 1>::SMEM;
  auto kernel = conv2d_trunc_f32_tile_kernel<CJ, VEC, TF32>;
  const cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<n_units, NT, smem, st>>>(a, b, c, work, units, a0, a1, b1, c0, c1);
  return cudaGetLastError();
}

// The launches of one call at PASSES passes: the body the shapes take,
// then the slot sum.  At one pass with b1 >= 8, first the rounding of both
// operands into ``scratch`` (b0 rows of b), which the wgmma body reads.
template <int PASSES>
int entry(const float* a, const float* b, float* c, float* work,
          const void* units, int n_units, const void* sums, int n_sums,
          int a0, int a1, int b1, int c0, int c1, void* stream, int b0 = 0,
          float* scratch = nullptr) {
  constexpr bool TF32 = PASSES == 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4* u = static_cast<const int4*>(units);
  const bool vec = aligned16(a) && a1 % 4 == 0;
  cudaError_t err;
  if (b1 >= MMA_MIN_COLS) {
    if constexpr (TF32)
      err = round_and_run_wgmma<ASCENDING>(a, b, c, work, u, n_units, a0, a1,
                                           b0, b1, c0, c1, scratch, st);
    else
      err = launch<0, false, false>(a, b, c, work, u, n_units, a0, a1, b1,
                                    c0, c1, st);
  } else if (b1 == 1)
    err = vec ? launch<1, true, TF32>(a, b, c, work, u, n_units, a0, a1, b1,
                                      c0, c1, st)
              : launch<1, false, TF32>(a, b, c, work, u, n_units, a0, a1, b1,
                                       c0, c1, st);
  else
    err = vec ? launch<8, true, TF32>(a, b, c, work, u, n_units, a0, a1, b1,
                                      c0, c1, st)
              : launch<8, false, TF32>(a, b, c, work, u, n_units, a0, a1, b1,
                                       c0, c1, st);
  if (err != cudaSuccess || n_sums == 0) return static_cast<int>(err);
  return static_cast<int>(sum_units(work, c, static_cast<const int4*>(sums),
                                    n_sums, 0, 1, c0, c1, st));
}

}  // namespace

// Launches on ``stream``; returns the first non-zero CUDA error (0 when
// every launch was accepted).  The arguments are those of
// conv2d_trunc_f32 (conv2d_trunc_f32.cu), with ``units`` and ``sums`` from
// ops/conv2d.py::unit_plan(cut_j1=False).
extern "C" int conv2d_trunc_f32_tile(
    const float* a, const float* b, float* c, float* work, const void* units,
    int n_units, const void* sums, int n_sums, int a0, int a1, int b1, int c0,
    int c1, void* stream) {
  return entry<3>(a, b, c, work, units, n_units, sums, n_sums, a0, a1, b1,
                  c0, c1, stream);
}

// The one-pass mode (highest=False): the same arguments and table, then
// b's row count ``b0`` and ``scratch``.  For b1 >= 8 the entry rounds both
// operands into scratch first (one launch: a0 x (a1 + 3) / 4 * 4 words,
// then b0 x (b1 + 3) / 4 * 4, 16-byte aligned); for a thinner b scratch
// is unused and may be null.
extern "C" int conv2d_trunc_f32_tile_1pass(
    const float* a, const float* b, float* c, float* work, const void* units,
    int n_units, const void* sums, int n_sums, int a0, int a1, int b1, int c0,
    int c1, void* stream, int b0, float* scratch) {
  return entry<1>(a, b, c, work, units, n_units, sums, n_sums, a0, a1, b1,
                  c0, c1, stream, b0, scratch);
}

// The rounding kernel alone (tf32_round_operands_kernel, as the one-pass
// entries launch it) on ``stream``: a (a_rows x a_cols) into ra (a_rows x
// a_pitch), b (b_rows x b_cols) into rb (b_rows x b_pitch); returns the
// CUDA error of the launch.
extern "C" int tf32_round_operands(const float* a, float* ra,
                                   long long a_rows, int a_cols, int a_pitch,
                                   const float* b, float* rb,
                                   long long b_rows, int b_cols, int b_pitch,
                                   void* stream) {
  return static_cast<int>(round_operands(a, ra, a_rows, a_cols, a_pitch, b,
                                         rb, b_rows, b_cols, b_pitch,
                                         static_cast<cudaStream_t>(stream)));
}
