// Truncated 2-D Cauchy product of f32 matrices on Hopper's tensor cores
// (sm_90a), with the j0 sum taken in residue-major order, K4b:
//
//     c[k0, k1] = sum_{r < 8} sum_{q} sum_{j1} a[k0 - j0, k1 - j1] * b[j0, j1],
//     j0 = r + 8 q
//
// Replaces the TPU kernel genfer_tpu/ops/pallas_conv2d.py::_build2d_grouped
// (j0 visited by residue class mod 8, so that every a window of a class
// starts 8-row aligned and one slab load serves the class).  The order is
// the kernel's defining property and is kept, inside every staged group of
// 16 j0 rows of a work unit; on this card it buys window reuse by another
// mechanism.  In the m16n8k8 A fragment a thread holds rows g and g + 8 of
// each 16-row mma tile, and stepping j0 by 8 moves the a window down by
// exactly 8 rows: the A operand is carried in registers from one j0 of a
// class to the next, and only the top 8 rows are loaded (conv2d_mma.cuh,
// ORDER = RESIDUE).  B fragments are fresh per j0 either way.  Whether
// the order gains or loses against the tile kernel
// (conv2d_trunc_f32_tile.cu) is a measurement (PERF.md).  It equals that
// kernel to f32 rounding, not bit for bit.
//
// What bounds it: TF32 tensor-core multiply-adds, three per f32
// multiply-add; the schedule is the tile kernel's (work units of
// ops/conv2d.py::unit_plan(cut_j1=False), a plain grid, slots added in
// order: the same bits on any card and from call to call).
//
// Which shapes take which body: as in the tile kernel.  b of at least 8
// columns, the tensor-core body; fewer, conv2d_unit.cuh's FFMA body (CJ =
// 1 for one column, else 8) with j0 ascending: a class of one thin row
// has no fragment to carry.
//
// conv2d_trunc_f32_grouped_1pass is the same kernel at one pass:
// _build2d_grouped at highest=False.  For b of at least 8 columns the entry
// rounds both operands once into scratch, as the one-pass tile entry does,
// and runs conv2d_wgmma.cuh's body on them in residue-major order (RESIDUE:
// a chain per class over both its j0 of a stage, dj = r then r + 8; the
// descriptor's start steps with dj, so the order needs no copy); for a
// thinner b, the FFMA body on operands it rounds itself (conv2d_unit.cuh,
// TF32).  It equals the one-pass tile kernel to f32 rounding.

#include "conv2d_mma.cuh"
#include "conv2d_wgmma.cuh"

namespace {

// CJ = 0: the split-TF32 body (three passes); CJ = 1 or 8: conv2d_unit.cuh's
// FFMA body with chunks of CJ columns of b, on TF32-rounded operands where
// TF32 (the one-pass mode)
template <int CJ, bool VEC, bool TF32>
__global__ void __launch_bounds__(NT, CJ == 0 ? 2 : 3)
conv2d_trunc_f32_grouped_kernel(const float* __restrict__ a,
                                const float* __restrict__ b,
                                float* __restrict__ c, float* __restrict__ work,
                                const int4* __restrict__ units, int a0, int a1,
                                int b1, int c0, int c1) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (CJ == 0)
    run_mma_unit<RESIDUE>(a, b, c, work, units, blockIdx.x, a0, a1, b1, c0,
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
  auto kernel = conv2d_trunc_f32_grouped_kernel<CJ, VEC, TF32>;
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
      err = round_and_run_wgmma<RESIDUE>(a, b, c, work, u, n_units, a0, a1,
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
extern "C" int conv2d_trunc_f32_grouped(
    const float* a, const float* b, float* c, float* work, const void* units,
    int n_units, const void* sums, int n_sums, int a0, int a1, int b1, int c0,
    int c1, void* stream) {
  return entry<3>(a, b, c, work, units, n_units, sums, n_sums, a0, a1, b1,
                  c0, c1, stream);
}

// The one-pass mode (highest=False): the same arguments and table, then
// b's row count ``b0`` and ``scratch``, as conv2d_trunc_f32_tile_1pass
// takes them (scratch unused, and may be null, for b1 < 8).
extern "C" int conv2d_trunc_f32_grouped_1pass(
    const float* a, const float* b, float* c, float* work, const void* units,
    int n_units, const void* sums, int n_sums, int a0, int a1, int b1, int c0,
    int c1, void* stream, int b0, float* scratch) {
  return entry<1>(a, b, c, work, units, n_units, sums, n_sums, a0, a1, b1,
                  c0, c1, stream, b0, scratch);
}
