// The split of K5, the ozaki route (genfer_tpu_torch/ops/ozaki_conv.py):
// for one f64 matrix x (rows x cols, row-major), in one launch,
//
//   * each column's power-of-two exponent e = ceil(log2 max|x[:, c]|) + 1
//     (1 for an all-zero column), exact from frexp, and the column scaled
//     by 2^-e exactly (in two steps where 2^-e overflows: a subnormal
//     column max);
//   * the first n_t of its 8 chunks of 7 bits: x * 2^-e = sum_t C_t
//     2^-7(t+1) + R, |C_t| <= 64, written as int8 (or bf16, exact for such
//     integers) to chunks[t][r][c];
//   * a flag: set to 1 where some entry is not finite (the guard of
//     ops/ozaki_conv.py reads it).
//
// Replaces, with ozaki_conv2d.cu, the split of genfer_tpu's
// ops/ozaki_conv.py::ozaki_conv2d_traced (192), which ran in XLA:
// _pow2_colexp (82) and _chunk_int (121).  The chunks equal the plain
// version's (ozaki_split_reference) bit for bit: one conversion of x 2^56
// to int64, rounding half to even as jnp.round does (__double2ll_rn, not
// round()), then c = (i + 2^(shift-1)) >> shift, an arithmetic shift of a
// signed int64, and i -= c * 2^shift, a multiplication (a left shift of a
// negative int64 is undefined in C++17).  genfer_tpu's float split
// (_chunk, 102) runs only in the plain version: it was 0.5-6% slower on the
// card with the same error, and ops/ozaki_conv.py raises for it there.
//
// What bounds it on the H100: bytes (x read once, n_t + 8 bytes an entry
// written at most); a block of 32 x 8 threads owns 32 columns, so each
// warp reads and writes one 32-column row segment (coalesced), and the
// column maximum is reduced through shared memory.

#include <cuda_bf16.h>

#include <cstdint>

#include "ozaki.cuh"

namespace {

constexpr int SPLIT_COLS = 32;  // columns a block: one warp across
constexpr int SPLIT_ROWS = 8;   // warps a block, down the rows

// a chunk (an integer in [-64, 64]) as the impl stores it
template <typename E>
__device__ __forceinline__ E chunk_value(long long c);

template <>
__device__ __forceinline__ int8_t chunk_value<int8_t>(long long c) {
  return static_cast<int8_t>(c);
}

template <>
__device__ __forceinline__ __nv_bfloat16 chunk_value<__nv_bfloat16>(
    long long c) {
  return __float2bfloat16_rn(static_cast<float>(c));
}

template <typename E>
__global__ void __launch_bounds__(SPLIT_COLS * SPLIT_ROWS)
ozaki_split_kernel(const double* __restrict__ x, int rows, int cols,
                   int n_t, E* __restrict__ chunks,
                   int* __restrict__ exps, int* __restrict__ flag) {
  __shared__ double red[SPLIT_ROWS][SPLIT_COLS];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int c = blockIdx.x * SPLIT_COLS + tx;
  double m = 0.0;
  bool finite = true;
  if (c < cols)
    for (int r = ty; r < rows; r += SPLIT_ROWS) {
      const double v = x[static_cast<size_t>(r) * cols + c];
      finite = finite && isfinite(v);
      m = fmax(m, fabs(v));
    }
  if (!finite) atomicOr(flag, 1);
  red[ty][tx] = m;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < SPLIT_ROWS; ++k) m = fmax(m, red[k][tx]);
  if (c >= cols) return;
  int e = 1;
  if (m > 0.0) {
    int ex;
    const double mant = frexp(m, &ex);
    e = ex - (mant == 0.5 ? 1 : 0) + 1;
  }
  if (ty == 0) exps[c] = e;
  // x 2^-e exactly: where 2^-e overflows (a subnormal column max, e <
  // -1023), in two steps that both scale up (ozaki_conv.py::_scale_columns)
  const int up = -e > 1023 ? 1000 : 0;
  const double scale_up = pow2(up);
  const double scale = pow2(-e - up);
  const size_t plane = static_cast<size_t>(rows) * cols;
  for (int r = ty; r < rows; r += SPLIT_ROWS) {
    const size_t at = static_cast<size_t>(r) * cols + c;
    const double xs = __dmul_rn(__dmul_rn(x[at], scale_up), scale);
    long long i = __double2ll_rn(
        __dmul_rn(xs, 72057594037927936.0));  // 2^(7 * 8)
    for (int t = 0; t < n_t; ++t) {
      const int shift = OZ_CHUNK_BITS * (OZ_N_CHUNKS - 1 - t);
      const long long ch = shift ? (i + (1LL << (shift - 1))) >> shift : i;
      i -= ch * (1LL << shift);
      chunks[t * plane + at] = chunk_value<E>(ch);
    }
  }
}

}  // namespace

// Launches on ``stream``; returns the CUDA error of the launch (0 when it
// was accepted).  ``x`` rows x cols f64 on the current device, ``chunks``
// n_t x rows x cols int8 (bf16 where ``bf16``), ``exps`` cols int32,
// ``flag`` one int32 the kernel only sets (the caller zeroes it).
extern "C" int ozaki_split(const double* x, int rows, int cols, int n_t,
                           int bf16, void* chunks, int* exps, int* flag,
                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(SPLIT_COLS, SPLIT_ROWS);
  const unsigned grid = (cols + SPLIT_COLS - 1) / SPLIT_COLS;
  if (bf16)
    ozaki_split_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        x, rows, cols, n_t, static_cast<__nv_bfloat16*>(chunks), exps,
        flag);
  else
    ozaki_split_kernel<int8_t><<<grid, block, 0, st>>>(
        x, rows, cols, n_t, static_cast<int8_t*>(chunks), exps, flag);
  return static_cast<int>(cudaGetLastError());
}
