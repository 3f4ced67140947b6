// Pieces the two kernels of K5, the ozaki route (ozaki_split.cu and
// ozaki_conv2d.cu), share: the chunk geometry of
// genfer_tpu_torch/ops/ozaki_conv.py, the chunk layout the split writes and
// K5 stages, an exact power of two and an exact integer to f64.
//
// The chunk layout.  Each operand's chunks are [batch][n_t][cols][P], P =
// rows rounded up to a multiple of OZ_PIECE_ROWS (ozaki_conv.py::
// padded_rows), the padding zero: every column's rows are contiguous, so
// that K5 copies them in 16-byte pieces of whole rows.  b's column holds
// row r at position r; a's holds it at P - 1 - r (reversed), so that the
// window of a's column a K5 stage multiplies, rows R0, R0 - 1, ..., is a
// run of ascending positions from P - 1 - R0.

#pragma once

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int OZ_CHUNK_BITS = 7;    // ops/ozaki_conv.py::CHUNK_BITS
constexpr int OZ_N_CHUNKS = 8;      // ops/ozaki_conv.py::N_CHUNKS
constexpr int OZ_PIECE_ROWS = 16;   // ops/ozaki_conv.py::PIECE_ROWS

__host__ __device__ constexpr int oz_padded(int rows) {
  return (rows + OZ_PIECE_ROWS - 1) / OZ_PIECE_ROWS * OZ_PIECE_ROWS;
}

// 2^e exactly, from the bits: subnormal down to 2^-1074, 0 below it, inf
// above 2^1023 (what an exact exp2 of the integer e rounds to)
__device__ __forceinline__ double pow2(int e) {
  if (e > 1023) return __longlong_as_double(0x7ff0000000000000LL);
  if (e >= -1022)
    return __longlong_as_double(static_cast<long long>(e + 1023) << 52);
  if (e >= -1074) return __longlong_as_double(1LL << (e + 1074));
  return 0.0;
}

// an exact int32 as f64: 2^52 + 2^31 + x in the bits, less 2^52 + 2^31
__device__ __forceinline__ double to_f64(int x) {
  return __hiloint2double(0x43300000, x ^ INT_MIN) - 4503601774854144.0;
}

}  // namespace
