// Pieces the two kernels of K5, the ozaki route (ozaki_split.cu and
// ozaki_conv2d.cu), share: the chunk geometry of
// genfer_tpu_torch/ops/ozaki_conv.py and an exact power of two.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int OZ_CHUNK_BITS = 7;  // ops/ozaki_conv.py::CHUNK_BITS
constexpr int OZ_N_CHUNKS = 8;    // ops/ozaki_conv.py::N_CHUNKS

// 2^e exactly, from the bits: subnormal down to 2^-1074, 0 below it, inf
// above 2^1023 (what an exact exp2 of the integer e rounds to)
__device__ __forceinline__ double pow2(int e) {
  if (e > 1023) return __longlong_as_double(0x7ff0000000000000LL);
  if (e >= -1022)
    return __longlong_as_double(static_cast<long long>(e + 1023) << 52);
  if (e >= -1074) return __longlong_as_double(1LL << (e + 1074));
  return 0.0;
}

}  // namespace
