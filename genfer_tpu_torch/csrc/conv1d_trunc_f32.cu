// Truncated 1-D Cauchy product in IEEE f32 on Hopper (sm_90a):
//
//     c[k] = sum_{j < lb} b[j] * a[k - j],   k < lc,
//
// with a read as zero outside [0, la).
//
// Replaces the TPU kernel genfer_tpu/ops/pallas_conv.py::_build (one
// program per 128-wide output tile, shift-and-accumulate over the b
// scalars read from SMEM, each sliding a window assembled from two aligned
// lane tiles and a dynamic rotate).  The rotate exists for Mosaic's
// aligned vector loads and does not carry over.
//
// Design: one 128-thread block per 128-wide output tile, one output a
// thread.  Per chunk of 128 b values the block stages that chunk and the
// a window it reads (255 values) in shared memory; thread t then reads
// window word t - jj + 127 for b value jj (neighbouring threads on
// neighbouring words, b broadcast).  The j range is cut per tile to where
// a[k - j] is nonzero.  Each chunk is summed on its own before it is added
// to the total, so no f32 accumulator takes more than 128 terms.
//
// What bounds it: nothing at the sizes its callers use.  A length-4096
// product is 8.4e6 multiply-adds and 48 KB of operands, a fraction of a
// microsecond of the card's FMA rate or memory bandwidth, so a call is
// bound by its launch.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int T1 = 128;  // outputs per block = threads
constexpr int J1 = 128;  // b values staged per pass

__global__ void __launch_bounds__(T1)
conv1d_trunc_f32_kernel(const float* __restrict__ a,
                        const float* __restrict__ b, float* __restrict__ c,
                        int la, int lb, int lc) {
  __shared__ float sA[T1 + J1 - 1];
  __shared__ float sB[J1];
  const int K = blockIdx.x * T1;
  const int t = threadIdx.x;
  // a[k - j] is nonzero only for k - j < la, and k < K + T1
  const int j_lo = max(0, K - la + 1);
  const int j_hi = min(lb, K + T1);
  float acc = 0.f;
  for (int jb = j_lo; jb < j_hi; jb += J1) {
    __syncthreads();  // the previous chunk has been read
    // sA[w] = a[K - jb - (J1 - 1) + w]
    for (int e = t; e < T1 + J1 - 1; e += T1) {
      const int ar = K - jb - (J1 - 1) + e;
      sA[e] = (ar >= 0 && ar < la) ? a[ar] : 0.f;
    }
    const int j = jb + t;  // J1 == T1: one b value a thread
    sB[t] = j < j_hi ? b[j] : 0.f;
    __syncthreads();
    const int n = min(J1, j_hi - jb);
    float part = 0.f;
    for (int jj = 0; jj < n; ++jj)
      part = fmaf(sA[t - jj + J1 - 1], sB[jj], part);
    acc += part;
  }
  const int k = K + t;
  if (k < lc) c[k] = acc;
}

static_assert(J1 == T1, "each thread stages one b value");

}  // namespace

// Launches on ``stream``; returns cudaGetLastError().  All lengths >= 1,
// every pointer a contiguous f32 array on the current device.
extern "C" int conv1d_trunc_f32(const float* a, const float* b, float* c,
                                int la, int lb, int lc, void* stream) {
  const unsigned blocks = static_cast<unsigned>((lc + T1 - 1) / T1);
  conv1d_trunc_f32_kernel<<<blocks, T1, 0,
                            static_cast<cudaStream_t>(stream)>>>(a, b, c, la,
                                                                 lb, lc);
  return static_cast<int>(cudaGetLastError());
}
