// A constant spine of the GF DAG in IEEE f64, in one launch: for every row
// r (one series of n coefficients, flat row-major) and every link l in
// order, with v = c[r, src[l]],
//
//     bit l of adds set:  x[r, 0] = x[r, 0] + v     (an Add link)
//     else:               x[r, j] = x[r, j] * v     (a Mul link, every j)
//
// the operations TaylorPoly's ``G + c`` (_add_at_zero) and ``G * c`` do for
// a 0-d constant c, one link at a time in the compiled walk.  It replaces no
// TPU kernel: on the TPU the JAX walk's chain ran under ``jit``, and XLA
// fused the elementwise ops of its links.  Here the walk is a CUDA graph of
// PyTorch launches, and digitRecognition's 784 observations a class,
// 1,568 links, cost ~4,600 launches (ops/spine_f64.py's plain version is
// that loop).
//
// What bounds it on the H100: at the main path's shape (1024 rows, 11
// coefficients, 1,568 links) the bytes of the constants, 1024 x 1,568 x 8
// B = 12.8 MB (3.8 us at 3.35 TB/s), and, longer, the chain itself: each
// output is 1,568 dependent f64 operations, so no layout brings the time
// below 1,568 times the latency of one DMUL (a pure DMUL chain of that
// length took 17 us on the card, its rows alone as long as all 1024).  The
// design:
//
//   * one thread a (row, coefficient), its value in a register for the
//     whole chain; CT = the next power of two >= n (at most 32) threads a
//     row, min(8, 128 / CT) rows a block of 128 threads (those past the
//     rows only stage constants), more coefficients on grid.y;
//   * a block stages its rows' constants in shared memory 256 links at a
//     time (a row in 257 words, so that the rows a warp reads fall on
//     different banks), read through ``src`` by consecutive threads along
//     a row; the next stage is loaded into registers while the current one
//     is applied, so its loads wait under the chain; a row's CT threads
//     read each constant by broadcast;
//   * a link costs the chain one DMUL or DADD and two selects: both
//     results are made and one kept, no branch; the flags come one 32-bit
//     word (L1-cached, off the chain) for 32 links.  Layouts with a warp a
//     coefficient, cp.async staging and a select-free path for (Mul, Add)
//     pairs were tried and were no faster at both of the main path's
//     shapes (PERF.md section 6);
//   * __dmul_rn / __dadd_rn: no FMA contraction across a Mul and the next
//     Add, so every output is the loop's chain of roundings, bit for bit.

#include <climits>
#include <cstddef>

#include <cuda_runtime.h>

namespace {

constexpr int SPINE_NT = 128;     // threads a block
constexpr int SPINE_CHUNK = 256;  // links a stage
constexpr int SPINE_ROWS = 8;     // rows a block at most
constexpr int SPINE_STRIDE = SPINE_CHUNK + 1;  // words a staged row
// a thread's share of a stage of SPINE_ROWS rows
constexpr int SPINE_PER = SPINE_ROWS * SPINE_CHUNK / SPINE_NT;

// Thread ``threadIdx.x``'s share of the stage of links [l0, l0 +
// SPINE_CHUNK) of the block's rpb rows, into registers (0.0 past the
// rows or the links).
__device__ __forceinline__ void spine_load(
    double (&pre)[SPINE_PER], const double* __restrict__ c,
    long long c_stride, const int* __restrict__ src, int rows, int links,
    int rpb, int row0, int l0) {
#pragma unroll
  for (int k = 0; k < SPINE_PER; ++k) {
    const int i = k * SPINE_NT + threadIdx.x;
    const int r = i / SPINE_CHUNK;
    const int l = l0 + i % SPINE_CHUNK;
    pre[k] = r < rpb && row0 + r < rows && l < links
                 ? c[static_cast<size_t>(row0 + r) * c_stride + src[l]]
                 : 0.0;
  }
}

// One link: both results are made from acc at once and one is kept, so
// the chain waits on one DMUL or DADD a link and no branch.  An Add link
// leaves every coefficient but the first as it is.
__device__ __forceinline__ double spine_link(double acc, double v, bool add,
                                             bool lead) {
  const double p = __dmul_rn(acc, v);
  const double s = __dadd_rn(acc, v);
  return add ? (lead ? s : acc) : p;
}

__global__ void __launch_bounds__(SPINE_NT)
spine_f64_kernel(const double* __restrict__ x, long long x_stride,
                 const double* __restrict__ c, long long c_stride,
                 const int* __restrict__ src,
                 const unsigned* __restrict__ adds, double* __restrict__ out,
                 int rows, int n, int links, int ct_log2, int rpb) {
  __shared__ double stage[SPINE_ROWS * SPINE_STRIDE];
  const int tid = threadIdx.x;
  const int ty = tid >> ct_log2;
  const int j = (blockIdx.y << ct_log2) + (tid & ((1 << ct_log2) - 1));
  const int row0 = blockIdx.x * rpb;
  // a block of few rows has threads that only stage constants
  const bool live = ty < rpb && row0 + ty < rows && j < n;
  const bool lead = j == 0;
  double acc =
      live ? x[static_cast<size_t>(row0 + ty) * x_stride + j] : 0.0;

  // the next stage's constants wait in registers while a stage is applied
  double pre[SPINE_PER];
  spine_load(pre, c, c_stride, src, rows, links, rpb, row0, 0);
  for (int l0 = 0; l0 < links; l0 += SPINE_CHUNK) {
    __syncthreads();  // the previous stage has been applied
#pragma unroll
    for (int k = 0; k < SPINE_PER; ++k) {
      const int i = k * SPINE_NT + tid;
      stage[i / SPINE_CHUNK * SPINE_STRIDE + i % SPINE_CHUNK] = pre[k];
    }
    __syncthreads();
    if (l0 + SPINE_CHUNK < links)
      spine_load(pre, c, c_stride, src, rows, links, rpb, row0,
                 l0 + SPINE_CHUNK);
    if (!live) continue;
    const double* cr = stage + ty * SPINE_STRIDE;
    const int len = min(SPINE_CHUNK, links - l0);
    int q = 0;
    for (; q + 32 <= len; q += 32) {  // a flag word's 32 links
      const unsigned bits = __ldg(adds + ((l0 + q) >> 5));
#pragma unroll
      for (int b = 0; b < 32; ++b)
        acc = spine_link(acc, cr[q + b], (bits >> b) & 1u, lead);
    }
    for (; q < len; ++q)  // the last links, fewer than a word's
      acc = spine_link(acc, cr[q],
                       (__ldg(adds + ((l0 + q) >> 5)) >> (q & 31)) & 1u,
                       lead);
  }
  if (live) out[static_cast<size_t>(row0 + ty) * n + j] = acc;
}

}  // namespace

// Launches on ``stream``; returns the CUDA error of the launch (0 when it
// was accepted).  x holds rows x n f64 (x_stride n) or one row read by
// every row (x_stride 0); c rows x m (c_stride m) or one row (c_stride 0);
// src (int32, links) the column of c each link reads, every one < m; adds
// ceil(links / 32) words, bit l % 32 of word l / 32 set for an Add link;
// out rows x n, contiguous, every word written.  All on the current
// device; rows, n >= 1, links >= 0.
extern "C" int spine_f64(const double* x, long long x_stride, const double* c,
                         long long c_stride, const int* src,
                         const unsigned* adds, double* out, int rows, int n,
                         int links, void* stream) {
  int ct_log2 = 0;  // CT = the next power of two >= n, at most 32
  while ((1 << ct_log2) < n && ct_log2 < 5) ++ct_log2;
  const int rpb = (SPINE_NT >> ct_log2) < SPINE_ROWS ? SPINE_NT >> ct_log2
                                                     : SPINE_ROWS;
  const long long blocks = (static_cast<long long>(rows) + rpb - 1) / rpb;
  const long long cols = (static_cast<long long>(n) + (1 << ct_log2) - 1) >>
                         ct_log2;
  if (blocks > INT_MAX || cols > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(cols));
  spine_f64_kernel<<<grid, SPINE_NT, 0, static_cast<cudaStream_t>(stream)>>>(
      x, x_stride, c, c_stride, src, adds, out, rows, n, links, ct_log2, rpb);
  return static_cast<int>(cudaGetLastError());
}
