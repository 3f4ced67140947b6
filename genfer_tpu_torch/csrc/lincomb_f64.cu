// A sum of two padded, scaled and shifted f64 coefficient tensors, in one
// pass: for every row r and index i of the result (rows x n[0] x ... x
// n[axes-1], contiguous),
//
//     out[r, i] = ta - tb  (sub)   or   ta + tb   (or ta alone, no b)
//     ta = alpha[r] * a[r, i - pa]   if 0 <= i - pa < the extents of a,
//                                    else +0.0
//     tb = beta[r] * b[r, i - pb]    likewise
//
// with a factor left out where it is absent.  These are the coefficients
// TaylorPoly's sums make in the compiled walk (ops/lincomb_f64.py): a
// padded add or sub (no factors), ``mul_var`` (a at offset 1 along one
// axis, times m, no b) and ``mul_linear``'s ``G * m`` at that offset plus
// ``c * G``.  Op by op these were a fill and a copy for each padded
// operand, a strided multiply, and the add: about 104 bytes of traffic an
// output word of ``mul_linear`` where reading G once and writing the
// result once take 16.  It replaces no TPU kernel: under ``jit`` XLA fused
// the JAX walk's pad, scale and add.
//
// Bits: each output is the same chain of IEEE roundings as the op-by-op
// sequence, __dmul_rn for a product, then one __dadd_rn or __dsub_rn (no
// FMA contraction).  An index outside an operand contributes +0.0, as the
// pad's zeros do; a - b with b padded is a - (+0.0), what a + (-(+0.0))
// gives (a factor of -1 on b would turn a -0.0 of a into +0.0 there).
//
// What bounds it on the H100: bytes.  One thread an output word, LC_PER
// words a thread LC_THREADS apart, so that each of a warp's loads and its
// store covers consecutive words along the last axis; an index is split
// into its coordinates by multiplicative division (no divide
// instruction); operands are read through their strides (the walk's
// truncations are views), the row strides 0 where one row serves all.
// All of a thread's loads are issued before its first product.  Nothing
// but the kernel is launched, and nothing is allocated: safe under CUDA
// graph capture.
//
// Axes: the main path's 1 to 3 are unrolled; more (up to LC_AXES, which
// no result below 2^31 words can pass once its axes of extent 1 are
// dropped) take the same body with the axes as a loop.  One launch
// indexes fewer than 2^31 words; the wrapper launches a larger result in
// chunks of rows.

#include <climits>
#include <cstddef>

#include <cuda_runtime.h>

namespace {

constexpr int LC_AXES = 30;      // coefficient axes at most
constexpr int LC_THREADS = 256;  // threads a block
constexpr int LC_PER = 4;        // output words a thread

}  // namespace

// The launch's operands, as ops/lincomb_f64.py's ``_Args`` lays them out.
// Strides and extents are in words; a row stride is 0 where one row (or
// one factor) serves every row.  An absent b, alpha or beta is null.
struct LincombArgs {
  const double* a;
  const double* b;
  const double* alpha;
  const double* beta;
  double* out;
  long long a_row, b_row, alpha_row, beta_row;
  long long a_stride[LC_AXES], b_stride[LC_AXES];
  int a_len[LC_AXES], b_len[LC_AXES];
  int a_pre[LC_AXES], b_pre[LC_AXES];
  int len[LC_AXES];
  int axes, rows, sub;
};

namespace {

// n / d for n < 2^31 by a multiply and a shift (the divider of PyTorch's
// TensorIterator): m and s from d on the host.
struct FastDiv {
  unsigned d, m, s;
};

FastDiv fast_div(unsigned d) {
  unsigned s = 0;
  while (s < 32 && (1ull << s) < d) ++s;
  const unsigned long long m =
      ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return {d, static_cast<unsigned>(m), s};
}

__device__ __forceinline__ unsigned div_of(unsigned n, const FastDiv& f) {
  return (__umulhi(n, f.m) + n) >> f.s;
}

struct LincombParams {
  LincombArgs p;
  FastDiv div[LC_AXES];
  unsigned total;
};

// AXES coefficient axes, unrolled; 0: p.axes of them, as a loop.
template <int AXES>
__global__ void __launch_bounds__(LC_THREADS)
lincomb_f64_kernel(const __grid_constant__ LincombParams q) {
  const LincombArgs& p = q.p;
  const int axes = AXES > 0 ? AXES : p.axes;
  const unsigned base = blockIdx.x * (LC_THREADS * LC_PER) + threadIdx.x;
  double va[LC_PER], vb[LC_PER], fa[LC_PER], fb[LC_PER];
  bool ia[LC_PER], ib[LC_PER];
#pragma unroll
  for (int k = 0; k < LC_PER; ++k) {
    const unsigned idx = base + k * LC_THREADS;
    const bool live = idx < q.total;
    unsigned rest = live ? idx : 0;
    long long oa = 0, ob = 0;
    bool in_a = live, in_b = live && p.b != nullptr;
#pragma unroll
    for (int d = axes - 1; d >= 0; --d) {
      const unsigned next = div_of(rest, q.div[d]);
      const int c = static_cast<int>(rest - next * q.div[d].d);
      rest = next;
      const int ja = c - p.a_pre[d], jb = c - p.b_pre[d];
      in_a = in_a && ja >= 0 && ja < p.a_len[d];
      in_b = in_b && jb >= 0 && jb < p.b_len[d];
      oa += static_cast<long long>(ja) * p.a_stride[d];
      ob += static_cast<long long>(jb) * p.b_stride[d];
    }
    const long long r = rest;  // the row
    ia[k] = in_a;
    ib[k] = in_b;
    va[k] = in_a ? __ldg(p.a + r * p.a_row + oa) : 0.0;
    vb[k] = in_b ? __ldg(p.b + r * p.b_row + ob) : 0.0;
    fa[k] = p.alpha != nullptr && in_a ? __ldg(p.alpha + r * p.alpha_row)
                                       : 1.0;
    fb[k] = p.beta != nullptr && in_b ? __ldg(p.beta + r * p.beta_row)
                                      : 1.0;
  }
#pragma unroll
  for (int k = 0; k < LC_PER; ++k) {
    const unsigned idx = base + k * LC_THREADS;
    if (idx >= q.total) break;
    double t = ia[k] ? (p.alpha != nullptr ? __dmul_rn(va[k], fa[k]) : va[k])
                     : 0.0;
    if (p.b != nullptr) {
      const double tb =
          ib[k] ? (p.beta != nullptr ? __dmul_rn(fb[k], vb[k]) : vb[k])
                : 0.0;
      t = p.sub ? __dsub_rn(t, tb) : __dadd_rn(t, tb);
    }
    p.out[idx] = t;
  }
}

template <int AXES>
void launch(const LincombParams& q, unsigned blocks, cudaStream_t stream) {
  lincomb_f64_kernel<AXES><<<blocks, LC_THREADS, 0, stream>>>(q);
}

}  // namespace

// Launches on ``stream``; returns the CUDA error of the launch (0 when it
// was accepted, or when the result is empty).  1 <= axes <= LC_AXES, every
// extent >= 0 and rows x the extents of out < 2^31; out is contiguous.
extern "C" int lincomb_f64(const LincombArgs* args, void* stream) {
  LincombParams q;
  q.p = *args;
  const int axes = args->axes;
  if (axes < 1 || axes > LC_AXES || args->rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned long long total = static_cast<unsigned long long>(args->rows);
  for (int d = 0; d < LC_AXES; ++d) {
    const int n = d < axes ? args->len[d] : 1;
    if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
    total *= static_cast<unsigned long long>(n);
    q.div[d] = fast_div(n > 0 ? static_cast<unsigned>(n) : 1u);
  }
  if (total == 0) return 0;
  if (total > static_cast<unsigned long long>(INT_MAX))
    return static_cast<int>(cudaErrorInvalidValue);
  q.total = static_cast<unsigned>(total);
  const unsigned per_block = LC_THREADS * LC_PER;
  const unsigned blocks =
      static_cast<unsigned>((total + per_block - 1) / per_block);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (axes) {
    case 1: launch<1>(q, blocks, s); break;
    case 2: launch<2>(q, blocks, s); break;
    case 3: launch<3>(q, blocks, s); break;
    default: launch<0>(q, blocks, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
