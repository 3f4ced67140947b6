#!/usr/bin/env python3
"""Tuning probes for the work-unit kernels (K2 ``conv2d_trunc_f32``, K3
``conv2d_trunc_f32_batched``, the tensor-core kernels K4a
``conv2d_trunc_f32_tile`` and K4b ``conv2d_trunc_f32_grouped``, the
1-D kernel K6 ``conv1d_trunc_f32``, the f64 kernel K1
``conv2d_trunc_f64`` and K5, the ozaki route's ``ozaki_conv2d``) on one
CUDA card.

    python3 tune_port.py [PROBE ...] [--tree DIR]

Twenty probes (all, or the numbered ones), each printed with the card's
name and power limit; none of them is on any path of the port.
``--tree DIR`` imports ``genfer_tpu_torch`` from the checkout at DIR (an
unpacked parent commit, or a patched copy of the package, say), whose
kernels are built there, and exits if the package came from elsewhere:
probe 8 (or 20) of two trees run in turns compares their K6 (or their
one-pass bodies).  A tree that holds its own ``chip_smoke.py`` shadows
this one's.

1. the card's f32 FMA ceiling: 16 independent FMA chains a thread, 8
   blocks of 256 threads an SM, no memory traffic.  It is what the
   data-sheet rate behind ``bench.F32_FMA_PER_S`` comes to on this card
   at its power limit;
2. K2's plain grid over the sorted unit table against persistent blocks
   that take units from the same table through an atomic counter (2, 3
   and 4 blocks an SM), at the dense orders, with a check that both give
   the same bits.  The persistent kernel lives only here, in
   ``PERSISTENT_CU``; it runs ``csrc/conv2d_unit.cuh`` as K2 does;
3. K2 and K3 under other constants of ``ops/conv2d.py::unit_plan``
   (``UNIT_TARGET``, ``MIN_ROWS``, ``TAIL_SHARE``, ``TAIL_DIV``), the
   shipped ones first and last;
4. the card's ``mma.sync`` TF32 ceiling: 8 independent m16n8k8
   accumulators a warp, 1 to 4 blocks of four warps an SM, no memory
   traffic.  It is what K4a and K4b could reach at most of the
   data-sheet rate behind ``bench.TF32_MMA_PER_S``, which only ``wgmma``
   reaches;
5. K4a and K4b in a steady state: a grid of identical interior work
   units (16 j0 x 512 columns of b at order 768, every unit on its own
   workspace slot), so that neither the tail of a plan nor its unequal
   units enter: the ``mma`` multiply-adds a second they sustain, as a
   share of probe 4's ceiling;
6. K4a and K4b under other constants of their plan
   (``unit_plan(cut_j1=False)``: ``UNIT_TARGET``, ``MMA_MIN_ROWS``,
   ``TAIL_SHARE``), the shipped ones first and last;
7. K6 under other constants of ``ops/conv1d.py`` (``UNIT_TARGET``,
   ``MIN_DIAG``, ``MIN_UNITS`` of ``fold_plan``; ``MMA_MIN_MACS`` and
   ``MMA_MIN_LEN`` set to 0 or out of reach, which forces the tensor-core
   or the FFMA body) on ``FOLD_SHAPES``, the shipped ones first and
   last: the card's device
   time a call (``torch.profiler``: below ~0.1 ms a CUDA-event time reads
   the host) and the CUDA-event time;
8. K6 as it is in the tree, at ``K6_LENGTHS`` (la = lb = lc): the
   CUDA-event time, the card's device time and the host's time a call
   (the wrapper and its launches, not waiting for the card).  It uses
   only the wrapper's public signature, so it runs on any tree;
9. the card's f64 ``mma.sync`` ceiling, the twin of probe 4 for K1: 8
   independent accumulators a warp of ``m8n8k4`` (K1's shape) and of
   ``m16n8k8`` (Hopper's larger f64 shape), 1 to 4 blocks of four warps
   an SM, no memory traffic: what K1 could reach at most of the
   data-sheet FP64 tensor rate behind ``bench.F64_MMA_PER_S``;
10. the fragment layout of ``mma.sync.m16n8k8 .f64`` on the card, the one
   K1's dense body assumes (``csrc/conv2d_trunc_f64.cu``): one warp loads
   A (16x8) and B (8x8) at the assumed positions, runs one ``mma`` from
   zero and writes its four D registers raw; every one of the 128 must
   hold the product at its assumed position, for integer-coded A against
   the identity, a stacked identity against integer-coded B, and integer
   matrices (all sums exact).  It fails loudly otherwise;
11. K1's small body against its dense body at (255,268)x(s,s), s = 1 to
   8 (the main path's 2x2 stencils and their neighbours): device time
   (``torch.profiler``) and CUDA-event time of each, and the largest
   s * s up to which the small body is no slower on the card, which sets
   ``ops/conv2d_f64.py::SMALL_MAX_COEFFS``; then the same at the main
   path's thin class (268,274)x(n,1), n = 16 to 64, the small body
   against the dense body transposed;
12. K1's small body over the compiled-serving batch (``SERVING_SHAPES``,
   the scam walk's products (n,n)x(2,2) at n = 8, 16 and its largest,
   (27,27)x(2,2)->(27,28), x ``bench.SERVING_BATCH`` = 4096 entries)
   against the same products as one grouped ``torch.nn.functional
   .conv2d`` (``groups`` = 4096; the library yardstick, used nowhere in
   the port), in turns (K1, library, library, K1, twice): the card's
   device time a call warm (back to back: the ~49 MB of the largest
   product stay in the 50 MB L2) and cold (a 256 MB write between calls
   flushes L2), from ``torch.profiler``, beside the DRAM byte bound;
13. the scan compiler's one-shot run (``scanc.ScanCompiled.run``) eager
   against captured as a CUDA graph (``compile.GraphedEntry`` over the
   same loop), on hmm(30) and two_populations(2000) from
   ``tools/generators.py``: for every order of the doubling chain that
   ``compile_scan_program`` walks from 128, a fresh object's first eager
   run, a fresh object's first graphed call (warm-up walk and capture)
   and its warm replays, and the kernels a replay holds; then the
   mixture's batched loop (``run_batch``, 128 steps, at batch 1 and
   256): its host prep (``batch_xs``), capture and replay apart, and the
   kernels a replay holds.

14. the fragment layouts of ``mma.sync.m16n8k32 .s8`` and ``m16n8k16
   .bf16`` on the card, the ones K5 assumes (``csrc/ozaki_conv2d.cu``):
   one warp loads A and B at the assumed positions (4 int8 or 2 bf16 a
   register, the lowest k in the lowest bits), runs one ``mma`` from zero
   and writes its four D registers raw; every one of the 128 must hold
   the exact integer product at its assumed position, for coded A against
   a selecting B, a selecting A against coded B, and integer matrices in
   [-64, 64].  It fails loudly otherwise.  Then the card's int8 ``mma.sync``
   ceiling (8 independent m16n8k32 accumulators a warp, 1 to 4 blocks of
   four warps an SM): what K5 could reach at most of the data-sheet int8
   rate behind ``bench.INT8_MMA_PER_S``.  Then the int8 ``wgmma``
   K5's dense body runs (its own ``wgmma_s8`` and ``b_desc``, from the
   kernel's source): one warpgroup builds A (64x32 s8) in registers in
   the m16n8k32 A layout of each warp's 16 rows, stages a B window of
   ``WGMMA_XW`` columns as the kernel does (two planes of 16-byte pieces,
   one 16-row half of k each), and runs one m64n64k32 from zero with the
   descriptor's start shifted by x0 window columns, x0 in
   ``WGMMA_SHIFTS``; every one of the 128 x 32 D registers must hold
   (A B[:, x0:x0 + 64])[16 w + 8 h + g][8 j + 2 tq + q] at register 4 j +
   2 h + q (the layout the kernel's flush and write assume), with the
   strides the kernel uses (SBO 128, LBO one plane).  It fails loudly
   where they do not hold.  Last, the ``wgmma`` m64n64k32 s8 ceiling (8 in flight
   between waits, 1 and 2 blocks of one warpgroup an SM);
15. the twin of ``scripts/ozaki_diag.py::main``: K5 against K1 on square
   truncated products at ``OZAKI_ORDERS`` (128 to 1024), K5 at
   ``pair_bits`` 5, 6 and 7 in int8 and at 7 in bf16 (the integer split,
   the only one the card runs):
   CUDA-event times in turns (K1, K5 .., K1), each K5 row's share of its
   int8 / bf16 bound and its max error over the max of K1's result; and,
   for each K5 row, the smallest order from which it is no slower than K1
   (its crossover), or none;
16. the twin of ``scripts/ozaki_diag.py::fullblock_kernel_ab``: K2 (the
   row strip, ``conv2d_trunc_f32``) against K4a (the tile,
   ``conv2d_trunc_f32_tile``) at the full-block shape (order, order) ->
   (2 order - 1, 2 order - 1) that ``ops/blocked_conv.py::conv2d_blocked``
   gives each pair, at ``FULLBLOCK_ORDERS``, on operands from
   ``np.random.RandomState(2)`` as in the script: each result held to the
   plain version of the product in f64 (``conv2d_trunc_f64_reference`` in
   strips of ``FULLBLOCK_ROWS`` output rows, the f32 one needing over
   80 GB at 1024) at ``FULLBLOCK_RTOL`` of each entry plus
   ``FULLBLOCK_ATOL`` of the largest, CUDA-event times in turns (K2, K4a,
   K4a, K2), the f32 plain version's time (``conv2d_trunc_f32_reference``,
   cuBLAS in IEEE f32) where it fits on the card, the library call's (one
   cuDNN f32 ``conv2d`` of ``a`` padded with the flipped ``b``, TF32 off,
   timed once after its first call, with its max rel err) and each
   kernel's share of its bound (K2: the FFMA rate; K4a: three TF32
   passes);
17. K1's output-row window (``conv2d_trunc_f64(..., rows=(r0, r1))``,
   the sharded routes' local body) at the slowest rank's rows, the last
   window of ``parallel.mesh.row_windows`` for tp = 2, 4 and 8, at dense
   orders ``WINDOW_ORDERS``: its time, its plain version's
   (``conv2d_trunc_f64_reference(..., rows=)``) and one cuDNN f64
   ``conv2d`` computing the same rows (the padded ``a``'s rows [r0, r1 +
   b0 - 1) correlated with the flipped ``b``; timed once after its first
   call where a call takes over a second), each held to K1's window at
   1e-12 of its max;
18. ``chip_smoke.py``'s phase 16 alone, its lines condensed to one a
   (shape, tp) of (b): the max abs error against the plain rows and the
   ms per block beside the whole product's; then every rank's window of tp = 2
   and 4 at order 1024 on phase 16's operands, the ms per block (CUDA
   events, ``chip_smoke._time``) in one process: fresh, again, after the
   plain version of every window, again, and after
   ``torch.cuda.empty_cache()``, with the SM clock and power drawn;
19. the twin of ``scripts/ozaki_diag.py::pallas_floor_decomposition``:
   at ``FLOOR_ORDERS`` (256, 512), on ``np.random.RandomState(1)``
   operands, ``FLOOR_ITERS`` = 8 calls of a product to (order, order),
   each output normalized by its max and fed back with the other operand
   as in the script's scan, timed with CUDA events in both modes, in
   turns: the pairs of K4a and K4b (``three_pass_ms``, the split-TF32
   ``mma.sync`` body of ``csrc/conv2d_mma.cuh``; ``one_pass_ms``, the
   ``wgmma`` body of ``csrc/conv2d_wgmma.cuh`` with its rounding launch,
   K4b's in residue-major order), of K2 (``ffma_ms``, and the one-pass
   tile kernel) and of K3 (``FLOOR_BATCH`` entries sharing b; FFMA, and
   the ``wgmma`` body).  The TPU compares six bf16 passes with one on one
   kernel (mxu = (t_H - t_D) x 6/5); here the two modes are different
   kernels with their own staging, so a pair is no decomposition.  Each
   order's one-pass calls are first held to their plain version at rtol
   5e-5 / atol 1e-6; issued over useful multiply-adds of
   ``conv2d_trunc_f32`` in both modes
   (``ops.conv2d.rowstrip_issued_flops``).  ``chip_smoke.py`` phase 17
   drives it as the one-pass mode's main path;
20. the one-pass ``wgmma`` bodies' device time: at ``ONE_PASS_ORDERS``
   (256-768), on ``np.random.default_rng(20)`` operands, the tile
   kernel's and K4b's one pass (each call with its rounding launch and
   slot sum) in turns, tile, K4b, K4b, tile, the least of each, in device
   microseconds a call (``chip_smoke.device_us_queued``: CUDA events
   around calls queued behind a spin) beside the TF32 rate's time for the
   multiply-adds they issue; then the rounding kernel alone on the (n, n)
   pairs beside its bytes bound.  It uses only the public wrappers, so
   ``--tree`` times another tree's kernels.

The probes' sources are built with the port's nvcc flags into
``build/tune/``.  Nothing here imports jax.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

ORDERS = (256, 384, 512, 768)
BATCHES = ((256, 32), (512, 8))


def device_us_by_kernel(call, calls: int) -> dict:
    """``chip_smoke.device_us_by_kernel``, imported when first called:
    chip_smoke imports the package, which ``--tree`` must choose first."""
    from chip_smoke import device_us_by_kernel as by_kernel

    return by_kernel(call, calls)
#: (UNIT_TARGET, MIN_ROWS, TAIL_SHARE, TAIL_DIV) tried in probe 3
PLANS = (
    (1024, 32, 0.0, 1), (1024, 32, 0.2, 3), (512, 32, 0.25, 4),
    (1584, 32, 0.25, 4), (792, 16, 0.25, 4), (792, 64, 0.25, 4),
    (792, 32, 0.5, 4),
)

#: (UNIT_TARGET, MMA_MIN_ROWS, TAIL_SHARE) tried in probe 6
MMA_PLANS = (
    (396, 16, 0.25), (1188, 16, 0.25), (1584, 16, 0.25), (792, 16, 0.5),
    (792, 32, 0.25), (792, 8, 0.25), (792, 16, 0.0),
)

#: constants of ops/conv1d.py tried in probe 7 (each on top of the shipped
#: ones): the plan's, and the bodies' thresholds (0, or out of reach,
#: forces the tensor-core or the FFMA body)
FOLD_PLANS = (
    {"MIN_DIAG": 4}, {"MIN_DIAG": 16}, {"MIN_UNITS": 16}, {"MIN_UNITS": 64},
    {"UNIT_TARGET": 396}, {"UNIT_TARGET": 1584},
    {"MMA_MIN_MACS": 0, "MMA_MIN_LEN": 0},
    {"MMA_MIN_MACS": 1 << 62, "MMA_MIN_LEN": 1 << 30},
)
#: (la, lb, lc) of probe 7: dense products, and thin ones (a short b)
FOLD_SHAPES = (
    *((n, n, n) for n in (512, 1024, 2048, 4096, 8192, 16384, 65536,
                          262144)),
    *((65536, lb, 65536) for lb in (16, 64, 256, 1024)),
)
K6_LENGTHS = (120, 300, 4096, 16384, 65536, 262144)

FMA_PEAK_CU = r"""
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256)
fma_peak_kernel(float* out, int iters, float x, float y) {
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = threadIdx.x * 1e-3f + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = fmaf(acc[i], x, y);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// ``blocks`` blocks of 256 threads, 128 * iters FMAs a thread
extern "C" int fma_peak(float* out, int blocks, int iters, void* stream) {
  fma_peak_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      out, iters, 0.999f, 1e-3f);
  return static_cast<int>(cudaGetLastError());
}
"""

MMA_PEAK_CU = r"""
#include <cuda_runtime.h>
#include <cstdint>
__global__ void __launch_bounds__(128)
mma_peak_kernel(float* out, int iters) {
  float d[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) d[i][j] = 0.f;
  uint32_t a[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = (threadIdx.x + j) << 13;
  const uint32_t b0 = threadIdx.x << 14, b1 = threadIdx.x << 15;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += d[i][0] + d[i][1] + d[i][2] + d[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// ``blocks`` blocks of four warps, 8 * iters mma (1024 multiply-adds) a warp
extern "C" int mma_peak(float* out, int blocks, int iters, void* stream) {
  mma_peak_kernel<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""

F64_MMA_PEAK_CU = r"""
#include <cuda_runtime.h>
// SHAPE 0: m8n8k4 (256 multiply-adds an mma), 1: m16n8k8 (1024)
template <int SHAPE>
__global__ void __launch_bounds__(128)
f64_mma_peak_kernel(double* out, int iters) {
  double d[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) d[i][j] = 0.0;
  double a[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = 1e-3 * (threadIdx.x + j);
  const double b0 = 1e-3 * threadIdx.x, b1 = b0 + 1e-3;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if constexpr (SHAPE == 0)
        asm volatile(
            "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
            "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
            : "+d"(d[i][0]), "+d"(d[i][1])
            : "d"(a[0]), "d"(b0));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+d"(d[i][0]), "+d"(d[i][1]), "+d"(d[i][2]), "+d"(d[i][3])
            : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0),
              "d"(b1));
    }
  }
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += d[i][0] + d[i][1] + d[i][2] + d[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// ``blocks`` blocks of four warps, 8 * iters mma a warp
extern "C" int f64_mma_peak(double* out, int shape, int blocks, int iters,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shape == 0)
    f64_mma_peak_kernel<0><<<blocks, 128, 0, st>>>(out, iters);
  else
    f64_mma_peak_kernel<1><<<blocks, 128, 0, st>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""

F64_MMA_LAYOUT_CU = r"""
#include <cuda_runtime.h>
// One warp: lane 4 g + t loads the fragments of mma.m16n8k8 .f64 from
// row-major A (16x8) and B (8x8, B[k][n]) at the positions K1's dense body
// assumes (a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4], a3 = A[g +
// 8][t + 4]; b0 = B[t][g], b1 = B[t + 4][g]), runs one mma from zero and
// writes its four D registers raw, d[4 lane + i].
__global__ void f64_mma_layout_kernel(const double* A, const double* B,
                                      double* d) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  double c[4] = {0.0, 0.0, 0.0, 0.0};
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(A[g * 8 + t]), "d"(A[(g + 8) * 8 + t]), "d"(A[g * 8 + t + 4]),
        "d"(A[(g + 8) * 8 + t + 4]), "d"(B[t * 8 + g]),
        "d"(B[(t + 4) * 8 + g]));
  for (int i = 0; i < 4; ++i) d[4 * lane + i] = c[i];
}
extern "C" int f64_mma_layout(const double* A, const double* B, double* d,
                              void* stream) {
  f64_mma_layout_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      A, B, d);
  return static_cast<int>(cudaGetLastError());
}
"""

OZAKI_LAYOUT_CU = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
// One warp: lane 4 g + t builds the fragments of mma.m16n8k32 .s8 from
// row-major int8 A (16x32) and B (32x8, B[k][n]) at the positions K5
// assumes (a0 = A[g][4t .. 4t + 3], a1 = A[g + 8][4t ..], a2 = A[g][16 +
// 4t ..], a3 = A[g + 8][16 + 4t ..]; b0 = B[4t .. 4t + 3][g], b1 = B[16 +
// 4t ..][g]; the lowest k in the lowest byte), runs one mma from zero and
// writes its four D registers raw, d[4 lane + i].
__global__ void s8_layout_kernel(const int8_t* A, const int8_t* B, int* d) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  unsigned a[4], b[2];
  const int rows[4] = {g, g + 8, g, g + 8}, cols[4] = {0, 0, 16, 16};
  for (int r = 0; r < 4; ++r) {
    unsigned v = 0;
    for (int j = 0; j < 4; ++j)
      v |= (static_cast<unsigned>(static_cast<uint8_t>(
               A[rows[r] * 32 + cols[r] + 4 * t + j]))) << (8 * j);
    a[r] = v;
  }
  for (int r = 0; r < 2; ++r) {
    unsigned v = 0;
    for (int j = 0; j < 4; ++j)
      v |= (static_cast<unsigned>(static_cast<uint8_t>(
               B[(16 * r + 4 * t + j) * 8 + g]))) << (8 * j);
    b[r] = v;
  }
  int c[4] = {0, 0, 0, 0};
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  for (int i = 0; i < 4; ++i) d[4 * lane + i] = c[i];
}
// The same for mma.m16n8k16 .bf16 (A 16x16, B 16x8): a0 = A[g][2t, 2t +
// 1], a1 = A[g + 8][2t ..], a2 = A[g][8 + 2t ..], a3 = A[g + 8][8 + 2t ..];
// b0 = B[2t, 2t + 1][g], b1 = B[8 + 2t ..][g]; f32 sums.
__global__ void bf16_layout_kernel(const __nv_bfloat16* A,
                                   const __nv_bfloat16* B, float* d) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  unsigned a[4], b[2];
  const int rows[4] = {g, g + 8, g, g + 8}, cols[4] = {0, 0, 8, 8};
  for (int r = 0; r < 4; ++r) {
    unsigned v = 0;
    for (int j = 0; j < 2; ++j)
      v |= static_cast<unsigned>(__bfloat16_as_ushort(
               A[rows[r] * 16 + cols[r] + 2 * t + j])) << (16 * j);
    a[r] = v;
  }
  for (int r = 0; r < 2; ++r) {
    unsigned v = 0;
    for (int j = 0; j < 2; ++j)
      v |= static_cast<unsigned>(__bfloat16_as_ushort(
               B[(8 * r + 2 * t + j) * 8 + g])) << (16 * j);
    b[r] = v;
  }
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  for (int i = 0; i < 4; ++i) d[4 * lane + i] = c[i];
}
// 8 independent m16n8k32 s8 accumulators a warp, no memory traffic
__global__ void __launch_bounds__(128) s8_peak_kernel(int* out, int iters) {
  int d[8][4];
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 4; ++j) d[i][j] = 0;
  unsigned a[4];
  for (int j = 0; j < 4; ++j) a[j] = 0x01010101u * ((threadIdx.x + j) & 3);
  const unsigned b0 = 0x01010101u * (threadIdx.x & 1), b1 = b0 ^ 0x01000100u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+r"(d[i][0]), "+r"(d[i][1]), "+r"(d[i][2]), "+r"(d[i][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  int s = 0;
  for (int i = 0; i < 8; ++i) s += d[i][0] + d[i][1] + d[i][2] + d[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int s8_layout(const void* A, const void* B, void* d, int bf16,
                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    bf16_layout_kernel<<<1, 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(A),
        static_cast<const __nv_bfloat16*>(B), static_cast<float*>(d));
  else
    s8_layout_kernel<<<1, 32, 0, st>>>(static_cast<const int8_t*>(A),
                                       static_cast<const int8_t*>(B),
                                       static_cast<int*>(d));
  return static_cast<int>(cudaGetLastError());
}
// ``blocks`` blocks of four warps, 8 * iters mma (4096 multiply-adds) a warp
extern "C" int s8_peak(int* out, int blocks, int iters, void* stream) {
  s8_peak_kernel<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""

#: the wgmma probe's window columns and descriptor shifts (probe 14)
WGMMA_XW = 80
WGMMA_SHIFTS = (0, 1, 7, 15)

WGMMA_CU = r"""
#include "ozaki_conv2d.cu"
namespace {
// one m64n64k32 s8 wgmma from zero: A (64 x 32, row-major) from
// registers, B's window (32 x xw, row-major) staged as two planes of xw
// 16-byte pieces, the kernel's descriptor (b_desc: LBO one plane) at
// window column x0; every D register raw to d[thread][32]
__global__ void __launch_bounds__(128) wgmma_layout_kernel(
    const int8_t* A, const int8_t* Bw, int xw, int x0, int* d) {
  __shared__ __align__(128) unsigned char sB[2 * 128 * 16];
  for (int e = threadIdx.x; e < 2 * xw * 16; e += 128) {
    const int kc = e / (xw * 16), x = e / 16 % xw, b = e % 16;
    sB[kc * xw * 16 + 16 * x + b] =
        static_cast<unsigned char>(Bw[(16 * kc + b) * xw + x]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  unsigned a[4];
  for (int r = 0; r < 4; ++r) {
    const int row = 16 * w + g + 8 * (r % 2), k = 4 * t + 16 * (r / 2);
    unsigned v = 0;
    for (int j = 0; j < 4; ++j)
      v |= static_cast<unsigned>(static_cast<unsigned char>(
               A[row * 32 + k + j])) << (8 * j);
    a[r] = v;
  }
  const uint64_t desc = b_desc(sB + 16 * x0, 16 * xw);
  int acc[32];
  for (int k = 0; k < 32; ++k) acc[k] = 0;
  wgmma_fence();
  wgmma_s8(acc, a, desc, 0);
  wgmma_commit();
  wgmma_wait_all();
  pin(acc);
  for (int k = 0; k < 32; ++k) d[threadIdx.x * 32 + k] = acc[k];
}
// iters x 8 wgmma m64n64k32 a warpgroup, a wait every 8
__global__ void __launch_bounds__(128) wgmma_peak_kernel(int* out,
                                                         int iters) {
  __shared__ __align__(128) unsigned char sB[2 * 64 * 16];
  for (int e = threadIdx.x; e < 2 * 64 * 16; e += 128) sB[e] = e & 3;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  unsigned a[4];
  for (int j = 0; j < 4; ++j) a[j] = 0x01010101u * ((threadIdx.x + j) & 3);
  const uint64_t desc = b_desc(sB, 64 * 16);
  int acc[32];
  for (int k = 0; k < 32; ++k) acc[k] = 0;
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < 8; ++i) wgmma_s8(acc, a, desc, 1);
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
  }
  int s = 0;
  for (int k = 0; k < 32; ++k) s += acc[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
}  // namespace
extern "C" int wgmma_layout(const void* A, const void* Bw, int xw, int x0,
                            void* d, void* stream) {
  wgmma_layout_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(A), static_cast<const int8_t*>(Bw), xw, x0,
      static_cast<int*>(d));
  return static_cast<int>(cudaGetLastError());
}
extern "C" int wgmma_peak(int* out, int blocks, int iters, void* stream) {
  wgmma_peak_kernel<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""

PERSISTENT_CU = r"""
#include "conv2d_unit.cuh"
namespace {
__global__ void __launch_bounds__(NT, 3)
persistent_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, float* __restrict__ work,
                  const int4* __restrict__ units, int n_units, int* counter,
                  int a0, int a1, int b1, int c0, int c1) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int next;
  for (;;) {
    if (threadIdx.x == 0) next = atomicAdd(counter, 1);
    __syncthreads();
    const int u = next;
    __syncthreads();
    if (u >= n_units) break;
    run_unit<32, true>(a, b, c, work, units, u, a0, a1, b1, c0, c1, smem);
  }
}
}  // namespace
// K2's two passes with ``blocks`` persistent blocks; b1 > 1 and a 16-byte
// aligned with a1 % 4 == 0 (the dense shapes of the probe)
extern "C" int persistent(const float* a, const float* b, float* c,
                          float* work, const void* units, int n_units,
                          const void* sums, int n_sums, int* counter,
                          int blocks, int a0, int a1, int b1, int c0, int c1,
                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  static bool allowed[64] = {};
  cudaError_t err = allow_smem(persistent_kernel, Geo<32>::SMEM, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(counter, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  persistent_kernel<<<blocks, NT, Geo<32>::SMEM, st>>>(
      a, b, c, work, static_cast<const int4*>(units), n_units, counter, a0,
      a1, b1, c0, c1);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_sums == 0) return static_cast<int>(err);
  return static_cast<int>(sum_units(work, c, static_cast<const int4*>(sums),
                                    n_sums, 0, 1, c0, c1, st));
}
"""


def _compile(name: str, source: str) -> ctypes.CDLL:
    from genfer_tpu_torch import _build

    out = _build.BUILD_DIR.parent / "tune"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"{name}.cu"
    src.write_text(source)
    lib = out / f"lib{name}.so"
    subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-shared", "-o", str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


def fma_ceiling() -> None:
    import torch

    from genfer_tpu_torch.bench import F32_FMA_PER_S, time_ms

    lib = _compile("fma_peak", FMA_PEAK_CU)
    lib.fma_peak.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 8 * sms, 200000
    out = torch.empty(blocks * 256, device="cuda")

    def run():
        err = lib.fma_peak(out.data_ptr(), blocks, iters,
                           torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"fma_peak launch failed ({err})")

    ms = time_ms(run, 3, warmup=1)
    rate = blocks * 256 * iters * 128.0 / ms * 1e3
    print(f"probe 1 f32 FMA ceiling: {rate / 1e12:.3f}e12 FMA/s = "
          f"{2 * rate / 1e12:.2f} TFLOP/s on {sms} SMs "
          f"({100 * rate / F32_FMA_PER_S:.1f}% of the data-sheet rate the "
          "bounds use)")


def persistent_against_grid() -> None:
    import torch

    from genfer_tpu_torch import ops
    from genfer_tpu_torch.bench import time_ms
    from genfer_tpu_torch.ops import conv2d as C

    lib = _compile("persistent", PERSISTENT_CU)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.persistent.argtypes = ([ptr] * 5 + [i32, ptr, i32, ptr] + [i32] * 6
                               + [ptr])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    counter = torch.zeros(1, dtype=torch.int32, device="cuda")

    def persistent(a, b, out, blocks):
        plan, units, sums = C._plan_on_card(tuple(a.shape), tuple(b.shape),
                                            out, a.device)
        c = torch.empty(out, device="cuda")
        work = torch.empty((max(plan.slots, 1), C.TILE, C.TILE),
                           device="cuda")
        err = lib.persistent(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), work.data_ptr(),
            units.data_ptr(), len(plan.units), sums.data_ptr(),
            len(plan.sums), counter.data_ptr(), blocks, a.shape[0],
            a.shape[1], b.shape[1], out[0], out[1],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"persistent launch failed ({err})")
        return c

    for order in ORDERS:
        shape = (order, order)
        a = torch.rand(shape, device="cuda")
        b = torch.rand(shape, device="cuda")
        want = ops.conv2d_trunc_f32(a, b, shape)
        parts = []
        for per_sm in (2, 3, 4):
            got = persistent(a, b, shape, per_sm * sms)
            if not torch.equal(got, want):
                raise RuntimeError(f"order {order}: persistent blocks and "
                                   "the plain grid differ")
            ms = time_ms(lambda: persistent(a, b, shape, per_sm * sms), 20)
            parts.append(f"persistent x{per_sm} {ms:.4f}")
        grid = time_ms(lambda: ops.conv2d_trunc_f32(a, b, shape), 20)
        print(f"probe 2 order {order}: plain grid {grid:.4f} ms, "
              + ", ".join(parts) + " ms; same bits")


def plan_sweep() -> None:
    import torch

    from genfer_tpu_torch import ops
    from genfer_tpu_torch.bench import product_bound, time_ms
    from genfer_tpu_torch.ops import conv2d as C

    shipped = (C.UNIT_TARGET, C.MIN_ROWS, C.TAIL_SHARE, C.TAIL_DIV)
    try:
        for plan in (shipped, *PLANS, shipped):
            C.UNIT_TARGET, C.MIN_ROWS, C.TAIL_SHARE, C.TAIL_DIV = plan
            C.unit_plan.cache_clear()
            C._plan_on_card.cache_clear()
            parts = []
            for order in ORDERS:
                shape = (order, order)
                a = torch.rand(shape, device="cuda")
                b = torch.rand(shape, device="cuda")
                ms = time_ms(lambda: ops.conv2d_trunc_f32(a, b, shape), 10)
                share = product_bound(shape, shape, shape)[0] / ms
                units = len(C.unit_plan(shape, shape, shape).units)
                parts.append(f"{order}: {ms:.4f} ms {100 * share:.1f}% "
                             f"({units} units)")
            for order, batch in BATCHES:
                shape = (order, order)
                a = torch.rand((batch, *shape), device="cuda")
                b = torch.rand(shape, device="cuda")
                ms = time_ms(
                    lambda: ops.conv2d_trunc_f32_batched(a, b, shape), 3)
                share = product_bound(shape, shape, shape, batch)[0] / ms
                parts.append(f"{order}xB{batch}: {ms:.4f} ms "
                             f"{100 * share:.1f}%")
            print("probe 3 target {}, min rows {}, tail {} / {}: ".format(
                *plan) + ", ".join(parts))
    finally:
        C.UNIT_TARGET, C.MIN_ROWS, C.TAIL_SHARE, C.TAIL_DIV = shipped
        C.unit_plan.cache_clear()
        C._plan_on_card.cache_clear()


def mma_ceiling() -> float:
    """Probe 4; returns the best rate, in mma multiply-adds a second."""
    import torch

    from genfer_tpu_torch.bench import TF32_MMA_PER_S, time_ms

    lib = _compile("mma_peak", MMA_PEAK_CU)
    lib.mma_peak.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    best, iters = 0.0, 20000
    for per_sm in (1, 2, 3, 4):
        blocks = per_sm * sms
        out = torch.empty(blocks * 128, device="cuda")

        def run():
            err = lib.mma_peak(out.data_ptr(), blocks, iters,
                               torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"mma_peak launch failed ({err})")

        ms = time_ms(run, 3, warmup=1)
        rate = blocks * 4 * iters * 8 * 1024.0 / ms * 1e3
        best = max(best, rate)
        print(f"probe 4 mma.sync m16n8k8 TF32 ceiling, {per_sm} blocks of "
              f"four warps an SM: {rate / 1e12:.1f}e12 multiply-adds/s = "
              f"{2 * rate / 1e12:.0f} TFLOP/s "
              f"({100 * rate / TF32_MMA_PER_S:.1f}% of the data-sheet TF32 "
              "rate the bounds use)")
    return best


def f64_mma_ceiling() -> float:
    """Probe 9; returns the best rate of K1's shape (m8n8k4), in mma
    multiply-adds a second."""
    import torch

    from genfer_tpu_torch.bench import F64_MMA_PER_S, time_ms

    lib = _compile("f64_mma_peak", F64_MMA_PEAK_CU)
    lib.f64_mma_peak.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    best, iters = 0.0, 20000
    for shape, name, macs in ((0, "m8n8k4", 256), (1, "m16n8k8", 1024)):
        for per_sm in (1, 2, 3, 4):
            blocks = per_sm * sms
            out = torch.empty(blocks * 128, dtype=torch.float64,
                              device="cuda")

            def run():
                err = lib.f64_mma_peak(
                    out.data_ptr(), shape, blocks, iters,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"f64_mma_peak launch failed ({err})")

            ms = time_ms(run, 3, warmup=1)
            rate = blocks * 4 * iters * 8 * macs / ms * 1e3
            if shape == 0:
                best = max(best, rate)
            print(f"probe 9 mma.sync {name} f64 ceiling, {per_sm} blocks of "
                  f"four warps an SM: {rate / 1e12:.2f}e12 multiply-adds/s = "
                  f"{2 * rate / 1e12:.1f} TFLOP/s "
                  f"({100 * rate / F64_MMA_PER_S:.1f}% of the data-sheet "
                  "FP64 tensor rate the bound uses)")
    return best


def f64_mma_layout() -> None:
    """Probe 10."""
    import numpy as np
    import torch

    lib = _compile("f64_mma_layout", F64_MMA_LAYOUT_CU)
    lib.f64_mma_layout.argtypes = [ctypes.c_void_p] * 4
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    rng = np.random.default_rng(10)
    codings = {
        "A coded (8 r + c + 1), B the identity": (
            np.arange(1.0, 129.0).reshape(16, 8), np.eye(8)),
        "A two stacked identities, B coded (8 k + n + 1)": (
            np.vstack([np.eye(8)] * 2), np.arange(1.0, 65.0).reshape(8, 8)),
        "A and B integers in [-64, 64]": (
            rng.integers(-64, 65, (16, 8)).astype(np.float64),
            rng.integers(-64, 65, (8, 8)).astype(np.float64)),
    }
    for what, (A, B) in codings.items():
        a = torch.from_numpy(A).cuda()
        b = torch.from_numpy(B).cuda()
        d = torch.full((32, 4), float("nan"), dtype=torch.float64,
                       device="cuda")
        err = lib.f64_mma_layout(a.data_ptr(), b.data_ptr(), d.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"f64_mma_layout launch failed ({err})")
        got = d.cpu().numpy()
        D = A @ B  # exact: integers far below 2^53
        # register 2 h + i of lane 4 g + t: D[8 h + g][2 t + i]
        want = np.stack([D[8 * h + g, 2 * t + i] for h in (0, 1)
                         for i in (0, 1)], axis=1)
        wrong = np.argwhere(got != want)
        if len(wrong):
            raise RuntimeError(
                f"probe 10 {what}: {len(wrong)} of 128 D registers off the "
                "assumed layout, first (lane, register, got, want): "
                + ", ".join(f"({ln}, {r}, {got[ln, r]:g}, {want[ln, r]:g})"
                            for ln, r in wrong[:4]))
        print(f"probe 10 mma.sync m16n8k8 f64 layout, {what}: 128 of 128 "
              "D registers at the assumed positions")


def ozaki_layout() -> None:
    """Probe 14."""
    import numpy as np
    import torch

    from genfer_tpu_torch.bench import INT8_MMA_PER_S, time_ms

    lib = _compile("ozaki_layout", OZAKI_LAYOUT_CU)
    lib.s8_layout.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                                      ctypes.c_void_p]
    lib.s8_peak.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                            ctypes.c_void_p]
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    rng = np.random.default_rng(14)
    for name, k, dtype in (("m16n8k32 s8", 32, torch.int8),
                           ("m16n8k16 bf16", 16, torch.bfloat16)):
        codings = {
            "A coded ((k r + c) mod 127 - 63), B adding rows n + 8 j": (
                (np.arange(16 * k).reshape(16, k) % 127 - 63),
                sum(np.eye(k)[:, 8 * j:8 * j + 8] for j in range(k // 8))),
            "A selecting, B coded ((8 k + n) mod 127 - 63)": (
                np.hstack([np.eye(16)] * (k // 16)),
                np.arange(k * 8).reshape(k, 8) % 127 - 63),
            "A and B integers in [-64, 64]": (
                rng.integers(-64, 65, (16, k)), rng.integers(-64, 65, (k, 8))),
        }
        for what, (A, B) in codings.items():
            A, B = np.asarray(A, np.int64), np.asarray(B, np.int64)
            a = torch.from_numpy(A).to(dtype).cuda()
            b = torch.from_numpy(B).to(dtype).cuda()
            out_dtype = torch.int32 if dtype == torch.int8 else torch.float32
            d = torch.full((32, 4), -12345, dtype=out_dtype, device="cuda")
            err = lib.s8_layout(a.data_ptr(), b.data_ptr(), d.data_ptr(),
                                int(dtype == torch.bfloat16),
                                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"s8_layout launch failed ({err})")
            got = d.cpu().numpy().astype(np.int64)
            D = A @ B  # exact: |D| <= 32 * 64 * 64
            # register 2 h + i of lane 4 g + t: D[8 h + g][2 t + i]
            want = np.stack([D[8 * h + g, 2 * t + i] for h in (0, 1)
                             for i in (0, 1)], axis=1)
            wrong = np.argwhere(got != want)
            if len(wrong):
                raise RuntimeError(
                    f"probe 14 {name} {what}: {len(wrong)} of 128 D "
                    "registers off the assumed layout, first (lane, "
                    "register, got, want): " + ", ".join(
                        f"({ln}, {r}, {got[ln, r]}, {want[ln, r]})"
                        for ln, r in wrong[:4]))
            print(f"probe 14 mma.sync {name} layout, {what}: 128 of 128 D "
                  "registers at the assumed positions")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 20000
    for per_sm in (1, 2, 3, 4):
        blocks = per_sm * sms
        out = torch.empty(blocks * 128, dtype=torch.int32, device="cuda")

        def run():
            err = lib.s8_peak(out.data_ptr(), blocks, iters,
                              torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"s8_peak launch failed ({err})")

        ms = time_ms(run, 3, warmup=1)
        rate = blocks * 4 * iters * 8 * 4096.0 / ms * 1e3
        print(f"probe 14 mma.sync m16n8k32 s8 ceiling, {per_sm} blocks of "
              f"four warps an SM: {rate / 1e12:.1f}e12 multiply-adds/s = "
              f"{2 * rate / 1e12:.0f} TOPS "
              f"({100 * rate / INT8_MMA_PER_S:.1f}% of the data-sheet int8 "
              "rate the bounds use)")
    wgmma_layout(rng)


def wgmma_layout(rng) -> None:
    """Probe 14's wgmma part (module docstring)."""
    import numpy as np
    import torch

    from genfer_tpu_torch.bench import INT8_MMA_PER_S, time_ms

    lib = _compile("wgmma_layout", WGMMA_CU)
    lib.wgmma_layout.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p] * 2
    lib.wgmma_peak.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p]
    thread = np.arange(128)
    w, g, t = thread // 32, thread % 32 // 4, thread % 4
    A = rng.integers(-64, 65, (64, 32))
    Bw = rng.integers(-64, 65, (32, WGMMA_XW))
    a = torch.from_numpy(A.astype(np.int8)).cuda()
    bw = torch.from_numpy(Bw.astype(np.int8)).cuda()
    ok = []
    for x0 in WGMMA_SHIFTS:
        d = torch.full((128, 32), -12345, dtype=torch.int32, device="cuda")
        err = lib.wgmma_layout(a.data_ptr(), bw.data_ptr(), WGMMA_XW, x0,
                               d.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"wgmma_layout launch failed ({err})")
        got = d.cpu().numpy().astype(np.int64)
        D = A @ Bw[:, x0:x0 + 64]
        want = np.stack([D[16 * w + 8 * h + g, 8 * j + 2 * t + q]
                         for j in range(8) for h in (0, 1) for q in (0, 1)],
                        axis=1)
        ok.append(int((got == want).sum()))
    print(f"probe 14 wgmma m64n64k32 s8, B through the kernel's descriptor "
          f"(SBO 128, LBO a plane), start shifted by {WGMMA_SHIFTS} window "
          "columns: " + ", ".join(f"{n} of 4096" for n in ok)
          + " D registers at the kernel's positions")
    if ok != [4096] * len(WGMMA_SHIFTS):
        raise RuntimeError("probe 14: the wgmma layout or descriptor K5 "
                           "assumes does not hold on this card")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 20000
    for per_sm in (1, 2):
        blocks = per_sm * sms
        out = torch.empty(blocks * 128, dtype=torch.int32, device="cuda")

        def run():
            err = lib.wgmma_peak(out.data_ptr(), blocks, iters,
                                 torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"wgmma_peak launch failed ({err})")

        ms = time_ms(run, 3, warmup=1)
        rate = blocks * iters * 8 * 64 * 64 * 32.0 / ms * 1e3
        print(f"probe 14 wgmma m64n64k32 s8 ceiling (8 between waits), "
              f"{per_sm} blocks of one warpgroup an SM: {rate / 1e12:.1f}e12 "
              f"multiply-adds/s = {2 * rate / 1e12:.0f} TOPS "
              f"({100 * rate / INT8_MMA_PER_S:.1f}% of the data-sheet int8 "
              "rate the bounds use)")


#: orders of probe 15 (square truncated products, scripts/ozaki_diag.py's
#: crossover sweep up to the largest order K1's table holds)
OZAKI_ORDERS = (128, 192, 256, 384, 512, 768, 1024)
#: K5 variants of probe 15: (label, pair_bits, impl)
OZAKI_VARIANTS = (
    ("int8_pb5", 5, "int8"), ("int8_pb6", 6, "int8"),
    ("int8_pb7", 7, "int8"), ("bf16_pb7", 7, "bf16"),
)


def ozaki_against_k1() -> None:
    """Probe 15."""
    import numpy as np
    import torch

    from genfer_tpu_torch.bench import (
        BF16_MMA,
        INT8_MMA,
        product_bound,
        time_ms,
    )
    from genfer_tpu_torch.ops import ozaki_conv as Z
    from genfer_tpu_torch.ops.conv2d_f64 import conv2d_trunc_f64

    rng = np.random.default_rng(15)
    times: dict = {}
    for order in OZAKI_ORDERS:
        shape = (order, order)
        a = torch.from_numpy(rng.random(shape)).cuda()
        b = torch.from_numpy(rng.random(shape)).cuda()
        want = conv2d_trunc_f64(a, b, shape)
        top = float(want.abs().max())
        reps = max(2, min(50, int(2e5 / order ** 2 * 64)))
        k1 = [time_ms(lambda: conv2d_trunc_f64(a, b, shape), reps)]
        parts = []
        for label, pb, impl in OZAKI_VARIANTS:
            if order > Z._max_k(impl):
                parts.append(f"{label} above its contraction cap")
                continue
            got = Z.ozaki_conv2d(a, b, shape, pb, impl)
            err = float((got - want).abs().max()) / top
            ms = time_ms(lambda: Z.ozaki_conv2d(a, b, shape, pb, impl), reps)
            bound, by = product_bound(
                shape, shape, shape, passes=Z.pair_passes(pb),
                rate=INT8_MMA if impl == "int8" else BF16_MMA)
            times.setdefault(label, {})[order] = ms
            parts.append(f"{label} {ms:.4f} ms ({100 * bound / ms:.1f}% of "
                         f"{bound:.4f} ms, {by}; err {err:.2e} of the max)")
        k1.append(time_ms(lambda: conv2d_trunc_f64(a, b, shape), reps))
        times.setdefault("k1", {})[order] = min(k1)
        print(f"probe 15 order {order}: K1 {k1[0]:.4f} / {k1[1]:.4f} ms; "
              + "; ".join(parts))
    for label, *_ in OZAKI_VARIANTS:
        ran = [n for n in OZAKI_ORDERS if n in times[label]]
        wins = [n for n in ran if times[label][n] <= times["k1"][n]]
        first = next((n for n in ran
                      if all(m in wins for m in ran if m >= n)), None)
        ratio = ", ".join(f"{n}: {times[label][n] / times['k1'][n]:.2f}"
                          for n in ran)
        print(f"probe 15 {label} over K1 (time ratio) {ratio}; crossover: "
              + (f"from order {first}" if first else "none up to "
                 f"{ran[-1]}"))


def _small_or_dense(sa, sb, bodies) -> dict:
    """Device time (us) of each body of K1 at one pair's shapes; prints
    them with their CUDA-event times."""
    import numpy as np
    import torch

    from genfer_tpu_torch.bench import time_ms
    from genfer_tpu_torch.ops import conv2d_f64 as K

    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.random((1, *sa))).cuda()
    b = torch.from_numpy(rng.random((1, *sb))).cuda()
    parts, device = [], {}
    for body in bodies:
        def call(body=body):
            return K._launch(body, a, b, *sa)

        first = call()
        if not torch.equal(call(), first):
            raise RuntimeError(f"probe 11 {body} {sb}: two calls differ")
        kernels = device_us_by_kernel(call, 50)
        device[body] = sum(kernels.values())
        parts.append(f"{body} device {device[body]:.2f} us ("
                     + ", ".join(f"{k} {v:.2f}" for k, v in kernels.items())
                     + f"), events {1e3 * time_ms(call, 200):.2f} us")
    print(f"probe 11 {sa}x{sb}: " + "; ".join(parts))
    return device


def small_against_dense() -> None:
    """Probe 11; also the main path's (n, 1) class, small against the
    dense body transposed."""
    from genfer_tpu_torch.ops import conv2d_f64 as K

    best = 0
    for s in range(1, 9):
        device = _small_or_dense((255, 268), (s, s), ("small", "dense"))
        if device["small"] <= device["dense"] and best == s - 1:
            best = s
    print(f"probe 11: the small body is no slower on the card from 1x1 up "
          f"to {best}x{best}: SMALL_MAX_COEFFS = {best * best} (shipped "
          f"{K.SMALL_MAX_COEFFS})")
    for n in (16, 24, 32, 41, 48, 64):
        _small_or_dense((268, 274), (n, 1), ("small", "dense_t"))


#: probe 12's products: (a shape, b shape, out shape) of the scam walk
SERVING_SHAPES = (
    ((8, 8), (2, 2), (9, 9)),
    ((16, 16), (2, 2), (17, 17)),
    ((27, 27), (2, 2), (27, 28)),
)
FLUSH_BYTES = 256 << 20  # probe 12's L2 flush: five times the 50 MB L2


def _grouped_conv2d(a, b, out):
    """The truncated products of every pair ``a[z]``, ``b[z]`` as one
    grouped correlation of the padded ``a`` with the flipped ``b``."""
    import torch
    import torch.nn.functional as F

    batch, (b0, b1), (c0, c1) = a.shape[0], b.shape[1:], out
    x = torch.zeros((1, batch, c0 + b0 - 1, c1 + b1 - 1), dtype=a.dtype,
                    device=a.device)
    r0, r1 = min(a.shape[1], c0), min(a.shape[2], c1)
    x[0, :, b0 - 1:b0 - 1 + r0, b1 - 1:b1 - 1 + r1] = a[:, :r0, :r1]
    w = torch.flip(b, dims=(1, 2))[:, None].contiguous()
    return lambda: F.conv2d(x, w, groups=batch)[0]


def serving_batch() -> None:
    """Probe 12: K1's small body against the grouped conv2d over the
    serving batch, warm and cold, in turns."""
    import numpy as np
    import torch

    from genfer_tpu_torch.bench import (
        F64_MMA,
        SERVING_BATCH,
        bound_ms,
    )
    from genfer_tpu_torch.ops import conv2d_f64 as K
    from genfer_tpu_torch.taylor.host import _conv_pair_flops

    rng = np.random.default_rng(12)
    flush = torch.empty(FLUSH_BYTES // 8, dtype=torch.float64, device="cuda")
    fill = set(device_us_by_kernel(flush.zero_, 5))
    batch = SERVING_BATCH
    for sa, sb, out in SERVING_SHAPES:
        a = torch.from_numpy(rng.random((batch, *sa))).cuda()
        b = torch.from_numpy(rng.random((batch, *sb))).cuda()
        calls = {"K1": lambda: K.conv2d_trunc_f64_batched(a, b, out),
                 "library": _grouped_conv2d(a, b, out)}
        want = K.conv2d_trunc_f64_batched_reference(a, b, out)
        for name, call in calls.items():
            err = float(((call() - want).abs() / want.abs()).max())
            if not err <= 1e-12:
                raise RuntimeError(f"probe 12 {name} {sa}: max rel err "
                                   f"{err:.3e}")
        times: dict = {(n, w): [] for n in calls for w in ("warm", "cold")}
        for name in ("K1", "library", "library", "K1") * 2:
            call = calls[name]
            times[(name, "warm")].append(
                sum(device_us_by_kernel(call, 50).values()))
            cold = device_us_by_kernel(lambda: (flush.zero_(), call()), 20)
            times[(name, "cold")].append(
                sum(v for k, v in cold.items() if k not in fill))
        nbytes = 8.0 * batch * (np.prod(sa) + np.prod(sb) + np.prod(out))
        bound, by = bound_ms(batch * _conv_pair_flops(sa, sb, out), nbytes,
                             rate=F64_MMA)
        print(f"probe 12 {sa}x{sb}->{out} x {batch}: device us a call "
              + "; ".join(f"{n} {w} " + "/".join(f"{t:.2f}" for t in ts)
                          for (n, w), ts in times.items())
              + f"; bound {1e3 * bound:.2f} us ({by}, "
              f"{nbytes / 1e6:.1f} MB)")


def steady_state(ceiling: float) -> None:
    """Probe 5: identical interior units through the shipped kernels."""
    import numpy as np
    import torch

    from genfer_tpu_torch import _build
    from genfer_tpu_torch.bench import time_ms
    from genfer_tpu_torch.ops.conv2d import TILE

    lib = _build.load()
    order, K, rows, cols = 768, 448, 16, 512
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = 12 * sms
    a = torch.rand((order, order), device="cuda")
    b = torch.rand((order, order), device="cuda")
    units = np.zeros((n, 8), dtype=np.int32)
    units[:, :6] = (K, K, 0, rows, 0, cols)
    units[:, 6] = np.arange(n)
    table = torch.from_numpy(units).cuda()
    work = torch.empty((n, TILE, TILE), device="cuda")
    c = torch.empty((order, order), device="cuda")
    # a unit's three passes: every j0, every column of a under the band, a
    # TILE x TILE tile (the half of the warps whose columns miss the band's
    # last 32 columns skip them)
    macs = 3.0 * n * rows * (cols - 16) * TILE * TILE
    for name in ("conv2d_trunc_f32_tile", "conv2d_trunc_f32_grouped"):
        def run():
            err = getattr(lib, name)(
                a.data_ptr(), b.data_ptr(), c.data_ptr(), work.data_ptr(),
                table.data_ptr(), n, 0, 0, order, order, order, order,
                order, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name} launch failed ({err})")

        ms = time_ms(run, 5)
        rate = macs / ms * 1e3
        print(f"probe 5 {name}: {n} units of {rows} j0 x {cols} columns: "
              f"{ms:.4f} ms, {rate / 1e12:.1f}e12 mma multiply-adds/s = "
              f"{100 * rate / ceiling:.1f}% of probe 4's ceiling")


def mma_plan_sweep() -> None:
    """Probe 6."""
    import torch

    from genfer_tpu_torch import ops
    from genfer_tpu_torch.bench import SPLIT_PASSES, product_bound, time_ms
    from genfer_tpu_torch.ops import conv2d as C

    shipped = (C.UNIT_TARGET, C.MMA_MIN_ROWS, C.TAIL_SHARE)
    try:
        for plan in (shipped, *MMA_PLANS, shipped):
            C.UNIT_TARGET, C.MMA_MIN_ROWS, C.TAIL_SHARE = plan
            C.unit_plan.cache_clear()
            C._plan_on_card.cache_clear()
            parts = []
            for order in ORDERS:
                shape = (order, order)
                a = torch.rand(shape, device="cuda")
                b = torch.rand(shape, device="cuda")
                bound = product_bound(shape, shape, shape,
                                      passes=SPLIT_PASSES)[0]
                units = len(C.unit_plan(shape, shape, shape, False).units)
                ms = [time_ms(lambda k=k: k(a, b, shape), 10)
                      for k in (ops.conv2d_trunc_f32_tile,
                                ops.conv2d_trunc_f32_grouped)]
                parts.append(
                    f"{order}: K4a {ms[0]:.4f} ms {100 * bound / ms[0]:.1f}%"
                    f", K4b {ms[1]:.4f} ms ({units} units)")
            print("probe 6 target {}, min rows {}, tail {}: ".format(*plan)
                  + ", ".join(parts))
    finally:
        C.UNIT_TARGET, C.MMA_MIN_ROWS, C.TAIL_SHARE = shipped
        C.unit_plan.cache_clear()
        C._plan_on_card.cache_clear()


def fold_plan_sweep() -> None:
    """Probe 7."""
    import torch

    from genfer_tpu_torch import ops
    from genfer_tpu_torch.bench import time_ms
    from genfer_tpu_torch.ops import conv1d as C1

    shipped = {k: getattr(C1, k) for k in
               ("UNIT_TARGET", "MIN_DIAG", "MIN_UNITS", "MMA_MIN_LEN",
                "MMA_MIN_MACS")}
    operands = {s: (torch.rand(s[0], device="cuda"),
                    torch.rand(s[1], device="cuda")) for s in FOLD_SHAPES}
    want = {s: ops.conv1d_trunc_f32(*operands[s], s[2]) for s in FOLD_SHAPES}
    try:
        for plan in ({}, *FOLD_PLANS, {}):
            for k, v in {**shipped, **plan}.items():
                setattr(C1, k, v)
            C1.fold_plan.cache_clear()
            C1._plan_on_card.cache_clear()
            parts = []
            for shape in FOLD_SHAPES:
                (a, b), lc = operands[shape], shape[2]

                def call():
                    return ops.conv1d_trunc_f32(a, b, lc)

                got = call()
                rel = float(((got - want[shape]).abs()
                             / want[shape].abs()).max())
                reps = 20 if lc <= 16384 else 5
                us = sum(device_us_by_kernel(call, reps).values())
                parts.append(
                    f"{shape}: {C1.fold_body(*shape)} "
                    f"{len(C1.fold_plan(*shape).units)} units, device "
                    f"{us:.2f} us, events {time_ms(call, reps):.4f} ms, "
                    f"rel to shipped {rel:.1e}")
            print(f"probe 7 {plan or shipped}: " + ", ".join(parts))
    finally:
        for k, v in shipped.items():
            setattr(C1, k, v)
        C1.fold_plan.cache_clear()
        C1._plan_on_card.cache_clear()


def k6_lengths() -> None:
    """Probe 8."""
    import time

    import numpy as np
    import torch

    import genfer_tpu_torch
    from genfer_tpu_torch import ops
    from genfer_tpu_torch.bench import time_ms

    rng = np.random.default_rng(8)
    for n in K6_LENGTHS:
        a, b = (torch.from_numpy(rng.random(n)).float().cuda()
                for _ in range(2))

        def call():
            return ops.conv1d_trunc_f32(a, b, n)

        first = call()
        if not torch.equal(call(), first):
            raise RuntimeError(f"length {n}: two calls differ")
        # calls that fit in ~0.1 s
        reps = max(3, min(200, int(100 / max(time_ms(call, 1), 1e-3))))
        ms = time_ms(call, reps)
        kernels = device_us_by_kernel(call, 20 if n <= 16384 else 5)
        calls = 200 if n <= 16384 else 10
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        host = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        print(f"probe 8 K6 of {Path(genfer_tpu_torch.__file__).parent} "
              f"length {n}: events {ms:.4f} ms, device "
              f"{sum(kernels.values()):.2f} us ("
              + ", ".join(f"{k} {v:.2f}" for k, v in kernels.items())
              + f"), host {host:.2f} us a call, sum "
              f"{float(first.double().sum()):.9g}")


SCAN_PROBE = (("hmm(30)", "generate_hmm", (30,)),
              ("two_populations(2000)", "generate_two_populations", (2000,)))


def _first_and_best(call, reps: int = 5) -> tuple[float, float]:
    """Seconds of the first ``call()`` and the least of ``reps`` more
    (each ends in a read-back to the host)."""
    import time

    t0 = time.perf_counter()
    call()
    first = time.perf_counter() - t0
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return first, best


def _graph_kernels(entry) -> int:
    """Kernels in the one graph ``entry`` (a ``GraphedEntry``) holds."""
    (static, graph, out), = entry.graphs.values()
    from chip_smoke import _profiled

    _, _, kernels = _profiled(graph.replay)
    return sum(n for n, _ in kernels.values())


def scan_capture_against_eager() -> None:
    import numpy as np
    import torch

    from genfer_tpu_torch.compile import GraphedEntry
    from genfer_tpu_torch.lang.parser import parse_program
    from genfer_tpu_torch.scanc import ScanCompiled, compile_scan_program
    from genfer_tpu_torch.tools import generators

    def graphed(obj):
        n = len(obj._xs)
        entry = GraphedEntry(lambda g0, *a: obj._run(g0, a[:n], a[n:]),
                             obj.device, "scan_run")

        def call():
            marg, logz, _ = entry(obj._g0, *obj._xs, *obj._consts0)
            return marg.cpu().numpy() * 2.0 ** float(logz)
        return entry, call

    for label, gen, args in SCAN_PROBE:
        prog = parse_program(getattr(generators, gen)(None, *args))
        conv, _ = compile_scan_program(prog, order=128)  # warms the card
        order = 128
        while order <= 2 * conv.order:
            eager_first, eager_best = _first_and_best(
                ScanCompiled(conv.program, conv.rep, order).run)
            obj = ScanCompiled(conv.program, conv.rep, order)
            entry, call = graphed(obj)
            cap_first, replay = _first_and_best(call)
            same = np.allclose(call(), obj.run()[0], rtol=1e-12, atol=0)
            print(f"probe 13 {label} order {order}: eager first run "
                  f"{eager_first:.4f} s, warm {eager_best * 1e3:.3f} ms; "
                  f"graphed first call (warm-up walk and capture) "
                  f"{cap_first:.4f} s, replay {replay * 1e3:.3f} ms with "
                  f"read-back, {_graph_kernels(entry)} kernels a replay; "
                  f"replay equals eager at rtol 1e-12: {same}")
            order *= 2
        print(f"probe 13 {label}: converged at order {conv.order}")
    mix, _ = compile_scan_program(parse_program(
        generators.generate_mixture(None)), order=128, max_steps=128)
    rng = np.random.default_rng(0)
    for batch in (1, 256):
        bc = rng.integers(0, 8, size=(batch, 109)).astype(np.float64)
        cols = [bc] * len(mix.rep.data)
        mix._run_batch.graphs.clear()
        mix._run_batch.warmed.clear()

        def prep():
            out = mix.batch_xs(cols)
            torch.cuda.synchronize()
            return out

        _, prep_s = _first_and_best(prep)
        xs = prep()
        first, best = _first_and_best(
            lambda: mix._many(mix._run_batch, xs, mix._consts0))
        _, whole = _first_and_best(lambda: mix.run_batch(cols))
        print(f"probe 13 mixture run_batch B={batch} (128 steps): host prep "
              f"(feed tables, gather, copy to the card) {prep_s * 1e3:.3f} "
              f"ms; first graphed call (warm-up walk and capture) "
              f"{first:.3f} s, replay {best * 1e3:.3f} ms with read-back, "
              f"{_graph_kernels(mix._run_batch)} kernels a replay; "
              f"run_batch {whole * 1e3:.3f} ms; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")


FULLBLOCK_ORDERS = (512, 1024)
#: the bar of the f32 kernels' tests and of ``chip_smoke.py`` phase 3
FULLBLOCK_RTOL = 5e-5
#: an absolute floor for entries near 0, as a share of the largest entry
FULLBLOCK_ATOL = 1e-6
FULLBLOCK_REPS = 10
FULLBLOCK_ROWS = 128  # output rows a strip of the f64 plain version


def fullblock_ab() -> None:
    """Probe 16."""
    import numpy as np
    import torch

    from genfer_tpu_torch.bench import (
        SPLIT_PASSES,
        product_bound,
        time_ms,
    )
    from genfer_tpu_torch.ops import (
        conv2d_trunc_f32,
        conv2d_trunc_f32_reference,
        conv2d_trunc_f32_tile,
        conv2d_trunc_f64_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = (("K2", conv2d_trunc_f32, None),
               ("K4a", conv2d_trunc_f32_tile, SPLIT_PASSES))
    for order in FULLBLOCK_ORDERS:
        rng = np.random.RandomState(2)
        a64 = torch.from_numpy(rng.rand(order, order)).cuda()
        b64 = torch.from_numpy(rng.rand(order, order)).cuda()
        a, b = a64.float(), b64.float()
        full = (2 * order - 1, 2 * order - 1)
        plain = conv2d_trunc_f64_reference(a64, b64, full,
                                           strip=FULLBLOCK_ROWS)
        bar = FULLBLOCK_RTOL * plain.abs() + FULLBLOCK_ATOL * plain.abs().max()
        errs = {}
        for label, kernel, _ in kernels:
            diff = (kernel(a, b, full).double() - plain).abs()
            if not bool((diff <= bar).all()):
                sys.exit(f"probe 16 {label} order {order}: off by "
                         f"{float((diff / bar).max()):.3g} x the bar")
            errs[label] = float((diff / plain.abs().clamp_min(1e-300)).max())
        # the library call: one cuDNN f32 conv2d (TF32 off) of a padded
        # with the flipped b, timed once, cold (seconds at 1024)
        torch.backends.cudnn.allow_tf32 = False
        x = torch.zeros((1, 1, full[0] + order - 1, full[1] + order - 1),
                        dtype=torch.float32, device=a.device)
        x[0, 0, order - 1:2 * order - 1, order - 1:2 * order - 1] = a
        w = torch.flip(b, dims=(0, 1))[None, None].contiguous()
        library = torch.nn.functional.conv2d(x, w)[0, 0]
        errs["cuDNN"] = float(((library.double() - plain).abs()
                               / plain.abs().clamp_min(1e-300)).max())
        library_ms = time_ms(lambda: torch.nn.functional.conv2d(x, w), 1,
                             warmup=0)
        del plain, bar, diff, x, w, library
        torch.cuda.empty_cache()
        try:
            ms = time_ms(lambda: conv2d_trunc_f32_reference(a, b, full), 1,
                         warmup=0)
            plain_ms = f"{ms:.3f} ms"
        except torch.OutOfMemoryError:
            plain_ms = "does not fit on the card"
        torch.cuda.empty_cache()
        times: dict = {label: [] for label, *_ in kernels}
        for label, kernel, _ in (*kernels, *reversed(kernels)):
            times[label].append(time_ms(lambda k=kernel: k(a, b, full),
                                        FULLBLOCK_REPS))
        parts = []
        for label, _, passes in kernels:
            bound, by = product_bound((order, order), (order, order), full,
                                      passes=passes)
            best = min(times[label])
            parts.append(f"{label} " + " / ".join(f"{t:.4f}" for t in
                                                 times[label])
                         + f" ms ({100 * bound / best:.1f}% of {bound:.4f} "
                         f"ms, {by})")
        print(f"probe 16 full block {order} -> {full}: " + "; ".join(parts)
              + f"; f32 plain {plain_ms}; cuDNN f32 conv2d "
              f"{library_ms:.3f} ms (one call, after one); K4a over K2 (time) "
              f"{min(times['K4a']) / min(times['K2']):.3f}; max rel err "
              "against the f64 plain version "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f" (each within rtol {FULLBLOCK_RTOL} + {FULLBLOCK_ATOL} of "
              "the max)")


WINDOW_ORDERS = (512, 1024)


def window_blocks() -> None:
    """Probe 17."""
    import numpy as np
    import torch

    from genfer_tpu_torch.bench import time_ms
    from genfer_tpu_torch.ops.conv2d_f64 import (
        conv2d_trunc_f64,
        conv2d_trunc_f64_reference,
    )
    from genfer_tpu_torch.parallel.mesh import row_windows

    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(17)
    for order in WINDOW_ORDERS:
        a = torch.from_numpy(rng.standard_normal((order, order))).cuda()
        b = torch.from_numpy(rng.standard_normal((order, order))).cuda()
        out = (order, order)
        x = torch.zeros((1, 1, 2 * order - 1, 2 * order - 1),
                        dtype=torch.float64, device=a.device)
        x[0, 0, order - 1:, order - 1:] = a
        w = torch.flip(b, dims=(0, 1))[None, None].contiguous()
        for tp in (2, 4, 8):
            r0, r1 = row_windows(order, tp)[-1]
            calls = {
                "K1": lambda: conv2d_trunc_f64(a, b, out, rows=(r0, r1)),
                "plain": lambda: conv2d_trunc_f64_reference(
                    a, b, out, strip=128, rows=(r0, r1)),
                "cuDNN": lambda: torch.nn.functional.conv2d(
                    x[:, :, r0:r1 + order - 1], w)[0, 0],
            }
            want = calls["K1"]()
            parts = []
            for label, call in calls.items():
                got = call()
                err = float((got - want).abs().max() / want.abs().max())
                if not err <= 1e-12:
                    sys.exit(f"probe 17 {label} order {order} tp {tp}: "
                             f"off by {err:.3g} of the max")
                ms = time_ms(call, 1, warmup=0)
                if ms < 1000.0:
                    ms = time_ms(call, max(1, min(50, int(200 / ms))))
                parts.append(f"{label} {ms:.4f} ms")
            print(f"probe 17 order {order} tp={tp} rows [{r0}, {r1}): "
                  + ", ".join(parts) + " (each within 1e-12 of the max of "
                  "K1's window)")


def window_timing_state() -> None:
    """Probe 18."""
    import contextlib
    import io
    import re

    import numpy as np
    import torch

    import chip_smoke
    from genfer_tpu_torch.ops.conv2d_f64 import conv2d_trunc_f64_reference
    from genfer_tpu_torch.parallel.mesh import conv_2d_block, row_windows

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        chip_smoke.phase16_mesh({})
    for line in buf.getvalue().splitlines():
        m = re.match(r"phase 16 \(b\) \((\d+), \d+\)x\((\d+), (\d+)\) \w+ "
                     r"tp=(\d+):.*max abs err (\S+) .*ms per block (.*?) "
                     r"\(max.*whole (\S+) ms", line)
        if m:
            print(f"probe 18 {m[1]}x{m[3]} tp={m[4]} err {m[5]} whole "
                  f"{m[7]}: " + m[6].replace(" / ", " "))

    def clocks():
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()

    rng = np.random.default_rng(16)  # phase 16's: its 512 pair first
    rng.standard_normal((512, 512)), rng.standard_normal((512, 512))
    a = torch.from_numpy(rng.standard_normal((1024, 1024))).cuda()
    b = torch.from_numpy(rng.standard_normal((1024, 1024))).cuda()
    out = (1024, 1024)

    def blocks(label):
        for tp in (2, 4):
            ms = [chip_smoke._time(lambda r=r: conv_2d_block(a, b, out, tp,
                                                             r))
                  for r in range(tp)]
            print(f"probe 18 1024 {label} tp={tp}: "
                  + " ".join(f"{t:.4f}" for t in ms) + " ms")

    print(f"probe 18 SM clock, power: {clocks()}")
    blocks("fresh")
    blocks("again")
    for tp in (2, 4):
        for rows in row_windows(1024, tp):
            conv2d_trunc_f64_reference(a, b, out, 128, rows=rows)
    print(f"probe 18 SM clock, power after the plain version: {clocks()}")
    blocks("after the plain version")
    blocks("again")
    torch.cuda.empty_cache()
    blocks("after empty_cache")


FLOOR_ORDERS = (256, 512)
FLOOR_ITERS = 8
FLOOR_BATCH = 4  # entries of K3's pair, one b shared
FLOOR_RTOL, FLOOR_ATOL = 5e-5, 1e-6  # one pass against its plain version


def _scan_ms(step, carry, iters: int) -> float:
    """Milliseconds a step of ``iters`` steps ``carry = step(*carry)``
    (CUDA events), after one untimed run of them."""
    import torch

    def run():
        c = carry
        for _ in range(iters):
            c = step(*c)
        return c

    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def floor_decomposition(orders=FLOOR_ORDERS, iters: int = FLOOR_ITERS,
                        label: str = "probe 19") -> dict:
    """Probe 19: per order, the pairs of K4a, K4b, K2 and K3 (the two
    modes' times), printed one line each under ``label``."""
    import numpy as np
    import torch

    from genfer_tpu_torch.bench import _conv_pair_flops
    from genfer_tpu_torch.ops import conv2d as C

    torch.backends.cuda.matmul.allow_tf32 = False
    out: dict = {}
    for order in orders:
        rng = np.random.RandomState(1)
        shape = (order, order)
        a = torch.from_numpy(rng.rand(*shape)).float().cuda()
        b = torch.from_numpy(rng.rand(*shape)).float().cuda()
        ab = torch.from_numpy(rng.rand(FLOOR_BATCH, *shape)).float().cuda()
        plain = C.conv2d_trunc_f32_reference(a, b, shape, highest=False)
        plain_b = C.conv2d_trunc_f32_batched_reference(ab, b, shape,
                                                       highest=False)
        for name, got, want in (
                ("K4a", C.conv2d_trunc_f32_tile(a, b, shape, False), plain),
                ("K4b", C.conv2d_trunc_f32_grouped(a, b, shape, False),
                 plain),
                ("K2", C.conv2d_trunc_f32(a, b, shape, False), plain),
                ("K3", C.conv2d_trunc_f32_batched(ab, b, shape, False),
                 plain_b)):
            bar = FLOOR_ATOL + FLOOR_RTOL * want.abs()
            if not bool(((got - want).abs() <= bar).all()):
                raise RuntimeError(
                    f"{label} {name} order {order}: one pass off its plain "
                    f"version by {float(((got - want).abs() / bar).max()):.3g}"
                    " x the bar")
        del plain, plain_b

        def pair(kernel, highest):
            def step(x, y):
                r = kernel(x, y, shape, highest)
                return r / r.abs().max(), x
            return _scan_ms(step, (a, b), iters)

        def batched(highest):
            def step(x):
                r = C.conv2d_trunc_f32_batched(x, b, shape, highest)
                return (r / r.abs().amax(dim=(1, 2), keepdim=True),)
            return _scan_ms(step, (ab,), iters)

        def in_turns(timed):
            # highest first and last, the one pass twice between; the
            # least of each
            t3 = timed(True)
            t1 = min(timed(False), timed(False))
            return min(t3, timed(True)), t1

        row: dict = {}
        for name, first, timed in (
                ("K4a", "three_pass_ms",
                 lambda h: pair(C.conv2d_trunc_f32_tile, h)),
                ("K4b", "three_pass_ms",
                 lambda h: pair(C.conv2d_trunc_f32_grouped, h)),
                ("K2", "ffma_ms", lambda h: pair(C.conv2d_trunc_f32, h)),
                ("K3", "ffma_ms", batched)):
            t3, t1 = in_turns(timed)
            row[name] = {first: t3, "one_pass_ms": t1}
        useful = 2.0 * _conv_pair_flops(shape, shape, shape)
        row["issued_over_useful"] = {
            mode: C.rowstrip_issued_flops(shape, shape, shape, highest)
            / useful for mode, highest in (("ffma", True), ("one_pass",
                                                            False))}
        for name, what, first in (
                ("K4a", "conv2d_trunc_f32_tile", "three_pass"),
                ("K4b", "conv2d_trunc_f32_grouped", "three_pass"),
                ("K2", "conv2d_trunc_f32", "ffma"),
                ("K3", f"conv2d_trunc_f32_batched B={FLOOR_BATCH}", "ffma")):
            print(f"{label} floor {order} {name} ({what}): "
                  f"{first.replace('_', ' ')} {row[name][first + '_ms']:.4f}"
                  f" ms, one pass {row[name]['one_pass_ms']:.4f} ms (the "
                  "one-pass wgmma body: another kernel, not a "
                  "decomposition)")
        print(f"{label} floor {order} issued / useful multiply-adds of "
              "conv2d_trunc_f32: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in row["issued_over_useful"].items()
              ) + f"; one-pass calls within rtol {FLOOR_RTOL} / atol "
              f"{FLOOR_ATOL} of their plain version")
        out[order] = row
    return out


ONE_PASS_ORDERS = (256, 384, 512, 768)


def one_pass_device_us(orders=ONE_PASS_ORDERS) -> dict:
    """Probe 20: the tile kernel's and K4b's one pass, and the rounding
    kernel, in device microseconds a call at each order."""
    import numpy as np
    import torch

    from chip_smoke import _round_bound_ms, device_us_queued
    from genfer_tpu_torch.bench import TF32_MMA_PER_S
    from genfer_tpu_torch.ops import conv2d as C

    out: dict = {}
    for order in orders:
        rng = np.random.default_rng(20)
        shape = (order, order)
        a = torch.from_numpy(rng.random(shape)).float().cuda()
        b = torch.from_numpy(rng.random(shape)).float().cuda()
        issued_us = (C.rowstrip_issued_flops(shape, shape, shape, False)
                     / 2.0 / TF32_MMA_PER_S * 1e6)
        kernels = {"tile": C.conv2d_trunc_f32_tile,
                   "K4b": C.conv2d_trunc_f32_grouped}
        us: dict = {}
        for name in ("tile", "K4b", "K4b", "tile"):
            us[name] = min(us.get(name, float("inf")), device_us_queued(
                lambda k=kernels[name]: k(a, b, shape, highest=False)))
        rounding = device_us_queued(lambda: C.tf32_round_operands(a, b))
        bound_us = _round_bound_ms(shape, shape) * 1e3
        out[order] = {**us, "rounding": rounding}
        print(f"probe 20 one pass {order}: device us a call, tile "
              f"{us['tile']:.2f} ({issued_us / us['tile']:.1%} of the TF32 "
              f"rate's {issued_us:.2f} for its issued multiply-adds), K4b "
              f"{us['K4b']:.2f} ({issued_us / us['K4b']:.1%}); rounding "
              f"kernel {rounding:.2f} (bytes bound {bound_us:.3f}, "
              f"{bound_us / rounding:.1%})")
    return out


def main(argv) -> None:
    if "--tree" in argv:  # before the first import of the package
        i = argv.index("--tree")
        tree = Path(argv[i + 1]).resolve()
        sys.path.insert(0, str(tree))
        argv = argv[:i] + argv[i + 2:]
        import genfer_tpu_torch

        if not Path(genfer_tpu_torch.__file__).resolve().is_relative_to(tree):
            sys.exit(f"tune_port: --tree {tree}: genfer_tpu_torch was "
                     f"imported from {genfer_tpu_torch.__file__}")
    import torch

    from genfer_tpu_torch import _build
    from genfer_tpu_torch.bench import card

    if not torch.cuda.is_available():
        sys.exit("tune_port: no CUDA card")
    probes = {
        1: fma_ceiling, 2: persistent_against_grid, 3: plan_sweep,
        4: mma_ceiling, 5: lambda: steady_state(mma_ceiling()),
        6: mma_plan_sweep, 7: fold_plan_sweep, 8: k6_lengths,
        9: f64_mma_ceiling, 10: f64_mma_layout, 11: small_against_dense,
        12: serving_batch, 13: scan_capture_against_eager,
        14: ozaki_layout, 15: ozaki_against_k1, 16: fullblock_ab,
        17: window_blocks, 18: window_timing_state,
        19: floor_decomposition, 20: one_pass_device_us,
    }
    print(card())
    _build.load()
    for number in sorted({int(x) for x in argv} or probes):
        probes[number]()


if __name__ == "__main__":
    main(sys.argv[1:])
