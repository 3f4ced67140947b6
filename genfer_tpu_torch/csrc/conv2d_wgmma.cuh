// Device code of the one-pass mode (highest=False) of the tensor-core
// truncated 2-D product on Hopper (sm_90a), as the one-pass tile kernel
// (conv2d_trunc_f32_tile.cu: K4a and K2 at one pass), K4b's one pass
// (conv2d_trunc_f32_grouped.cu) and K3's one pass
// (conv2d_trunc_f32_batched_1pass.cu) run it: one *work unit* of
//
//     c[k0, k1] = sum_{j0, j1} A[k0 - j0, k1 - j1] * B[j0, j1]
//
// on operands A = tf32(a), B = tf32(b) that a kernel of its own rounded
// once a call (tf32_round_operands_kernel, below: the plain version's
// ops/conv2d.py::tf32_round), launched by the kernels' one-pass C entries
// themselves (round_into) into scratch that comes with their workspace,
// each row padded with zeros to a multiple of 4 words (``a_pitch``,
// ``b_pitch``).  A unit
// is a row of ops/conv2d.py::unit_plan(cut_j1=False), the table the
// three-pass kernels run (conv2d_mma.cuh); it replaces, with those files,
// genfer_tpu/ops/pallas_conv2d.py::_build2d, ::_build2d_grouped and
// ::_build2d_batched at highest=False (one DEFAULT-precision matrix-unit
// pass there).
//
// The product, transposed onto wgmma.  For each j0 of the unit and each
// 8-column slice of a's columns from i1,
//
//     C^T[n, m] += T^T[n, k] * W[k, m]
//     T^T[n, k] = B[j0, K1 + n - (i1 + k)]     (zero outside the unit's j1)
//     W[k, m]   = A[K0 + m - j0, i1 + k]
//
// is one wgmma.mma_async m64n64k8 .f32.tf32.tf32 (a k-step), one
// warpgroup (the block's 128 threads) to the 64x64 tile:
//
//   * matrix A of the wgmma (64 x 8) is the Toeplitz tile T^T, from
//     registers: warp w holds rows 16 w .. 16 w + 15 in the m16n8k8 A
//     layout (a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
//     lane 4 g + t), each word read from the staged b row at offset n - k.
//     The k-step after ks reads the same row 8 words lower, so its a1 / a3
//     are this step's a0 / a2: a chain of eight k-steps loads 18 words a
//     thread, not 32 (``stage_chains``).  The lanes of one load touch 11
//     consecutive words: no bank conflict.
//   * matrix B (8 x 64) is the a window, from shared memory through a
//     descriptor: K-major, no swizzle.  The window is staged in 4-column
//     chunks; in a chunk window row r lies at 16 r bytes, so rows r .. r +
//     7 are one 128-byte core matrix for any r (SBO = 128 bytes to the
//     next 8 rows, LBO = the chunk stride to the next 4 columns, as K5's
//     descriptor, tune_port.py probe 14).  Output row m of j0 = g0 + dj
//     reads window row m + G - 1 - dj, so stepping dj moves the
//     descriptor's start by 16 bytes and no window is copied per j0.
//     Chunks lie 81 rows apart (1296 bytes, 16 mod 128): the 16-byte
//     copies of one row's chunks land on 8 distinct bank groups.
//   * accumulator register 4 j + 2 h + e of lane 4 g + t in warp w is
//     C^T[16 w + 8 h + g][8 j + 2 t + e]: tile row 8 j + 2 t + e, column
//     16 w + 8 h + g.
//
// Staging: two stages of (G = 16 rows of j0) x (KB = 64 of a's columns),
// the next one's copies in flight while this one is multiplied: the
// window (79 rows x 16 chunks, each a 16-byte cp.async.cg straight from
// the rounded, padded A into the layout the product reads, zero-filled
// outside A) and the unit's b rows (128 words from a 16-byte aligned
// column: 16-byte copies where a piece lies inside the unit's j1 range,
// zero-filled where it lies outside, the Toeplitz's zeros; word by word
// across an end).  The staged columns start at the first one the band
// meets rounded down to 4; the extra columns meet only those zeros.  One
// barrier a stage, after each thread's copies landed and
// fence.proxy.async made them visible to the tensor cores' reads.  A
// third stage made the kernel slower on the card (PERF.md).
//
// Numerics (those of conv2d_mma.cuh): a j0's k-steps form a chain from
// zero (scale-d 0 on its first step) over the stage's 64 columns, then
// wgmma.wait_group 0 and grp += chain in FADD; acc += grp once a stage; a
// tile's units are added in slot order by sum_units.  The warpgroup waits
// for each chain; the other blocks on the SM (58 KB of shared memory and
// ~145 registers a thread leave room for two or three) keep the tensor
// cores busy meanwhile.  Two chain accumulators taking turns (wait_group
// 1) needed ~180 registers, at which ptxas serialized the wgmma, and were
// slower (PERF.md).  Every product of two TF32 values is exact in f32, so
// the result is the f32 sums of the exact products of the rounded
// operands, as the plain version's.
//
// The j0 order of a stage (ORDER, stage_chains): ASCENDING for the tile
// kernel and K3, a chain per j0 (16 waits a full stage); RESIDUE for K4b,
// the TPU kernel's residue-major order, dj mod 8 outer and dj = r + 8 q
// inner, a chain per class over both its j0 (2 x 8 k-steps, 128 terms in
// the tensor core's accumulator; 8 waits a full stage).  Stepping dj only
// moves the descriptor's start, so the order costs no copy.  The two
// orders sum the same products in other groupings: equal to f32 rounding,
// not bit for bit.
//
// Skipping: a j0 at which all 64 window rows lie outside A, and the
// k-steps of a stage's last column block that lie wholly past A's columns
// (ops/conv2d.py::rowstrip_issued_flops counts what is issued).
//
// What bounds it on the H100: TF32 tensor-core multiply-adds, one per f32
// multiply-add; a k-step also reads 2 KB of window and 2.25 words a
// thread of b rows from shared memory for its 32,768 multiply-adds.

#pragma once

#include <cstdint>

#include "conv2d_unit.cuh"

namespace {

struct WgGeo {
  static constexpr int G = 16;                    // j0 rows a stage
  static constexpr int KB = 64;                   // a columns a stage
  static constexpr int S = KB / 8;                // k-steps: one chain
  static constexpr int STAGES = 2;
  static constexpr int A_ROWS = BM + G - 1;       // window rows
  static constexpr int CHUNKS = KB / 4;           // 4-column chunks
  static constexpr int CHUNK_ROWS = A_ROWS + 2;   // 1296 bytes apart
  static constexpr int CHUNK_BYTES = 16 * CHUNK_ROWS;
  static constexpr int W_BYTES = CHUNKS * CHUNK_BYTES;
  static constexpr int B_PITCH = KB + BN;         // words of a b row
  static constexpr int STAGE_BYTES = W_BYTES + 4 * G * B_PITCH;
  static constexpr size_t SMEM = static_cast<size_t>(STAGES) * STAGE_BYTES;
  static constexpr int U = 2 * S + 2;             // b words a chain
  static_assert(CHUNK_BYTES % 128 == 16, "chunk rows on distinct banks");
  static_assert(STAGE_BYTES % 16 == 0, "stages 16-byte aligned");
};

// cp.async.cg of 16 bytes (past L1: every word is read once a stage);
// zero-fills when !ok
__device__ __forceinline__ void copy_async16(void* dst, const void* src,
                                             bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// x rounded to TF32 as ops/conv2d.py::tf32_round rounds it: cvt.rna (to
// nearest, ties away from zero) with the 13 low bits cleared; infinities
// and NaNs keep their words
__device__ __forceinline__ float tf32_word(float x) {
  const uint32_t w = __float_as_uint(x);
  if ((w & 0x7fffffffu) >= 0x7f800000u) return x;
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

// the rounding kernel's geometry: threads a block, the most blocks (8 such
// blocks fill each of an H100's 132 SMs), and the 16-byte words a thread
// has in flight once the grid is at its most
constexpr int ROUND_NT = 256;
constexpr int ROUND_MAX_BLOCKS = 8 * 132;
constexpr int ROUND_INFLIGHT = 4;

// One 16-byte word (``quad``) of a rounded operand: padded word 4 p .. 4 p
// + 3 of y (rows of ``pitch`` words, a multiple of 4) from x (rows of
// ``cols``), zero past cols; one 16-byte load where ``vec`` (x 16-byte
// aligned, cols % 4 == 0: every row starts aligned and has no pad), else
// four 4-byte ones
__device__ __forceinline__ float4 load_quad(const float* __restrict__ x,
                                            long long p, int cols, int pitch,
                                            bool vec) {
  const int qpr = pitch / 4;
  const long long row = p / qpr;
  const int col = 4 * static_cast<int>(p - row * qpr);
  const float* src = x + row * cols + col;
  if (vec) return __ldg(reinterpret_cast<const float4*>(src));
  return make_float4(col < cols ? src[0] : 0.f, col + 1 < cols ? src[1] : 0.f,
                     col + 2 < cols ? src[2] : 0.f,
                     col + 3 < cols ? src[3] : 0.f);
}

// Both operands of a one-pass product rounded to TF32 in one launch: x
// (rows x cols, row-major) into y (rows x pitch, zero in the pad columns
// cols .. pitch - 1), a's words first, then b's.  The padded words of both
// are indexed flat in 16-byte words, ROUND_INFLIGHT of them a thread a grid
// stride apart, all loaded before any is stored; every store is 16 bytes
// (y is 16-byte aligned and its pitch a multiple of 4).  Bound by bytes:
// each word read once, written once.
__global__ void __launch_bounds__(ROUND_NT)
tf32_round_operands_kernel(const float* __restrict__ a, float* __restrict__ ra,
                           long long a_rows, int a_cols, int a_pitch,
                           const float* __restrict__ b, float* __restrict__ rb,
                           long long b_rows, int b_cols, int b_pitch) {
  const long long a_quads = a_rows * (a_pitch / 4);
  const long long quads = a_quads + b_rows * (b_pitch / 4);
  const bool a_vec =
      a_cols % 4 == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  const bool b_vec =
      b_cols % 4 == 0 && (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  const long long stride = static_cast<long long>(gridDim.x) * ROUND_NT;
  for (long long q0 = blockIdx.x * static_cast<long long>(ROUND_NT) +
                      threadIdx.x;
       q0 < quads; q0 += ROUND_INFLIGHT * stride) {
    float4 v[ROUND_INFLIGHT];
#pragma unroll
    for (int i = 0; i < ROUND_INFLIGHT; ++i) {
      const long long q = q0 + i * stride;
      if (q < a_quads)
        v[i] = load_quad(a, q, a_cols, a_pitch, a_vec);
      else if (q < quads)
        v[i] = load_quad(b, q - a_quads, b_cols, b_pitch, b_vec);
    }
#pragma unroll
    for (int i = 0; i < ROUND_INFLIGHT; ++i) {
      const long long q = q0 + i * stride;
      if (q >= quads) break;
      float* y = q < a_quads ? ra + 4 * q : rb + 4 * (q - a_quads);
      *reinterpret_cast<float4*>(y) =
          make_float4(tf32_word(v[i].x), tf32_word(v[i].y),
                      tf32_word(v[i].z), tf32_word(v[i].w));
    }
  }
}

// Launches tf32_round_operands_kernel on ``st``: a (a_rows x a_cols) into
// ra (a_rows x a_pitch), b (b_rows x b_cols) into rb (b_rows x b_pitch),
// both pitches multiples of 4, ra and rb 16-byte aligned.  A thread a
// 16-byte word up to ROUND_MAX_BLOCKS blocks; past that, up to
// ROUND_INFLIGHT words a thread at once, and more loop.  (Four words a
// thread on a quarter of the blocks was slower up to the (768, 768) pair:
// tune_port.py probe 20, PERF.md.)
inline cudaError_t round_operands(const float* a, float* ra, long long a_rows,
                                  int a_cols, int a_pitch, const float* b,
                                  float* rb, long long b_rows, int b_cols,
                                  int b_pitch, cudaStream_t st) {
  const long long quads = a_rows * (a_pitch / 4) + b_rows * (b_pitch / 4);
  long long blocks = (quads + ROUND_NT - 1) / ROUND_NT;
  if (blocks > ROUND_MAX_BLOCKS) blocks = ROUND_MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  tf32_round_operands_kernel<<<static_cast<unsigned>(blocks), ROUND_NT, 0,
                               st>>>(a, ra, a_rows, a_cols, a_pitch, b, rb,
                                     b_rows, b_cols, b_pitch);
  return cudaGetLastError();
}

// The wgmma body's operands: a (a_rows x a1) and b (b_rows x b1) rounded
// into ``scratch`` on ``st``, a's rows (a1 + 3) / 4 * 4 words apart, then
// b's (b1 + 3) / 4 * 4 (16-byte aligned where ``scratch`` is).  ``err`` is
// cudaErrorInvalidValue without scratch.
struct Rounded {
  const float* a;
  const float* b;
  cudaError_t err;
};

inline Rounded round_into(const float* a, long long a_rows, int a1,
                          const float* b, long long b_rows, int b1,
                          float* scratch, cudaStream_t st) {
  if (scratch == nullptr) return {a, b, cudaErrorInvalidValue};
  const int a_pitch = (a1 + 3) & ~3;
  const int b_pitch = (b1 + 3) & ~3;
  float* ra = scratch;
  float* rb = scratch + a_rows * a_pitch;
  return {ra, rb, round_operands(a, ra, a_rows, a1, a_pitch, b, rb, b_rows,
                                 b1, b_pitch, st)};
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// the tensor cores write d between the issue and the wait: pin every use
// of it behind the wait (and its A words' lifetime up to it)
__device__ __forceinline__ void wg_pin(float (&d)[32]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) asm volatile("" : "+f"(d[k])::"memory");
}

template <int N>
__device__ __forceinline__ void wg_pin(uint32_t (&u)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) asm volatile("" : "+r"(u[k])::"memory");
}

// the descriptor of the K-major, unswizzled window at shared address
// ``addr``: LBO the chunk stride (the next 4 of a's columns), SBO 128
// bytes (the next 8 window rows)
__device__ __forceinline__ uint64_t window_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(WgGeo::CHUNK_BYTES >> 4) << 16 |
         static_cast<uint64_t>(128 >> 4) << 32;
}

// d (+)= A (64x8 tf32, this warp's 16 rows in a) * B (8x64 tf32 at desc);
// d = A B where ``scale_d`` is 0
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           uint32_t a0, uint32_t a1,
                                           uint32_t a2, uint32_t a3,
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(scale_d)
      : "memory");
}

// A chain of the stage's first KS k-steps of j0 = g0 + dj into d from
// zero, then grp += d.  For the j0 whose b row starts at ``sB + dj
// B_PITCH``: u[i] is word x0 + 8 - 4 i of the row (x0 = 16 w + g - t +
// KB), and k-step ks takes a0 = u[2 ks + 2], a1 = u[2 ks], a2 = u[2 ks +
// 3], a3 = u[2 ks + 1] (T^T[n][k] is word n - k - 8 ks + KB) and the
// descriptor of k-step 0 at dj = 0 (``desc0``) less dj, two chunks on a
// k-step.  Every operand is in registers before the fence.
template <int KS>
__device__ __forceinline__ void j0_chain(float (&grp)[32], float (&d)[32],
                                         uint32_t (&u)[WgGeo::U],
                                         const uint32_t* sB, int x0,
                                         uint64_t desc0, int dj) {
  const uint32_t* brow = sB + dj * WgGeo::B_PITCH;
#pragma unroll
  for (int i = 0; i < 2 * KS + 2; ++i) u[i] = brow[x0 + 8 - 4 * i];
  uint64_t dk[KS];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    dk[ks] = desc0 - dj + 2 * ks * WgGeo::CHUNK_ROWS;
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_tf32(d, u[2 * ks + 2], u[2 * ks], u[2 * ks + 3], u[2 * ks + 1],
               dk[ks], ks);
  wg_commit();
  wg_wait_all();
  wg_pin(d);
  wg_pin(u);
#pragma unroll
  for (int k = 0; k < 32; ++k) grp[k] += d[k];
}

// K4b's chain of residue class r: both j0 of the class in the stage, dj =
// r then r + 8, each over the stage's first KS k-steps, in one chain into
// d from zero (2 KS k-steps, one wait), then grp += d.  The words and
// descriptors of j0_chain, for both rows.
template <int KS>
__device__ __forceinline__ void class_chain(float (&grp)[32], float (&d)[32],
                                            const uint32_t* sB, int x0,
                                            uint64_t desc0, int r) {
  constexpr int W = 2 * KS + 2;
  uint32_t u0[W];
  uint32_t u1[W];
  const uint32_t* brow = sB + r * WgGeo::B_PITCH;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    u0[i] = brow[x0 + 8 - 4 * i];
    u1[i] = brow[8 * WgGeo::B_PITCH + x0 + 8 - 4 * i];
  }
  uint64_t dk[KS];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    dk[ks] = desc0 - r + 2 * ks * WgGeo::CHUNK_ROWS;
  uint64_t dk8[KS];  // eight window rows up: dj = r + 8
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) dk8[ks] = dk[ks] - 8;
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_tf32(d, u0[2 * ks + 2], u0[2 * ks], u0[2 * ks + 3], u0[2 * ks + 1],
               dk[ks], ks);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_tf32(d, u1[2 * ks + 2], u1[2 * ks], u1[2 * ks + 3], u1[2 * ks + 1],
               dk8[ks], 1);
  wg_commit();
  wg_wait_all();
  wg_pin(d);
  wg_pin(u0);
  wg_pin(u1);
#pragma unroll
  for (int k = 0; k < 32; ++k) grp[k] += d[k];
}

// The chains of one stage over its live j0, dj in [dj_lo, dj_hi):
// ASCENDING, a chain per j0 in j0 order; RESIDUE, dj mod 8 outer, a chain
// per class over its live j0 (both: class_chain; one: j0_chain).  A full
// stage waits 16 times ascending, 8 times residue-major.
template <Order ORDER, int KS>
__device__ __forceinline__ void stage_chains(float (&grp)[32],
                                             float (&d)[32],
                                             const uint32_t* sB, int x0,
                                             uint64_t desc0, int dj_lo,
                                             int dj_hi) {
  uint32_t u[WgGeo::U] = {};
  if constexpr (ORDER == ASCENDING) {
    for (int dj = dj_lo; dj < dj_hi; ++dj)
      j0_chain<KS>(grp, d, u, sB, x0, desc0, dj);
  } else {
    for (int r = 0; r < 8; ++r) {
      const bool first = r >= dj_lo && r < dj_hi;
      const bool second = r + 8 >= dj_lo && r + 8 < dj_hi;
      if (first && second)
        class_chain<KS>(grp, d, sB, x0, desc0, r);
      else if (first || second)
        j0_chain<KS>(grp, d, u, sB, x0, desc0, first ? r : r + 8);
    }
  }
}

// One unit: the tile at (K0, K1) summed over j0 in [j0_lo, j0_hi) and j1
// in [j1_lo, j1_hi) (both nonempty and inside b), of the rounded operands
// ``a`` (a0 x a1) and ``b`` (b1 columns), rows padded to a_pitch / b_pitch
// = a1 / b1 rounded up to 4 words, 16-byte aligned, zero in the pad.
// ``to_slot``: ``out`` is a dense BM x BN workspace tile, written whole;
// otherwise it is c (row-major c0 x c1), written where k < (c0, c1).
// ``smem`` holds WgGeo::SMEM bytes, 16-byte aligned.  ORDER: the j0 order
// of a stage's chains (stage_chains).
template <Order ORDER>
__device__ __forceinline__ void wgmma_unit(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ out, bool to_slot, int a0, int a1, int b1, int c0,
    int c1, int K0, int K1, int j0_lo, int j0_hi, int j1_lo, int j1_hi,
    unsigned char* __restrict__ smem) {
  using L = WgGeo;
  constexpr int G = L::G;
  constexpr int KB = L::KB;
  const int a_pitch = (a1 + 3) & ~3;
  const int b_pitch = (b1 + 3) & ~3;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  // a's columns whose band meets the unit's j1 range, the first rounded
  // down to a whole chunk
  const int i1_lo = max(0, K1 - j1_hi + 1) & ~3;
  const int i1_hi = min(a1, K1 + BN - j1_lo);
  const int n_blocks = (i1_hi - i1_lo + KB - 1) / KB;
  const int n_stages = (j0_hi - j0_lo + G - 1) / G * n_blocks;
  // the j0 at which some window row K0 + m - j0 lies in [0, a0)
  const int w_lo = max(j0_lo, K0 - a0 + 1);
  const int w_hi = min(j0_hi, K0 + BM);
  const uint32_t smem_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  // the copies of stage ``st`` into its slot, committed as a group (an
  // empty one past the last stage).  Window row r, chunk ch: A[K0 - (g0 +
  // G - 1) + r][i1_0 + 4 ch .. + 3]; j0 = g0 + dj reads rows m + G - 1 -
  // dj, so a group of fewer than G rows (a unit's last) leaves its first
  // rows unstaged.  b row dj, word x: B[g0 + dj][K1 - i1_0 - KB + x], a
  // 16-byte aligned start (K1 and i1_0 are multiples of 4).
  auto issue = [&](int st) {
    if (st < n_stages) {
      const int g0 = j0_lo + st / n_blocks * G;
      const int i1_0 = i1_lo + st % n_blocks * KB;
      const int n_dj = min(G, j0_hi - g0);
      unsigned char* buf = smem + (st % L::STAGES) * L::STAGE_BYTES;
      const int row0 = K0 - (g0 + G - 1);
      for (int e = (G - n_dj) * L::CHUNKS + tid; e < L::A_ROWS * L::CHUNKS;
           e += NT) {
        const int r = e / L::CHUNKS;
        const int ch = e % L::CHUNKS;
        const int ar = row0 + r;
        const int col = i1_0 + 4 * ch;
        const bool ok = ar >= 0 && ar < a0 && col < a_pitch;
        copy_async16(buf + ch * L::CHUNK_BYTES + 16 * r,
                     ok ? a + static_cast<size_t>(ar) * a_pitch + col : a,
                     ok);
      }
      float* sB = reinterpret_cast<float*>(buf + L::W_BYTES);
      const int col0 = K1 - i1_0 - KB;
      for (int e = tid; e < n_dj * (L::B_PITCH / 4); e += NT) {
        const int dj = e / (L::B_PITCH / 4);
        const int q = e - dj * (L::B_PITCH / 4);
        const int j1 = col0 + 4 * q;
        const float* row = b + static_cast<size_t>(g0 + dj) * b_pitch;
        float* dst = sB + dj * L::B_PITCH + 4 * q;
        if (j1 >= j1_lo && j1 + 4 <= j1_hi) {
          copy_async16(dst, row + j1, true);
        } else if (j1 + 4 <= j1_lo || j1 >= j1_hi) {
          copy_async16(dst, b, false);
        } else {  // across an end of the unit's j1 range
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const bool ok = j1 + k >= j1_lo && j1 + k < j1_hi;
            copy_async<4>(dst + k, ok ? row + j1 + k : b, ok);
          }
        }
      }
    }
    commit_group();
  };

  float acc[32];
  float grp[32];
  float d[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    acc[k] = 0.f;
    grp[k] = 0.f;
    d[k] = 0.f;
  }

  for (int st = 0; st + 1 < L::STAGES; ++st) issue(st);
  for (int st = 0; st < n_stages; ++st) {
    // this thread's copies of stage st have landed; make them visible to
    // the async proxy, then to every thread.  Every thread is past stage
    // st - 1, whose wgmma all completed: its slot takes the next stage.
    wait_group<L::STAGES - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    issue(st + L::STAGES - 1);

    const int g0 = j0_lo + st / n_blocks * G;
    const int i1_0 = i1_lo + st % n_blocks * KB;
    const int dj_lo = max(0, w_lo - g0);
    const int dj_hi = min(G, w_hi - g0);
    const int ks_hi = min(L::S, (i1_hi - i1_0 + 7) / 8);
    if (dj_lo >= dj_hi) continue;
    const int slot = st % L::STAGES;
    const uint32_t* sB = reinterpret_cast<const uint32_t*>(
        smem + slot * L::STAGE_BYTES + L::W_BYTES);
    // k-step 0 of dj = 0: window row G - 1 of chunk 0
    const uint64_t desc0 =
        window_desc(smem_addr + slot * L::STAGE_BYTES) + (G - 1);
    const int x0 = 16 * warp + g - t + KB;
    switch (ks_hi) {  // the chains' k-step count as a compile-time one
#define WG_STAGE(KS)                                               \
  case KS:                                                         \
    stage_chains<ORDER, KS>(grp, d, sB, x0, desc0, dj_lo, dj_hi);  \
    break;
      WG_STAGE(1)
      WG_STAGE(2)
      WG_STAGE(3)
      WG_STAGE(4)
      WG_STAGE(5)
      WG_STAGE(6)
      WG_STAGE(7)
      WG_STAGE(8)
#undef WG_STAGE
    }
    // a stage ends a group
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      acc[k] += grp[k];
      grp[k] = 0.f;
    }
  }

#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * j + 2 * t + e;
        const int n = 16 * warp + 8 * h + g;
        const float x = acc[4 * j + 2 * h + e];
        if (to_slot)
          out[m * BN + n] = x;
        else if (K0 + m < c0 && K1 + n < c1)
          out[static_cast<size_t>(K0 + m) * c1 + K1 + n] = x;
      }
}

// The unit table's row u, as conv2d_unit.cuh::run_unit reads it.
template <Order ORDER>
__device__ __forceinline__ void run_wgmma_unit(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ c, float* __restrict__ work,
    const int4* __restrict__ units, int u, int a0, int a1, int b1, int c0,
    int c1, unsigned char* __restrict__ smem) {
  const int4 p = units[2 * u];
  const int4 q = units[2 * u + 1];
  const bool to_slot = q.z >= 0;
  float* out = to_slot ? work + static_cast<size_t>(q.z) * TILE_WORDS : c;
  wgmma_unit<ORDER>(a, b, out, to_slot, a0, a1, b1, c0, c1, p.x, p.y, p.z,
                    p.w, q.x, q.y, smem);
}

// the one-pass body over a single pair's unit table, on rounded operands.
// Three blocks an SM for RESIDUE: its class chain holds 36 b words and 16
// descriptors, ~176 registers unbounded (two blocks an SM); held to 168
// (a few spilled words, no serialized wgmma) it was faster at 512 and 768
// (tune_port.py probe 20, PERF.md)
template <Order ORDER>
__global__ void __launch_bounds__(NT, ORDER == RESIDUE ? 3 : 2)
conv2d_trunc_f32_wgmma_kernel(const float* __restrict__ a,
                              const float* __restrict__ b,
                              float* __restrict__ c, float* __restrict__ work,
                              const int4* __restrict__ units, int a0, int a1,
                              int b1, int c0, int c1) {
  extern __shared__ __align__(16) unsigned char wg_smem[];
  run_wgmma_unit<ORDER>(a, b, c, work, units, blockIdx.x, a0, a1, b1, c0, c1,
                        wg_smem);
}

// The one-pass launches of a single pair with b of at least 8 columns (the
// tile and grouped entries): a (a0 x a1) and b (b0 x b1) rounded into
// ``scratch`` (round_into), then the body over the ``n_units`` units.
template <Order ORDER>
cudaError_t round_and_run_wgmma(const float* a, const float* b, float* c,
                                float* work, const int4* units, int n_units,
                                int a0, int a1, int b0, int b1, int c0,
                                int c1, float* scratch, cudaStream_t st) {
  static bool allowed[64] = {};
  const Rounded r = round_into(a, a0, a1, b, b0, b1, scratch, st);
  if (r.err != cudaSuccess) return r.err;
  auto kernel = conv2d_trunc_f32_wgmma_kernel<ORDER>;
  const cudaError_t err = allow_smem(kernel, WgGeo::SMEM, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<n_units, NT, WgGeo::SMEM, st>>>(r.a, r.b, c, work, units, a0, a1,
                                            b1, c0, c1);
  return cudaGetLastError();
}

}  // namespace
