// The split of K5, the ozaki route (genfer_tpu_torch/ops/ozaki_conv.py):
// for both f64 operands of every product of a batch, a (batch x a0 x a1)
// and b (batch x b0 x b1), row-major, in one launch,
//
//   * each column's power-of-two exponent e = ceil(log2 max|x[:, c]|) + 1
//     (1 for an all-zero column), exact from frexp, and the column scaled
//     by 2^-e exactly (in two steps where 2^-e overflows: a subnormal
//     column max);
//   * the first n_t of its 8 chunks of 7 bits: x * 2^-e = sum_t C_t
//     2^-7(t+1) + R, |C_t| <= 64, as int8 (or bf16, exact for such
//     integers) in the layout of ozaki.cuh: [batch][n_t][cols][P], each
//     column's rows contiguous and padded with zeros to P, a multiple of 16
//     rows, a's reversed, b's ascending;
//   * one flag a product: set to 1 where a[z] or b[z] holds an entry that
//     is not finite (K5 reads it on the device: the guard).
//
// Replaces, with ozaki_conv2d.cu, the split of genfer_tpu's
// ops/ozaki_conv.py::ozaki_conv2d_traced (192), which ran in XLA:
// _pow2_colexp (82) and _chunk_int (121).  The chunks, seen in the plain
// version's [n_t, rows, cols] view (ozaki_conv.py::chunk_view), equal
// ozaki_split_reference's bit for bit: one conversion of x 2^56 to int64,
// rounding half to even as jnp.round does (__double2ll_rn, not round()),
// then c = (i + 2^(shift-1)) >> shift, an arithmetic shift of a signed
// int64, and i -= c * 2^shift, a multiplication (a left shift of a
// negative int64 is undefined in C++17).  genfer_tpu's float split
// (_chunk, 102) runs only in the plain version, and ozaki_conv.py raises
// for it on the card.
//
// What bounds it on the H100: bytes (each x read once, n_t bytes an entry,
// or 2 n_t for bf16, and 4 a column written once), the same for every
// batch entry.  A block of 256 threads owns 8 columns of one operand of one
// product (so that a (512, 512) pair fills 128 blocks and a stencil's 268
// columns 34; 128 threads where both operands have at most 64 rows, so
// that 16 blocks fit an SM where the products are small and many): a warp
// reads 4 row segments of 8 columns (64 bytes each) at once, every row
// twice, for the column maxima (reduced through shared
// memory) and, 64 rows at a time, to split them into a shared-memory tile
// of the chunks, column-major, from which 16-byte pieces of whole rows
// are written out (a column's rows are contiguous in the layout, so a row
// segment's bytes would otherwise scatter over 8 columns).  Each thread's
// loads of a pass are unrolled, so that they are in flight together: the
// kernel is short, and its time is the memory latency of a few rounds.
// The tile's columns are 4 bytes longer than their rows, so that a warp's
// byte stores fall in distinct banks.

#include <cuda_bf16.h>

#include <cstdint>

#include "ozaki.cuh"

namespace {

constexpr int SPLIT_COLS = 8;   // columns a block
constexpr int SPLIT_TILE = 64;  // rows a pass of the transposing tile
constexpr int SPLIT_UNROLL = 4;  // rows a thread loads at once in pass 1

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
struct SplitTile {
  static constexpr int PITCH = SPLIT_TILE * static_cast<int>(sizeof(E)) + 4;
  static constexpr int PR = 16 / static_cast<int>(sizeof(E));  // piece rows
};

// SPLIT_ROWS threads a block down the rows: 32, or 16 where both operands
// have at most 64 rows (more blocks an SM for many small products)
template <typename E, int SPLIT_ROWS>
__global__ void __launch_bounds__(SPLIT_COLS * SPLIT_ROWS)
ozaki_split_kernel(const double* __restrict__ a,
                   const double* __restrict__ b, int a0, int a1, int b0,
                   int b1, int blocks_a, int blocks_b, int n_t,
                   E* __restrict__ ca, E* __restrict__ cb,
                   int* __restrict__ ea, int* __restrict__ eb,
                   int* __restrict__ flags) {
  using L = SplitTile<E>;
  constexpr int SPLIT_NT = SPLIT_COLS * SPLIT_ROWS;
  __shared__ double red[SPLIT_ROWS][SPLIT_COLS];
  __shared__ __align__(16) unsigned char tile[OZ_N_CHUNKS * SPLIT_COLS *
                                              L::PITCH];
  const int per = blocks_a + blocks_b;
  const int z = blockIdx.x / per;
  int blk = blockIdx.x - z * per;
  const bool is_a = blk < blocks_a;
  if (!is_a) blk -= blocks_a;
  const int rows = is_a ? a0 : b0;
  const int cols = is_a ? a1 : b1;
  const int P = oz_padded(rows);
  const double* x = is_a ? a + static_cast<size_t>(z) * a0 * a1
                         : b + static_cast<size_t>(z) * b0 * b1;
  E* chunks = (is_a ? ca : cb) + static_cast<size_t>(z) * n_t * cols * P;
  int* exps = (is_a ? ea : eb) + static_cast<size_t>(z) * cols;

  const int tx = threadIdx.x % SPLIT_COLS;
  const int ty = threadIdx.x / SPLIT_COLS;
  const int c = blk * SPLIT_COLS + tx;
  double m = 0.0;
  bool finite = true;
  // the first round's rows are kept: they are the first tile's rows of
  // this thread (r = ty + k SPLIT_ROWS), read once where rows <= 64
  double first[SPLIT_UNROLL];
#pragma unroll
  for (int k = 0; k < SPLIT_UNROLL; ++k) first[k] = 0.0;  // ty >= rows
  for (int r0 = ty; r0 < rows; r0 += SPLIT_ROWS * SPLIT_UNROLL) {
    double v[SPLIT_UNROLL];
#pragma unroll
    for (int k = 0; k < SPLIT_UNROLL; ++k) {
      const int r = r0 + k * SPLIT_ROWS;
      v[k] = c < cols && r < rows ? x[static_cast<size_t>(r) * cols + c]
                                  : 0.0;
    }
#pragma unroll
    for (int k = 0; k < SPLIT_UNROLL; ++k) {
      if (r0 == ty) first[k] = v[k];
      finite = finite && isfinite(v[k]);
      m = fmax(m, fabs(v[k]));
    }
  }
  if (!finite) atomicOr(flags + z, 1);
  red[ty][tx] = m;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < SPLIT_ROWS; ++k) m = fmax(m, red[k][tx]);
  int e = 1;
  if (m > 0.0) {
    int ex;
    const double mant = frexp(m, &ex);
    e = ex - (mant == 0.5 ? 1 : 0) + 1;
  }
  if (ty == 0 && c < cols) exps[c] = e;
  // x 2^-e exactly: where 2^-e overflows (a subnormal column max, e <
  // -1023), in two steps that both scale up (ozaki_conv.py::_scale_columns)
  const int up = -e > 1023 ? 1000 : 0;
  const double scale_up = pow2(up);
  const double scale = pow2(-e - up);
  const size_t plane = static_cast<size_t>(cols) * P;
  for (int r0 = 0; r0 < P; r0 += SPLIT_TILE) {
    __syncthreads();  // the last pass's pieces are out of the tile
    constexpr int PER = SPLIT_TILE / SPLIT_ROWS;  // rows a thread a pass
    static_assert(PER <= SPLIT_UNROLL, "the first tile's rows are kept");
    double v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int r = r0 + ty + k * SPLIT_ROWS;
      v[k] = r0 == 0 ? first[k]
             : c < cols && r < rows ? x[static_cast<size_t>(r) * cols + c]
                                    : 0.0;
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int rr = ty + k * SPLIT_ROWS;
      // rows past the end (the padding) split to zeros
      const double xs = __dmul_rn(__dmul_rn(v[k], scale_up), scale);
      long long i = __double2ll_rn(__dmul_rn(xs, 72057594037927936.0));
      // a's tile reversed: position 63 - rr, so that its pieces are a's
      // positions P - r0 - 64 + (0 .. 63)
      const int at = is_a ? SPLIT_TILE - 1 - rr : rr;
#pragma unroll
      for (int t = 0; t < OZ_N_CHUNKS; ++t) {
        if (t >= n_t) break;
        const int shift = OZ_CHUNK_BITS * (OZ_N_CHUNKS - 1 - t);
        const long long ch = shift ? (i + (1LL << (shift - 1))) >> shift : i;
        i -= ch * (1LL << shift);
        reinterpret_cast<E*>(tile + (t * SPLIT_COLS + tx) * L::PITCH)[at] =
            chunk_value<E>(ch);
      }
    }
    __syncthreads();
    // 16-byte pieces of whole rows: those of rows r0 .. P - 1
    const int n_rows = min(SPLIT_TILE, P - r0);  // a multiple of 16
    const int pieces = SPLIT_TILE / L::PR;
    const int first = is_a ? (SPLIT_TILE - n_rows) / L::PR : 0;
    const int last = is_a ? pieces : n_rows / L::PR;
    const int n_p = last - first;
    for (int k = threadIdx.x; k < n_t * SPLIT_COLS * n_p; k += SPLIT_NT) {
      const int q = first + k % n_p;
      const int rest = k / n_p;
      const int col = rest % SPLIT_COLS;
      const int t = rest / SPLIT_COLS;
      const int gc = blk * SPLIT_COLS + col;
      if (gc >= cols) continue;
      const unsigned* w = reinterpret_cast<const unsigned*>(
          tile + (t * SPLIT_COLS + col) * L::PITCH + 16 * q);
      const int pos = (is_a ? P - r0 - SPLIT_TILE : r0) + q * L::PR;
      *reinterpret_cast<uint4*>(chunks + t * plane +
                                static_cast<size_t>(gc) * P + pos) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

}  // namespace

// Launches on ``stream``; returns the CUDA error of the launch (0 when it
// was accepted).  ``a`` batch x a0 x a1 and ``b`` batch x b0 x b1 f64 on
// the current device; ``ca`` batch x n_t x a1 x oz_padded(a0) and ``cb``
// batch x n_t x b1 x oz_padded(b0) int8 (bf16 where ``bf16``), 16-byte
// aligned; ``ea`` batch x a1 and ``eb`` batch x b1 int32; ``flags`` batch
// int32 the kernel only sets (the caller zeroes them).  1 <= n_t <= 8.
extern "C" int ozaki_split(const double* a, const double* b, int batch,
                           int a0, int a1, int b0, int b1, int n_t, int bf16,
                           void* ca, void* cb, int* ea, int* eb, int* flags,
                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks_a = (a1 + SPLIT_COLS - 1) / SPLIT_COLS;
  const int blocks_b = (b1 + SPLIT_COLS - 1) / SPLIT_COLS;
  const long long grid = static_cast<long long>(blocks_a + blocks_b) * batch;
  if (grid > INT_MAX || n_t < 1 || n_t > OZ_N_CHUNKS)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const unsigned g = static_cast<unsigned>(grid);
  const bool small = a0 <= SPLIT_TILE && b0 <= SPLIT_TILE;
#define OZ_SPLIT(E, R)                                                      \
  ozaki_split_kernel<E, R><<<g, SPLIT_COLS * R, 0, st>>>(                  \
      a, b, a0, a1, b0, b1, blocks_a, blocks_b, n_t, static_cast<E*>(ca),  \
      static_cast<E*>(cb), ea, eb, flags)
  if (bf16 && small)
    OZ_SPLIT(__nv_bfloat16, 16);
  else if (bf16)
    OZ_SPLIT(__nv_bfloat16, 32);
  else if (small)
    OZ_SPLIT(int8_t, 16);
  else
    OZ_SPLIT(int8_t, 32);
#undef OZ_SPLIT
  return static_cast<int>(cudaGetLastError());
}
