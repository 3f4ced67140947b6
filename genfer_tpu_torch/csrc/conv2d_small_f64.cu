// K1's small-operand body: truncated 2-D Cauchy products in IEEE f64 where
// one operand of each pair holds at most a few coefficients (the stencils
// of the --backend jax main path: (255,268)x(2,2), (308,314)x(2,2)).  For
// every batch entry z,
//
//     c[z, k0, k1] = sum_{j0, j1} s_z[j0, j1] * a_z[k0 - j0, k1 - j1]
//
// with s the smaller operand (at most SMALL_LIMIT coefficients; the
// routing constant ops/conv2d_f64.py::SMALL_MAX_COEFFS sends it fewer) and
// a the other.  The twin of the same function as conv2d_trunc_f64.cu (K1,
// which replaces genfer_tpu/taylor/backend.py::_conv_dense's 2-axis branch
// and its staircase _conv_dense_2d_blocked) for the shapes where the
// tensor-core body would issue tens of times the useful multiply-adds.
//
// What bounds it on the H100: bytes.  A (255,268)x(2,2) product moves
// ~1.1 MB (a read once, c written once) and does 0.27M multiply-adds, so
// 3.35 TB/s puts it at ~0.33 us; at such sizes the launch costs more.  The
// design therefore asks nothing of the host but one launch:
//
//   * no unit plan, no table, no workspace, no zero fill, no second pass:
//     a 1-D grid over (batch entry, 32x32 output tile), entry-major, its
//     size from the shapes alone;
//   * a block stages its window of a (the tile plus s0 - 1 rows and s1 - 1
//     columns of halo above and to the left, zero outside a) in shared
//     memory, by 16-byte loads where a's rows are 16-byte aligned (``vec``:
//     an even row length and an aligned base) and 8-byte loads otherwise,
//     and the s0 x s1 coefficients of s once;
//   * each thread writes its 4 outputs (one column, 4 rows) once, their
//     four fma chains interleaved (one coefficient read serves four steps;
//     a long chain alone waits on each fma's latency): a warp reads 32
//     consecutive window words (conflict-free) and s by broadcast;
//   * determinism: each output is one fma chain from +0.0 over j0
//     ascending, then j1 ascending (``acc = fma(s[j0, j1], a[k0 - j0, k1 -
//     j1], acc)``, the window's zeros included), so the result depends on
//     the shapes alone: the same bits on any card, run to run, and every
//     batch entry equals its single-pair call.

#include <climits>
#include <cstddef>

#include <cuda_runtime.h>

namespace {

constexpr int SMALL_NT = 256;  // threads a block
constexpr int SMALL_TR = 32;   // output rows a tile
constexpr int SMALL_TC = 32;   // output columns a tile (one a warp)
constexpr int SMALL_RPT = SMALL_TR / (SMALL_NT / SMALL_TC);  // rows a thread
// most coefficients s may hold: the window (<= (TR + 63) x TC or TR x (TC
// + 64) words) and s stay under the 48 KB a block gets without opting in
constexpr int SMALL_LIMIT = 64;
static_assert(SMALL_RPT * (SMALL_NT / SMALL_TC) == SMALL_TR, "tile rows");

// s1 - 1 halo columns, rounded up to even
__host__ __device__ constexpr int even_halo(int s1) { return s1 & ~1; }

__global__ void __launch_bounds__(SMALL_NT)
conv2d_small_f64_kernel(const double* __restrict__ a,
                        const double* __restrict__ s, double* __restrict__ c,
                        int tiles1, int tiles, int a0, int a1, int s0, int s1,
                        int c0, int c1, int r0, bool vec,
                        const int* __restrict__ flag) {
  extern __shared__ __align__(16) double small_smem[];
  const int z = blockIdx.x / tiles;
  if (flag != nullptr && flag[z] == 0) return;  // the guard's predicate
  const int tile = blockIdx.x - z * tiles;
  const int K0 = r0 + tile / tiles1 * SMALL_TR;
  const int K1 = tile % tiles1 * SMALL_TC;
  const int h0 = s0 - 1;
  // window columns start e1 left of K1 (even, so that a 16-byte load of
  // an aligned row starts on an even column); window word (r, q) is
  // a[K0 - h0 + r][K1 - e1 + q]
  const int e1 = even_halo(s1);
  const int rows = SMALL_TR + h0;
  const int width = SMALL_TC + e1;
  double* sw = small_smem;
  double* ss = small_smem + rows * width;
  const double* az = a + static_cast<size_t>(z) * a0 * a1;
  const double* sz = s + static_cast<size_t>(z) * s0 * s1;
  const int tid = threadIdx.x;

  for (int i = tid; i < s0 * s1; i += SMALL_NT) ss[i] = sz[i];
  const int row0 = K0 - h0;
  const int col0 = K1 - e1;
  if (vec) {
    const int half = width / 2;
    for (int i = tid; i < rows * half; i += SMALL_NT) {
      const int r = i / half;
      const int q = 2 * (i - r * half);
      const int ar = row0 + r;
      const int aq = col0 + q;  // even
      // a1 and aq are even: the pair lies wholly inside a's row or
      // wholly outside it
      double2 v = make_double2(0.0, 0.0);
      if (ar >= 0 && ar < a0 && aq >= 0 && aq < a1)
        v = *reinterpret_cast<const double2*>(
            az + static_cast<size_t>(ar) * a1 + aq);
      *reinterpret_cast<double2*>(sw + r * width + q) = v;
    }
  } else {
    for (int i = tid; i < rows * width; i += SMALL_NT) {
      const int r = i / width;
      const int q = i - r * width;
      const int ar = row0 + r;
      const int aq = col0 + q;
      sw[i] = ar >= 0 && ar < a0 && aq >= 0 && aq < a1
                  ? az[static_cast<size_t>(ar) * a1 + aq]
                  : 0.0;
    }
  }
  __syncthreads();

  const int x = tid % SMALL_TC;
  const int y0 = tid / SMALL_TC * SMALL_RPT;
  const int k1 = K1 + x;
  // the thread's SMALL_RPT outputs, one independent fma chain each, their
  // steps interleaved: for each (j0, j1) one coefficient serves them all
  double acc[SMALL_RPT];
#pragma unroll
  for (int i = 0; i < SMALL_RPT; ++i) acc[i] = 0.0;
  for (int j0 = 0; j0 < s0; ++j0) {
    // window row of a[K0 + y0 - j0], word of a[.][k1]
    const double* w = sw + (y0 + h0 - j0) * width + x + e1;
    for (int j1 = 0; j1 < s1; ++j1) {
      const double sj = ss[j0 * s1 + j1];
#pragma unroll
      for (int i = 0; i < SMALL_RPT; ++i)
        acc[i] = fma(sj, w[i * width - j1], acc[i]);
    }
  }
  if (k1 >= c1) return;
  double* cz = c + static_cast<size_t>(z) * (c0 - r0) * c1;
#pragma unroll
  for (int i = 0; i < SMALL_RPT; ++i)
    if (K0 + y0 + i < c0)
      cz[static_cast<size_t>(K0 + y0 + i - r0) * c1 + k1] = acc[i];
}

}  // namespace

// Launches on ``stream``; returns the CUDA error of the launch (0 when it
// was accepted).  a (batch x a0 x a1), s (batch x s0 x s1) and c (batch x
// (c0 - r0) x c1: output rows r0 .. c0 - 1 of each product, 0 <= r0 <
// c0) are contiguous row-major f64 on the current device, all sizes >= 1,
// s0 * s1 <= SMALL_LIMIT; ``vec``: a is 16-byte aligned and a1 is even.
// An output's fma chain does not depend on r0: a window's rows equal the
// same rows of the whole product bit for bit.  Every output word is written, except where ``flag`` (batch
// int32, or null: the guard of ozaki_conv2d.cu) holds 0 for the entry: its
// blocks return at once.
extern "C" int conv2d_small_f64(const double* a, const double* s, double* c,
                                int batch, int a0, int a1, int s0, int s1,
                                int c0, int c1, int r0, int vec,
                                const int* flag, void* stream) {
  if (s0 * s1 > SMALL_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles1 = (c1 + SMALL_TC - 1) / SMALL_TC;
  const long long tiles =
      static_cast<long long>((c0 - r0 + SMALL_TR - 1) / SMALL_TR) * tiles1;
  if (tiles * batch > INT_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = sizeof(double) *
                      ((SMALL_TR + s0 - 1) * (SMALL_TC + even_halo(s1)) +
                       s0 * s1);
  conv2d_small_f64_kernel<<<static_cast<unsigned>(tiles * batch), SMALL_NT,
                            smem, static_cast<cudaStream_t>(stream)>>>(
      a, s, c, tiles1, static_cast<int>(tiles), a0, a1, s0, s1, c0, c1, r0,
      vec != 0, flag);
  return static_cast<int>(cudaGetLastError());
}
