// Kernel A: the covariance tile, out[i, j] = k(sum_d (a[i, d] - b[j, d])^2).
//
// Replaces three Pallas call sites that share one body:
//   gpis_tpu/kernels/pallas_gram.py    gram_pallas      (pallas_call at :197)
//   gpis_tpu/kernels/pallas_gram.py    cross_cov_pallas (pallas_call at :109)
//   gpis_tpu/kernels/pallas_query.py   _stage_kq        (pallas_call at :294)
// and, in band mode,
//   gpis_tpu/kernels/pallas_gram.py    gram_band_pallas (pallas_call at :173,
//                                      body `_band_kernel` :125)
// sym != 0 is the Gram mode: a row band of K(b, b) whose row i is global row
// row0 + i (row0 = 0 and m = n for the whole Gram); where row0 + i == j the
// entry is replaced by the exact k(0) plus noise[i] (k(0) alone when noise is
// null), as `_gram_kernel` does on its diagonal tiles and `_band_kernel` at
// its offset.  k(0) is formed in double from the launch's lengthscale and
// signal variance and rounded once to T, as the twin forms it.
//
// What bounds it on the H100: the store.  Each element is written once
// (M * N * sizeof(T) bytes, 1 GiB for the 16,384^2 f32 Gram) against ~12
// flops and one exp, so the kernel is write-bound at HBM bandwidth.  A 64 x
// 32 tile of 4-byte stores, the covariance chosen by a switch and the
// diagonal tested at every element reached 50 % of that bound (PERF.md §6).
// What the design does about it, after Kernel E (csrc/joint.cu):
//   * a 64 x 128 tile of 256 threads: each thread owns 4 consecutive
//     columns (their coordinates in registers) and walks COV_ROWS = 8 rows
//     from shared memory, a warp one row at a time;
//   * each row's 4 values stored as one 16-byte vector (two in float64),
//     evict-first, where the output's rows start on 16 bytes (n % 4 == 0),
//     scalars otherwise and at the ragged right edge;
//   * the covariance a template parameter, dispatched once at launch;
//   * the diagonal decided a tile: only tiles it crosses test each element;
//   * M < 8 rows take M warps (the planner's M = 1 chart predict), so that
//     no warp of the CTA idles.
// r^2 is taken directly per dimension, never as |a|^2 - 2 a.b + |b|^2, which
// cancels as r -> 0 (see the module note of pallas_gram.py); expf / sqrtf,
// not their 2-ulp intrinsics; 64-bit offsets.  The values are those of the
// 64 x 32 tile bit for bit (the same expression an element), but k(0) on the
// diagonal, which that tile rounded twice in float32 for the inverse
// multiquadric and the thin plate.
// Measured in float32 by scripts/torch_cov_turns.py (the card's time, in
// turns with the 64 x 32 tile; PERF.md §6), NVIDIA H100 80GB HBM3 at
// 700.00 W: the 16,384^2 Gram 0.3316 ms, 96.7 % of its byte bound (the old
// tile 0.5544 ms, 57.8 %); the 8,192 x 16,384 cross 0.1663 ms, 96.4 %; the
// 8,192 x 7,168 cross 0.0746 ms, 94.0 %; the band of 8,192 rows of the
// C = 32,768 Gram 0.3313 ms, 96.8 %; M = 1 and M = 256 against 17,408
// columns 2.62 and 8.49 us (the old tile 3.03 and 11.78 us).  The float32
// rbf row loop: 90 SASS instructions a row of 4 values, one MUFU.EX2 a
// value, 48 registers, no spills.
// Plain FP32 (FP64) arithmetic, see common.cuh.
#include "common.cuh"

namespace gpis {

// Chosen by scripts/torch_cov_turns.py --variants (PERF.md §6):
constexpr int COV_ROWS = 8;  // rows a thread walks at most (one vector a row)
constexpr int COV_MIN_CTAS = 4;  // float32 CTAs a multiprocessor
constexpr int COV_COLS = 128;  // 32 lanes x 4 columns
constexpr int COV_WARPS = NTHREADS / 32;
constexpr int COV_TILE_ROWS = COV_WARPS * COV_ROWS;

// One row's 4 values as 16-byte vector stores, evict-first (st.global.cs:
// nothing rereads the tile here).
__device__ __forceinline__ void store4(float* o, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(o), make_float4(v[0], v[1], v[2], v[3]));
}

__device__ __forceinline__ void store4(double* o, const double (&v)[4]) {
  __stcs(reinterpret_cast<double2*>(o), make_double2(v[0], v[1]));
  __stcs(reinterpret_cast<double2*>(o) + 1, make_double2(v[2], v[3]));
}

// The thread's rows warp, warp + warps, ... < rows of the tile against its
// 4 columns cb .. cb + 3.  DIAG: the tile holds part of the diagonal, whose
// column in row rr is cb + dj + rr.
template <typename T, int KID, bool DIAG>
__device__ __forceinline__ void cov_rows(const T (*sa)[4], const T (&bc)[4][3], int rows,
                                         int warps, T* o, int64_t step, bool vec, int64_t n,
                                         int64_t cb, T ls, T sv, int64_t dj, T k0,
                                         const T* noise) {
  for (int rr = threadIdx.x / 32; rr < rows; rr += warps, o += step) {
    const T a0 = sa[rr][0], a1 = sa[rr][1], a2 = sa[rr][2];
    T v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const T d0 = a0 - bc[c][0], d1 = a1 - bc[c][1], d2 = a2 - bc[c][2];
      v[c] = k_r2(KID, d0 * d0 + d1 * d1 + d2 * d2, ls, sv);
    }
    if (DIAG) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (dj + rr == c) v[c] = k0 + (noise ? noise[rr] : T(0));
    }
    if (vec) {
      store4(o, v);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (cb + c < n) o[c] = v[c];
    }
  }
}

// One CTA of `warps` = blockDim.x / 32 warps a tile of warps * COV_ROWS x
// COV_COLS; thread (warp, lane) owns columns cb .. cb + 3 and rows warp,
// warp + warps, ...
template <typename T, int KID>
__global__ void __launch_bounds__(NTHREADS, sizeof(T) == 4 ? COV_MIN_CTAS : 1)
cov_kernel(const T* __restrict__ a, int64_t m, const T* __restrict__ b, int64_t n,
           const T* __restrict__ noise, int sym, int64_t row0, double ls, double sv,
           T* __restrict__ out, int64_t col_tiles) {
  __shared__ __align__(16) T sa[COV_TILE_ROWS][4];
  const int warps = blockDim.x / 32;
  const int tile_rows = warps * COV_ROWS;
  const int64_t r0 = (int64_t)blockIdx.x / col_tiles * tile_rows;
  const int64_t c0 = (int64_t)blockIdx.x % col_tiles * COV_COLS;
  const int rows = (int)min64(tile_rows, m - r0);
  for (int e = threadIdx.x; e < rows * 3; e += blockDim.x) sa[e / 3][e % 3] = a[r0 * 3 + e];
  const int64_t cb = c0 + 4 * (threadIdx.x % 32);  // the thread's first column
  T bc[4][3];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int d = 0; d < 3; ++d) bc[c][d] = cb + c < n ? b[(cb + c) * 3 + d] : T(0);
  __syncthreads();
  if (cb >= n) return;
  const bool vec = n % 4 == 0 && cb + 3 < n;
  const int64_t step = warps * n;  // out's stride from one of the thread's rows to the next
  T* o = out + (r0 + threadIdx.x / 32) * n + cb;
  // Does the diagonal j = row0 + i cross this tile?
  if (sym && row0 + r0 < c0 + COV_COLS && c0 < row0 + r0 + rows) {
    const T k0 = (T)k_diag0(KID, ls, sv);
    cov_rows<T, KID, true>(sa, bc, rows, warps, o, step, vec, n, cb, (T)ls, (T)sv,
                           row0 + r0 - cb, k0, noise ? noise + r0 : nullptr);
  } else {
    cov_rows<T, KID, false>(sa, bc, rows, warps, o, step, vec, n, cb, (T)ls, (T)sv, 0, T(0),
                            nullptr);
  }
}

template <typename T, int KID>
static void launch_kid(const T* a, int64_t m, const T* b, int64_t n, const T* noise, int sym,
                       int64_t row0, double ls, double sv, T* out, int64_t col_tiles,
                       int64_t tiles, int warps, cudaStream_t stream) {
  cov_kernel<T, KID><<<(unsigned int)tiles, 32 * warps, 0, stream>>>(
      a, m, b, n, noise, sym, row0, ls, sv, out, col_tiles);
}

template <typename T>
static int launch_cov(const T* a, int64_t m, const T* b, int64_t n, const T* noise, int sym,
                      int64_t row0, int kid, double ls, double sv, T* out, void* stream) {
  if (m == 0 || n == 0) return 0;
  // Warps beyond the rows would idle.
  const int warps = m < COV_WARPS ? (int)m : COV_WARPS;
  const int64_t col_tiles = (n + COV_COLS - 1) / COV_COLS;
  const int tile_rows = warps * COV_ROWS;
  const int64_t tiles = (m + tile_rows - 1) / tile_rows * col_tiles;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (kid) {
    case RBF:
      launch_kid<T, RBF>(a, m, b, n, noise, sym, row0, ls, sv, out, col_tiles, tiles, warps,
                         st);
      break;
    case LAPLACE:
      launch_kid<T, LAPLACE>(a, m, b, n, noise, sym, row0, ls, sv, out, col_tiles, tiles,
                             warps, st);
      break;
    case INVERSE_MULTIQUADRIC:
      launch_kid<T, INVERSE_MULTIQUADRIC>(a, m, b, n, noise, sym, row0, ls, sv, out, col_tiles,
                                          tiles, warps, st);
      break;
    case THIN_PLATE:
      launch_kid<T, THIN_PLATE>(a, m, b, n, noise, sym, row0, ls, sv, out, col_tiles, tiles,
                                warps, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace gpis

extern "C" {

int gpis_cov_f32(const float* a, int64_t m, const float* b, int64_t n, const float* noise,
                 int sym, int64_t row0, int kid, double ls, double sv, float* out,
                 void* stream) {
  return gpis::launch_cov<float>(a, m, b, n, noise, sym, row0, kid, ls, sv, out, stream);
}

int gpis_cov_f64(const double* a, int64_t m, const double* b, int64_t n, const double* noise,
                 int sym, int64_t row0, int kid, double ls, double sv, double* out,
                 void* stream) {
  return gpis::launch_cov<double>(a, m, b, n, noise, sym, row0, kid, ls, sv, out, stream);
}

}  // extern "C"
