// Kernels B and C: the two products of the left-looking blocked Cholesky and
// of the left-looking blocked TRSM W = L^{-1}.
//
// B, panel update, replaces gpis_tpu/linalg/pallas_chol.py
// `panel_update_pallas` (pallas_call at :180, body `_panel_kernel` :87):
//     M[r, j0 + c] -= sum_{k < j0} M[r, k] * M[j0 + c, k]
// for rows r >= j0 and panel columns c < bw, IN PLACE on the one n x n
// buffer of the in-place factorization.  It reads columns < j0 (the finished
// L) and writes columns [j0, j0 + bw) (A's panel), which are disjoint, so no
// block reads what another writes.  Rows above j0 are left alone; the
// factorization zeroes them, as the row mask at pallas_chol.py:682-683 does.
//
// C, row update, replaces `row_update_pallas` (pallas_call at :569, body
// `_row_kernel` :502):
//     out[b, c] = sum_{k < j0} lrow[b, k] * W[k, c]   for c < j0, else 0
// where W's rows < j0 are finished and lower-triangular.  `lrow` may alias
// W's own buffer (the in-place TRSM reads L's row panel j0 from it); the
// output is a separate (bw, n) buffer.
//
// What bounds them on the H100: arithmetic.  At n = 16,384 each factor is
// ~n^3/3 multiply-adds, against 2 n^2 * 4 bytes of traffic per step, so both
// sit far above the memory roofline; without tensor cores the bound is the
// SIMT FP32 rate (67 TFLOP/s at 700 W).
// What the design does about it: a shared-memory tiled SGEMM (64 x 64
// output tiles, k-slices of 16, 4 x 4 FMA register tiles a thread) whose k
// loop stops at j0, so the dead k >= j0 half of every product is never
// loaded or multiplied -- "port the skip, not the DMA trick" of the Pallas
// index maps.  C also starts its k loop at the tile's first column, since
// W[k, c] = 0 for k < c, and writes zeros, without reading anything, for
// output tiles at columns >= j0.  Accumulation: plain FP32 (FP64) FMA, see
// common.cuh; tensor cores (wgmma, 3xTF32) are later work.
#include "common.cuh"

namespace gpis {

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
panel_update_kernel(T* __restrict__ mat, int64_t n, int64_t j0, int64_t bw) {
  __shared__ TileSmem<T> sm;
  const int64_t col_tiles = (bw + TILE - 1) / TILE;
  const int64_t row0 = j0 + (int64_t)(blockIdx.x / col_tiles) * TILE;  // global row
  const int64_t col0 = (int64_t)(blockIdx.x % col_tiles) * TILE;       // panel column
  const int rows = (int)min64(TILE, n - row0);
  const int cols = (int)min64(TILE, bw - col0);
  T acc[4][4] = {};
  nt_product(sm, acc, mat + row0 * n, n, rows, mat + (j0 + col0) * n, n, cols, 0, j0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = tx + 16 * jj;
      if (c < cols) mat[(row0 + r) * n + j0 + col0 + c] -= acc[i][jj];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
row_update_kernel(const T* __restrict__ lrow, const T* __restrict__ w, int64_t n, int64_t j0,
                  int64_t bw, T* __restrict__ out) {
  __shared__ TileSmem<T> sm;
  const int64_t col_tiles = (n + TILE - 1) / TILE;
  const int64_t row0 = (int64_t)(blockIdx.x / col_tiles) * TILE;  // row of the panel
  const int64_t col0 = (int64_t)(blockIdx.x % col_tiles) * TILE;  // output column
  const int rows = (int)min64(TILE, bw - row0);
  const int cols = (int)min64(TILE, n - col0);
  T acc[4][4] = {};
  if (col0 < j0) {
    // W lower-triangular: only k >= col0 meets a nonzero W[k, c] in this tile.
    for (int64_t k0 = col0; k0 < j0; k0 += BK) {
      load_rows_kmajor(sm.a, lrow + row0 * n, n, rows, k0, j0);
      load_cols_kmajor(sm.b, w + col0, n, cols, k0, j0);
      __syncthreads();
      tile_fma(sm, acc);
      __syncthreads();
    }
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = tx + 16 * jj;
      if (c < cols) out[(row0 + r) * n + col0 + c] = col0 + c < j0 ? acc[i][jj] : T(0);
    }
  }
}

template <typename T>
static int launch_panel_update(T* mat, int64_t n, int64_t j0, int64_t bw, void* stream) {
  if (j0 <= 0 || bw <= 0 || j0 >= n) return 0;
  const unsigned int blocks = ceil_div(n - j0, TILE) * ceil_div(bw, TILE);
  panel_update_kernel<T><<<blocks, NTHREADS, 0, (cudaStream_t)stream>>>(mat, n, j0, bw);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_row_update(const T* lrow, const T* w, int64_t n, int64_t j0, int64_t bw,
                             T* out, void* stream) {
  if (n <= 0 || bw <= 0) return 0;
  const unsigned int blocks = ceil_div(bw, TILE) * ceil_div(n, TILE);
  row_update_kernel<T><<<blocks, NTHREADS, 0, (cudaStream_t)stream>>>(lrow, w, n, j0, bw, out);
  return (int)cudaGetLastError();
}

}  // namespace gpis

extern "C" {

int gpis_panel_update_f32(float* mat, int64_t n, int64_t j0, int64_t bw, void* stream) {
  return gpis::launch_panel_update<float>(mat, n, j0, bw, stream);
}

int gpis_panel_update_f64(double* mat, int64_t n, int64_t j0, int64_t bw, void* stream) {
  return gpis::launch_panel_update<double>(mat, n, j0, bw, stream);
}

int gpis_row_update_f32(const float* lrow, const float* w, int64_t n, int64_t j0, int64_t bw,
                        float* out, void* stream) {
  return gpis::launch_row_update<float>(lrow, w, n, j0, bw, out, stream);
}

int gpis_row_update_f64(const double* lrow, const double* w, int64_t n, int64_t j0,
                        int64_t bw, double* out, void* stream) {
  return gpis::launch_row_update<double>(lrow, w, n, j0, bw, out, stream);
}

}  // extern "C"
