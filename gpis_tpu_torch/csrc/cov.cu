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
// entry is the exact k(0) plus noise[i] (noise may be null), as
// `_gram_kernel` does on its diagonal tiles and `_band_kernel` at its offset.
//
// What bounds it on the H100: the store.  Each element is written once
// (M * N * sizeof(T) bytes, 1 GiB for the 16,384^2 f32 Gram) against ~12
// flops and one exp, so the kernel is write-bound at HBM bandwidth.
// What the design does about it: a block owns a 64-row x 32-column tile;
// the 64 row points sit in shared memory, each thread keeps its column
// point in registers and walks the rows, so a warp stores 32 consecutive
// floats of one row per instruction (fully coalesced) and the only DRAM
// reads are the 3-float coordinates.  r^2 is taken directly per dimension,
// never as |a|^2 - 2 a.b + |b|^2, which cancels as r -> 0 (see the module
// note of pallas_gram.py).  Accumulation: plain FP32 (FP64) arithmetic, see
// common.cuh.
#include "common.cuh"

namespace gpis {

constexpr int COV_ROWS = 64;
constexpr int COV_COLS = 32;

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
cov_kernel(const T* __restrict__ a, int64_t m, const T* __restrict__ b, int64_t n,
           const T* __restrict__ noise, int sym, int64_t row0, int kid, T ls, T sv,
           T* __restrict__ out) {
  __shared__ T sa[COV_ROWS][3];
  const int64_t col_tiles = (n + COV_COLS - 1) / COV_COLS;
  const int64_t tile0 = (int64_t)(blockIdx.x / col_tiles) * COV_ROWS;
  const int64_t j = (int64_t)(blockIdx.x % col_tiles) * COV_COLS + threadIdx.x % COV_COLS;
  for (int e = threadIdx.x; e < COV_ROWS * 3; e += NTHREADS) {
    int64_t r = tile0 + e / 3;
    sa[e / 3][e % 3] = r < m ? a[r * 3 + e % 3] : T(0);
  }
  __syncthreads();
  if (j >= n) return;
  const T b0 = b[j * 3], b1 = b[j * 3 + 1], b2 = b[j * 3 + 2];
  const T diag = k_diag0(kid, ls, sv);
  for (int r = threadIdx.x / COV_COLS; r < COV_ROWS; r += NTHREADS / COV_COLS) {
    const int64_t i = tile0 + r;
    if (i >= m) break;
    const T d0 = sa[r][0] - b0, d1 = sa[r][1] - b1, d2 = sa[r][2] - b2;
    T v = k_r2(kid, d0 * d0 + d1 * d1 + d2 * d2, ls, sv);
    if (sym && row0 + i == j) v = diag + (noise ? noise[i] : T(0));
    out[i * n + j] = v;
  }
}

template <typename T>
static int launch_cov(const T* a, int64_t m, const T* b, int64_t n, const T* noise, int sym,
                      int64_t row0, int kid, double ls, double sv, T* out, void* stream) {
  if (m == 0 || n == 0) return 0;
  const unsigned int blocks = ceil_div(m, COV_ROWS) * ceil_div(n, COV_COLS);
  cov_kernel<T><<<blocks, NTHREADS, 0, (cudaStream_t)stream>>>(a, m, b, n, noise, sym, row0,
                                                                kid, (T)ls, (T)sv, out);
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
