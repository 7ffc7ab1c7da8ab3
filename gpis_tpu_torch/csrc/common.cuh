// Shared device code for the gpis_tpu_torch kernels (sm_90a).
//
// Precision: every product is accumulated with plain FP32 (or FP64) FMA on
// the SIMT cores.  That is exact-grade float32, so the bf16x3 split that the
// TPU kernels needed (gpis_tpu/linalg/pallas_chol.py `_dot3`,
// gpis_tpu/kernels/pallas_query.py `quad_dot`) has no counterpart here, and
// the TF32 trap that the `_QSPLIT` comment measured at ~1e-2 absolute on the
// variance quad cannot occur: no tensor core is used.
//
// Index arithmetic is 64-bit throughout: row * ld + col overflows int32 once
// a C x C matrix has C > 46,340, which an 80 GB card holds in-core.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gpis {

// Covariance function ids; gpis_tpu_torch/kernels/cuda_gram.py KERNEL_IDS.
enum KernelId { RBF = 0, LAPLACE = 1, INVERSE_MULTIQUADRIC = 2, THIN_PLATE = 3 };

__device__ __forceinline__ float gexp(float v) { return expf(v); }
__device__ __forceinline__ double gexp(double v) { return exp(v); }
__device__ __forceinline__ float gsqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double gsqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float gnan(float) { return nanf(""); }
__device__ __forceinline__ double gnan(double) { return nan(""); }

// sqrt clamped at 1e-30, as gpis_tpu/kernels/functions.py `_safe_sqrt`.
template <typename T>
__device__ __forceinline__ T safe_sqrt(T r2) {
  return gsqrt(r2 > T(1e-30) ? r2 : T(1e-30));
}

// k(r2) for the four built-in kernels (gpis_tpu/kernels/functions.py k_r2).
template <typename T>
__device__ __forceinline__ T k_r2(int kid, T r2, T ls, T sv) {
  switch (kid) {
    case RBF: {  // 1 / ls^2 is the same for every value: the compiler hoists it
      const T inv2 = T(1) / (ls * ls);
      return sv * gexp(T(-0.5) * r2 * inv2);
    }
    case LAPLACE:
      return sv * gexp(-safe_sqrt(r2) / ls);
    case INVERSE_MULTIQUADRIC:
      return sv / gsqrt(r2 + ls * ls);
    default: {  // THIN_PLATE: 2r^3 - 3Rr^2 + R^3
      T r = safe_sqrt(r2);
      return sv * (T(2) * r * r2 - T(3) * ls * r2 + ls * ls * ls);
    }
  }
}

// k(0), the exact prior variance on the Gram diagonal (functions.k_diag0).
template <typename T>
__device__ __forceinline__ T k_diag0(int kid, T ls, T sv) {
  switch (kid) {
    case RBF:
    case LAPLACE:
      return sv;
    case INVERSE_MULTIQUADRIC:
      return sv / ls;
    default:
      return sv * ls * ls * ls;
  }
}

// dk/dr2 (functions.dk_dr2): smooth at r2 = 0 for rbf, IMQ and thin plate.
template <typename T>
__device__ __forceinline__ T dk_dr2(int kid, T r2, T ls, T sv) {
  switch (kid) {
    case RBF: {
      const T inv2 = T(1) / (ls * ls);
      return T(-0.5) * inv2 * sv * gexp(T(-0.5) * r2 * inv2);
    }
    case LAPLACE: {
      const T r = safe_sqrt(r2);
      return T(-0.5) * sv * gexp(-r / ls) / (ls * r);
    }
    case INVERSE_MULTIQUADRIC: {  // -0.5 sv (r2 + ls^2)^(-3/2)
      const T s = r2 + ls * ls;
      return T(-0.5) * sv / (s * gsqrt(s));
    }
    default:  // THIN_PLATE: 3 (r - R)
      return sv * T(3) * (safe_sqrt(r2) - ls);
  }
}

// d2k/dr2^2 (functions.d2k_dr2).  Thin plate's 1.5 sv / r is singular at
// r = 0; the callers mask its product with (x-x')(x-x')^T there.  Laplace
// has none: the wrappers refuse it for derivative observations, and a NaN
// would show a call that slipped past them.
template <typename T>
__device__ __forceinline__ T d2k_dr2(int kid, T r2, T ls, T sv) {
  switch (kid) {
    case RBF: {
      const T inv2 = T(1) / (ls * ls);
      return T(0.25) * inv2 * inv2 * sv * gexp(T(-0.5) * r2 * inv2);
    }
    case LAPLACE:
      return gnan(r2);
    case INVERSE_MULTIQUADRIC: {  // 0.75 sv (r2 + ls^2)^(-5/2)
      const T s = r2 + ls * ls;
      return T(0.75) * sv / (s * s * gsqrt(s));
    }
    default:  // THIN_PLATE
      return sv * T(1.5) / safe_sqrt(r2);
  }
}

// ---------------------------------------------------------------------------
// One 64 x 64 output tile of a product, 256 threads, 4 x 4 outputs a thread.
// Thread (ty, tx) = (t / 16, t % 16) owns rows ty + 16 i and columns
// tx + 16 j (i, j < 4), so neighbouring threads write neighbouring columns.
// Shared tiles are stored k-major with one pad column against bank conflicts.
// (128 x 128 tiles with 8 x 8 register tiles measured slower: 99 registers a
// thread leave 2 blocks an SM, too few to hide the unprefetched tile loads.)
constexpr int TILE = 64;
constexpr int BK = 16;
constexpr int NTHREADS = 256;

template <typename T>
struct TileSmem {
  T a[BK][TILE + 1];
  T b[BK][TILE + 1];
};

// Loads rows [0, rows) x k [k0, k0 + BK) of a row-major matrix whose k index
// is contiguous (element (r, k) at p[r * ld + k]) into s[k][r], zero-filled
// outside rows and k_end.
template <typename T>
__device__ __forceinline__ void load_rows_kmajor(T (*s)[TILE + 1], const T* __restrict__ p,
                                                 int64_t ld, int rows, int64_t k0,
                                                 int64_t k_end) {
#pragma unroll
  for (int e = threadIdx.x; e < TILE * BK; e += NTHREADS) {
    int r = e / BK, kk = e % BK;
    int64_t k = k0 + kk;
    s[kk][r] = (r < rows && k < k_end) ? p[(int64_t)r * ld + k] : T(0);
  }
}

// Loads k [k0, k0 + BK) x columns [0, cols) of a row-major matrix whose
// column index is contiguous (element (k, c) at p[k * ld + c]) into s[k][c].
template <typename T>
__device__ __forceinline__ void load_cols_kmajor(T (*s)[TILE + 1], const T* __restrict__ p,
                                                 int64_t ld, int cols, int64_t k0,
                                                 int64_t k_end) {
#pragma unroll
  for (int e = threadIdx.x; e < TILE * BK; e += NTHREADS) {
    int kk = e / TILE, c = e % TILE;
    int64_t k = k0 + kk;
    s[kk][c] = (c < cols && k < k_end) ? p[k * ld + c] : T(0);
  }
}

// acc[i][j] += sum over the BK slice of a[k][ty + 16 i] * b[k][tx + 16 j].
template <typename T>
__device__ __forceinline__ void tile_fma(const TileSmem<T>& sm, T (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    T av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = sm.a[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = sm.b[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
  }
}

// acc = A[rows of the tile, k_begin:k_end] . B[cols of the tile, k_begin:k_end]^T
// with both operands k-contiguous ("NT"), as in the Cholesky panel update and
// the variance quad.
template <typename T>
__device__ __forceinline__ void nt_product(TileSmem<T>& sm, T (&acc)[4][4],
                                           const T* __restrict__ a, int64_t lda, int a_rows,
                                           const T* __restrict__ b, int64_t ldb, int b_rows,
                                           int64_t k_begin, int64_t k_end) {
  for (int64_t k0 = k_begin; k0 < k_end; k0 += BK) {
    load_rows_kmajor(sm.a, a, lda, a_rows, k0, k_end);
    load_rows_kmajor(sm.b, b, ldb, b_rows, k0, k_end);
    __syncthreads();
    tile_fma(sm, acc);
    __syncthreads();
  }
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

inline unsigned int ceil_div(int64_t a, int64_t b) { return (unsigned int)((a + b - 1) / b); }

}  // namespace gpis
