// Kernel E: the joint (value + gradient) covariance tile.
//
// Replaces gpis_tpu/kernels/pallas_joint.py `joint_rows_pallas` (pallas_call
// at :215, body `_rows_kernel` / `_joint_tile` :88-150).  Every joint index
// carries 7 numbers of metadata, packed as one row (coords p (3), gradient
// direction u (3, zero for a value), value flag f):
//     diff = p_r - p_c,  r2 = |diff|^2,  ud = u_r.diff,  vd = u_c.diff,  uv = u_r.u_c
//     K[r, c] = f_r f_c k + 2 dk (ud f_c - vd f_r - uv) - 4 d2k ud vd
// with k pinned to k(0) and the d2k term masked to 0 where r2 <= 1e-24 (thin
// plate's d2k is singular there).  One body serves the full J x J Gram
// (J = 4C + T), any row band of it, and value-query rows against the joint
// columns (the staged joint kq).
//
// Noise: with noise != null, noise[c] is added where the global row
// row0 + r equals the column c.  noise == null is the explicit no-noise mode
// of a cross-covariance: a query lying exactly on a data point gets none
// (the TPU kernel reached the same end with a negative row0).
//
// What bounds it on the H100: the store, as for Kernel A -- one element
// written per ~40 flops and three exps, 1.85 GB for the f32 Gram at
// J = 21,504.  What the design does about it: Kernel A's tiling.  A block
// owns 64 rows x 32 columns with the rows' metadata in shared memory; each
// thread keeps its column's metadata in registers and walks the rows, so a
// warp stores 32 consecutive elements of one row.  Plain FP32 (FP64)
// arithmetic, see common.cuh.
#include "common.cuh"

namespace gpis {

constexpr int META = 7;  // coords (3), dirs (3), flag
constexpr int JR_ROWS = 64;
constexpr int JR_COLS = 32;

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
joint_cov_kernel(const T* __restrict__ rmeta, int64_t r, const T* __restrict__ cmeta, int64_t s,
                 const T* __restrict__ noise, int64_t row0, int kid, T ls, T sv,
                 T* __restrict__ out) {
  __shared__ T sr[JR_ROWS][META];
  const int64_t col_tiles = (s + JR_COLS - 1) / JR_COLS;
  const int64_t row_base = (int64_t)(blockIdx.x / col_tiles) * JR_ROWS;
  const int64_t j = (int64_t)(blockIdx.x % col_tiles) * JR_COLS + threadIdx.x % JR_COLS;
  for (int e = threadIdx.x; e < JR_ROWS * META; e += NTHREADS) {
    const int64_t i = row_base + e / META;
    sr[e / META][e % META] = i < r ? rmeta[i * META + e % META] : T(0);
  }
  __syncthreads();
  if (j >= s) return;
  T cm[META];
#pragma unroll
  for (int d = 0; d < META; ++d) cm[d] = cmeta[j * META + d];
  const T k0 = k_diag0(kid, ls, sv);
  for (int rr = threadIdx.x / JR_COLS; rr < JR_ROWS; rr += NTHREADS / JR_COLS) {
    const int64_t i = row_base + rr;
    if (i >= r) break;
    const T* rm = sr[rr];
    const T d0 = rm[0] - cm[0], d1 = rm[1] - cm[1], d2 = rm[2] - cm[2];
    const T r2 = d0 * d0 + d1 * d1 + d2 * d2;
    const bool zero = r2 <= T(1e-24);
    const T k = zero ? k0 : k_r2(kid, r2, ls, sv);
    const T dk = dk_dr2(kid, r2, ls, sv);
    const T ud = rm[3] * d0 + rm[4] * d1 + rm[5] * d2;
    const T vd = cm[3] * d0 + cm[4] * d1 + cm[5] * d2;
    const T uv = rm[3] * cm[3] + rm[4] * cm[4] + rm[5] * cm[5];
    const T outer = zero ? T(0) : d2k_dr2(kid, r2, ls, sv) * ud * vd;
    T v = rm[6] * cm[6] * k + T(2) * dk * (ud * cm[6] - vd * rm[6] - uv) - T(4) * outer;
    if (noise != nullptr && row0 + i == j) v += noise[j];
    out[i * s + j] = v;
  }
}

template <typename T>
static int launch_joint_cov(const T* rmeta, int64_t r, const T* cmeta, int64_t s, const T* noise,
                            int64_t row0, int kid, double ls, double sv, T* out, void* stream) {
  if (r == 0 || s == 0) return 0;
  const unsigned int blocks = ceil_div(r, JR_ROWS) * ceil_div(s, JR_COLS);
  joint_cov_kernel<T><<<blocks, NTHREADS, 0, (cudaStream_t)stream>>>(
      rmeta, r, cmeta, s, noise, row0, kid, (T)ls, (T)sv, out);
  return (int)cudaGetLastError();
}

}  // namespace gpis

extern "C" {

int gpis_joint_cov_f32(const float* rmeta, int64_t r, const float* cmeta, int64_t s,
                       const float* noise, int64_t row0, int kid, double ls, double sv,
                       float* out, void* stream) {
  return gpis::launch_joint_cov<float>(rmeta, r, cmeta, s, noise, row0, kid, ls, sv, out, stream);
}

int gpis_joint_cov_f64(const double* rmeta, int64_t r, const double* cmeta, int64_t s,
                       const double* noise, int64_t row0, int kid, double ls, double sv,
                       double* out, void* stream) {
  return gpis::launch_joint_cov<double>(rmeta, r, cmeta, s, noise, row0, kid, ls, sv, out,
                                        stream);
}

}  // extern "C"
