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
// What bounds it on the H100: the store (1.85 GB for the f32 Gram at
// J = 21,504), once the arithmetic is lean.  The blend above, with k, dk and
// d2k each from its own exp and the covariance chosen by a switch at every
// element, took ~117 SASS instructions an element (scripts/
// torch_joint_turns.py counts them): at 462 M elements that is more issue
// time than the store.  What the design does about it:
//   * k, 2 dk and -4 d2k from one transcendental (`joint_derivs`: one exp for
//     the RBF, one rsqrt for the inverse multiquadric, one sqrt for the thin
//     plate), the covariance a template parameter;
//   * the blend collapsed by the row's kind.  Callers lay rows out as values
//     (u = 0, f = 1) or gradients along axis a (u = e_a exactly, f = 0), and
//     for such a row the blend is exactly
//         value row:       f_c k - 2 dk vd
//         gradient row a:  2 dk (f_c diff_a - u_c[a]) - 4 d2k diff_a vd
//     for ANY column: the terms left out are a flag or direction of 0 times
//     a finite number.  A column's kind enters through its flag and one-hot
//     direction, so no column is classified and no warp diverges at C, 2C,
//     3C or 4C.  A row of any other metadata keeps the full blend.  A warp
//     walks one row at a time, so the row's kind is uniform in it;
//   * the noise diagonal tested only in tiles it crosses, decided a tile;
//   * a 256 x 128 tile of 256 threads: each thread owns 4 consecutive
//     columns (metadata in registers) and walks JOINT_ROWS = 32 rows,
//     storing each row's 4 values as one 16-byte vector (two in float64)
//     where the output's rows start on 16 bytes (s % 4 == 0), scalars
//     otherwise and at the ragged right edge; 4 CTAs a multiprocessor in
//     float32.  (A persistent grid and a cp.async.bulk store of the tile
//     from shared memory measured no faster, PERF.md §6.)
// Plain FP32 (FP64) arithmetic, see common.cuh.
#include "common.cuh"

namespace gpis {

constexpr int META = 7;  // coords (3), dirs (3), flag
// Chosen by scripts/torch_joint_turns.py --variants (PERF.md §6):
constexpr int JOINT_ROWS = 32;  // rows a thread walks (one vector a row)
constexpr int JOINT_MIN_CTAS = 4;  // float32 CTAs a multiprocessor (64 registers, no spills)
constexpr int JT_COLS = 128;  // 32 lanes x 4 columns
constexpr int JT_ROWS = NTHREADS / 32 * JOINT_ROWS;

// A row's kind: the blend it collapses to.
enum JointKind { KIND_VALUE = 0, KIND_GRAD0 = 1, KIND_GRAD1 = 2, KIND_GRAD2 = 3, KIND_GENERAL = 4 };

template <typename T>
__device__ __forceinline__ int joint_kind(const T* m) {
  const T u0 = m[3], u1 = m[4], u2 = m[5], f = m[6];
  if (u0 == T(0) && u1 == T(0) && u2 == T(0) && f == T(1)) return KIND_VALUE;
  if (f == T(0) && u0 == T(1) && u1 == T(0) && u2 == T(0)) return KIND_GRAD0;
  if (f == T(0) && u0 == T(0) && u1 == T(1) && u2 == T(0)) return KIND_GRAD1;
  if (f == T(0) && u0 == T(0) && u1 == T(0) && u2 == T(1)) return KIND_GRAD2;
  return KIND_GENERAL;
}

// The covariance's constants, hoisted out of the element loop.
template <typename T>
struct JointCoef {
  T sv, ls, a, b, k0;  // RBF: a = -1/(2 ls^2), b = 1/ls^2; thin plate: a = ls^3
};

template <typename T, int KID>
__device__ __forceinline__ JointCoef<T> joint_coef(T ls, T sv) {
  JointCoef<T> c{sv, ls, T(0), T(0), k_diag0(KID, ls, sv)};
  if (KID == RBF) {
    c.b = T(1) / (ls * ls);
    c.a = T(-0.5) * c.b;
  } else if (KID == THIN_PLATE) {
    c.a = ls * ls * ls;
  } else {
    c.a = ls * ls;
  }
  return c;
}

__device__ __forceinline__ float grsqrt(float v) { return rsqrtf(v); }
__device__ __forceinline__ double grsqrt(double v) { return rsqrt(v); }

// k(r2), g = 2 dk/dr2 and h = -4 d2k/dr2^2 (the blend's own scalings) from
// one transcendental; h is left unclamped (the thin plate's is infinite at
// r = 0): every use is behind the r2 <= 1e-24 mask.
template <typename T, int KID>
__device__ __forceinline__ void joint_derivs(T r2, const JointCoef<T>& c, T& k, T& g, T& h) {
  if constexpr (KID == RBF) {  // k = sv e^{-r2 / 2ls^2}, dk = -k / 2ls^2, d2k = k / 4ls^4
    k = c.sv * gexp(c.a * r2);
    g = -c.b * k;
    h = -c.b * c.b * k;
  } else if constexpr (KID == INVERSE_MULTIQUADRIC) {  // k = sv s^-1/2, s = r2 + ls^2
    const T rs = grsqrt(r2 + c.a);
    const T inv = rs * rs;
    k = c.sv * rs;
    g = -k * inv;
    h = T(-3) * k * inv * inv;
  } else {  // THIN_PLATE: k = sv (2 r^3 - 3 R r^2 + R^3), dk = 3 sv (r - R), d2k = 1.5 sv / r
    const T r = gsqrt(r2);
    k = c.sv * (r2 * (T(2) * r - T(3) * c.ls) + c.a);
    g = T(6) * c.sv * (r - c.ls);
    h = T(-6) * c.sv / r;
  }
}

// One row against the thread's 4 columns cm: v[m] = K[row, column m].
template <typename T, int KID, int KIND>
__device__ __forceinline__ void joint_row(const T* rm, const T (&cm)[4][META],
                                          const JointCoef<T>& c, T (&v)[4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const T d0 = rm[0] - cm[m][0], d1 = rm[1] - cm[m][1], d2 = rm[2] - cm[m][2];
    const T r2 = d0 * d0 + d1 * d1 + d2 * d2;
    const bool zero = r2 <= T(1e-24);
    T k, g, h;
    joint_derivs<T, KID>(r2, c, k, g, h);
    h = zero ? T(0) : h;
    const T vd = cm[m][3] * d0 + cm[m][4] * d1 + cm[m][5] * d2;
    if constexpr (KIND == KIND_VALUE) {
      k = zero ? c.k0 : k;
      v[m] = cm[m][6] * k - g * vd;
    } else if constexpr (KIND == KIND_GENERAL) {
      k = zero ? c.k0 : k;
      const T ud = rm[3] * d0 + rm[4] * d1 + rm[5] * d2;
      const T uv = rm[3] * cm[m][3] + rm[4] * cm[m][4] + rm[5] * cm[m][5];
      v[m] = rm[6] * cm[m][6] * k + g * (ud * cm[m][6] - vd * rm[6] - uv) + h * ud * vd;
    } else {  // gradient along axis a = KIND - 1: u_c[a] is cm[m][2 + KIND]
      const T da = KIND == KIND_GRAD0 ? d0 : (KIND == KIND_GRAD1 ? d1 : d2);
      v[m] = g * (cm[m][6] * da - cm[m][2 + KIND]) + h * da * vd;
    }
  }
}

// One row's 4 values as 16-byte vector stores, evict-first (st.global.cs:
// nothing rereads the tile here).  The intrinsic also keeps nvcc from
// splitting a vector into scalars, which it did to a plain float4 store.
__device__ __forceinline__ void store4(float* o, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(o), make_float4(v[0], v[1], v[2], v[3]));
}

__device__ __forceinline__ void store4(double* o, const double (&v)[4]) {
  __stcs(reinterpret_cast<double2*>(o), make_double2(v[0], v[1]));
  __stcs(reinterpret_cast<double2*>(o) + 1, make_double2(v[2], v[3]));
}

// One CTA a tile of JT_ROWS x JT_COLS; thread (ty, tx) = (warp, lane) owns
// columns cb .. cb + 3 and rows ty, ty + 8, ...
template <typename T, int KID>
__global__ void __launch_bounds__(NTHREADS, sizeof(T) == 4 ? JOINT_MIN_CTAS : 1)
joint_cov_kernel(const T* __restrict__ rmeta, int64_t r, const T* __restrict__ cmeta, int64_t s,
                 const T* __restrict__ noise, int64_t row0, T ls, T sv, T* __restrict__ out,
                 int64_t col_tiles) {
  __shared__ T sr[JT_ROWS][META];
  __shared__ int skind[JT_ROWS];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int64_t r0 = (int64_t)blockIdx.x / col_tiles * JT_ROWS;
  const int64_t c0 = (int64_t)blockIdx.x % col_tiles * JT_COLS;
  for (int e = threadIdx.x; e < JT_ROWS * META; e += NTHREADS) {
    const int64_t i = r0 + e / META;
    sr[e / META][e % META] = i < r ? rmeta[i * META + e % META] : T(0);
  }
  __syncthreads();
  for (int rr = threadIdx.x; rr < JT_ROWS; rr += NTHREADS) skind[rr] = joint_kind(sr[rr]);
  const JointCoef<T> coef = joint_coef<T, KID>(ls, sv);
  const int64_t cb = c0 + 4 * tx;  // the thread's first column
  T cm[4][META];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int d = 0; d < META; ++d) cm[m][d] = cb + m < s ? cmeta[(cb + m) * META + d] : T(0);
  // Does the diagonal j = row0 + i cross this tile?
  const bool diag = noise != nullptr && row0 + r0 < c0 + JT_COLS && c0 < row0 + r0 + JT_ROWS;
  const bool vec = s % 4 == 0 && cb + 3 < s;
  const int rows = (int)min64(JT_ROWS, r - r0);
  const int64_t step = NTHREADS / 32 * s;  // out's stride from one of the thread's rows to the next
  T* o = out + (r0 + ty) * s + cb;
  __syncthreads();
  for (int rr = ty; rr < rows; rr += NTHREADS / 32, o += step) {
    const T* rm = sr[rr];
    T v[4];
    switch (skind[rr]) {
      case KIND_VALUE: joint_row<T, KID, KIND_VALUE>(rm, cm, coef, v); break;
      case KIND_GRAD0: joint_row<T, KID, KIND_GRAD0>(rm, cm, coef, v); break;
      case KIND_GRAD1: joint_row<T, KID, KIND_GRAD1>(rm, cm, coef, v); break;
      case KIND_GRAD2: joint_row<T, KID, KIND_GRAD2>(rm, cm, coef, v); break;
      default: joint_row<T, KID, KIND_GENERAL>(rm, cm, coef, v);
    }
    if (diag) {
      const int64_t dj = row0 + r0 + rr - cb;  // the diagonal's column, from cb
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (dj == m && cb + m < s) v[m] += noise[cb + m];
    }
    if (vec) {
      store4(o, v);
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (cb + m < s) o[m] = v[m];
    }
  }
}

template <typename T, int KID>
static void launch_kid(const T* rmeta, int64_t r, const T* cmeta, int64_t s, const T* noise,
                       int64_t row0, T ls, T sv, T* out, cudaStream_t stream) {
  const int64_t col_tiles = ceil_div(s, JT_COLS);
  const unsigned int tiles = ceil_div(r, JT_ROWS) * (unsigned int)col_tiles;
  joint_cov_kernel<T, KID><<<tiles, NTHREADS, 0, stream>>>(rmeta, r, cmeta, s, noise, row0, ls,
                                                             sv, out, col_tiles);
}

template <typename T>
static int launch_joint_cov(const T* rmeta, int64_t r, const T* cmeta, int64_t s, const T* noise,
                            int64_t row0, int kid, double ls, double sv, T* out, void* stream) {
  if (r == 0 || s == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (kid) {  // Laplace has no d2k: the wrapper refuses it
    case RBF:
      launch_kid<T, RBF>(rmeta, r, cmeta, s, noise, row0, (T)ls, (T)sv, out, st);
      break;
    case INVERSE_MULTIQUADRIC:
      launch_kid<T, INVERSE_MULTIQUADRIC>(rmeta, r, cmeta, s, noise, row0, (T)ls, (T)sv, out, st);
      break;
    case THIN_PLATE:
      launch_kid<T, THIN_PLATE>(rmeta, r, cmeta, s, noise, row0, (T)ls, (T)sv, out, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
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
