// Shared device code for the gpis_tpu_torch kernels (sm_90a): the
// covariance functions and their derivatives in r2 that Kernels A (cov.cu),
// E (joint.cu) and F's kq generators (quad.cuh) evaluate, and the CTA size
// and index helpers of the SIMT kernels.  The products of B, C, D, F, G, H,
// J, K and L run on the tensor cores in split TF32 (tc_nn.cuh), float32
// only.
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

// Threads of a SIMT kernel's CTA (A, E, and D's and F's means).
constexpr int NTHREADS = 256;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

inline unsigned int ceil_div(int64_t a, int64_t b) { return (unsigned int)((a + b - 1) / b); }

}  // namespace gpis
