// What Kernels D (query.cu) and F (fused_query.cu) share: the kq generators
// of F, which the tensor-core tile (tc_nn.cuh, a generated B) and F's mean
// call, and the pass that sums the variance quad's partials.
#pragma once

#include "common.cuh"

namespace gpis {

// Covariance of a value query q (f = 1, u = 0) with one training column.
struct ValueGen {  // column metadata: x (3)
  static constexpr int STRIDE = 3;
  template <typename T>
  __device__ __forceinline__ static T eval(int kid, const T (&q)[3], const T* __restrict__ col,
                                           T ls, T sv) {
    const T d0 = q[0] - col[0], d1 = q[1] - col[1], d2 = q[2] - col[2];
    return k_r2(kid, d0 * d0 + d1 * d1 + d2 * d2, ls, sv);
  }
};

struct JointGen {  // column metadata: coords (3), dirs (3), flag -- joint.cu's layout
  static constexpr int STRIDE = 7;
  template <typename T>
  __device__ __forceinline__ static T eval(int kid, const T (&q)[3], const T* __restrict__ col,
                                           T ls, T sv) {
    const T d0 = q[0] - col[0], d1 = q[1] - col[1], d2 = q[2] - col[2];
    const T r2 = d0 * d0 + d1 * d1 + d2 * d2;
    const T vd = col[3] * d0 + col[4] * d1 + col[5] * d2;
    return col[6] * k_r2(kid, r2, ls, sv) - T(2) * dk_dr2(kid, r2, ls, sv) * vd;
  }
};

// quad[q] = sum_i partial[i, q] over the `tiles` row tiles of W, in order:
// no atomics, so a result repeats bit for bit.
template <typename T>
__global__ void quad_reduce_kernel(const T* __restrict__ partial, int64_t m, int64_t tiles,
                                   T* __restrict__ quad) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= m) return;
  T s = T(0);
  for (int64_t i = 0; i < tiles; ++i) s += partial[i * m + q];
  quad[q] = s;
}

}  // namespace gpis
