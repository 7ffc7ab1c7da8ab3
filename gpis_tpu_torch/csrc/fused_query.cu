// Kernel F: the on-the-fly variance quad and mean, kq generated in-tile.
//
// Replaces four Pallas kernels with one body and two kq-tile generators:
//   gpis_tpu/kernels/pallas_query.py  fused_query_pallas       (pallas_call at :404,
//                                     body `_kernel` :110)         -- ValueGen
//   gpis_tpu/kernels/pallas_joint.py  fused_joint_query_pallas (pallas_call at :367,
//                                     body `_query_kernel` :258)   -- JointGen
// and, in band mode (quad only, no mean),
//   gpis_tpu/kernels/pallas_query.py  fused_quad_band_pallas   (pallas_call at :241,
//                                     body `_band_quad_kernel` :162)  -- ValueGen
//   gpis_tpu/kernels/pallas_joint.py  fused_joint_quad_band_pallas (pallas_call at
//                                     :500, body `_joint_band_quad_kernel` :408) -- JointGen
// Given queries q (m, 3), the c training columns' metadata, W = L^{-1}
// (c, c) lower-triangular and alpha (c,):
//     kq[q, k]  = k(r2)                               value model, column x_k
//               = f_k k(r2) - 2 dk(r2) (u_k . diff)   joint model, column (p_k, u_k, f_k)
//     mean[q]   = sum_k kq[q, k] alpha[k]
//     quad[q]   = sum_i (sum_k W[i, k] kq[q, k])^2    (var = k(0) - quad)
// kq never reaches device memory, so a query of any size runs in O(m) extra
// memory: the route for queries whose staged kq (Kernel A or E, then D)
// would exceed the staging cap.
//
// Band mode: W is a row band, rows [row_base, row_base + R) of the factor's
// W, stored with its own leading dimension (the out-of-core store keeps
// trimmed panels).  Its row tile i ends at global row row_base + (i+1)*64,
// so its live columns are k < row_base + (i+1)*64, not (i+1)*64: the bound
// carries the band's offset.  The out-of-core query adds the band's
// colsum(v^2) into each chunk's quad, panel by panel.
//
// The structure is Kernel D's (query.cu): one block owns a (64-row tile of
// W, 64-query tile) pair, loops k over the tile's live columns only
// (k < (i + 1) * 64), keeps v = W kq^T in registers and writes
// partial[i, q] = colsum(v^2); a second pass sums the partials in a fixed
// order (no atomics).  What differs: each 16-column k slice of kq is
// generated into shared memory from coordinates instead of being loaded.
// Thread t generates query t % 64 (its coordinates held in registers for the
// whole block) at columns t / 64 + 4 j, so a warp reads one column's
// metadata (a broadcast) and writes 32 consecutive shared-memory words.
// A block of W row tile i sees only columns k < (i + 1) * 64, so the mean
// needs every column in a pass of its own: a warp per query regenerates its
// kq row (the TPU kernel took it from its i == 0 grid plane).
//
// What bounds it on the H100: arithmetic, as for D (~c^2 / 2 * m FMAs),
// plus the generation: every live (W tile, query tile) pair regenerates its
// kq slice, c / 64 / 2 times per kq element on average (one exp for the
// value model, two for the joint one).  No TF32 and no tensor cores: plain
// FP32 (FP64) FMA, see common.cuh.
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

template <typename T, class Gen>
__global__ void __launch_bounds__(NTHREADS)
fused_partial_kernel(const T* __restrict__ q, int64_t m, const T* __restrict__ cols, int64_t c,
                     const T* __restrict__ w, int64_t ldw, int64_t nrows, int64_t row_base,
                     int kid, T ls, T sv, T* __restrict__ partial) {
  __shared__ TileSmem<T> sm;
  __shared__ T red[16][TILE];
  const int64_t q_tiles = (m + TILE - 1) / TILE;
  const int64_t it = blockIdx.x / q_tiles;
  const int64_t row0 = it * TILE;                                // W row in the band
  const int64_t q0 = (int64_t)(blockIdx.x % q_tiles) * TILE;    // query
  const int rows = (int)min64(TILE, nrows - row0);
  const int qs = (int)min64(TILE, m - q0);
  const int qi = threadIdx.x % TILE;  // this thread's generated query
  T qv[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) qv[d] = qi < qs ? q[(q0 + qi) * 3 + d] : T(0);
  T acc[4][4] = {};
  // W lower-triangular: the tile's last global row bounds its live columns.
  const int64_t k_end = min64(row_base + row0 + rows, c);
  for (int64_t k0 = 0; k0 < k_end; k0 += BK) {
    load_rows_kmajor(sm.a, w + row0 * ldw, ldw, rows, k0, k_end);
#pragma unroll
    for (int kk = threadIdx.x / TILE; kk < BK; kk += NTHREADS / TILE) {
      const int64_t k = k0 + kk;
      sm.b[kk][qi] = (qi < qs && k < k_end)
                         ? Gen::eval(kid, qv, cols + k * Gen::STRIDE, ls, sv) : T(0);
    }
    __syncthreads();
    tile_fma(sm, acc);
    __syncthreads();
  }
  // Rows past `rows` and queries past `qs` were zero-filled: acc is 0 there.
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    T s = T(0);
#pragma unroll
    for (int i = 0; i < 4; ++i) s += acc[i][j] * acc[i][j];
    red[ty][tx + 16 * j] = s;
  }
  __syncthreads();
  if (threadIdx.x < TILE && threadIdx.x < qs) {
    T s = T(0);
#pragma unroll
    for (int r = 0; r < 16; ++r) s += red[r][threadIdx.x];
    partial[it * m + q0 + threadIdx.x] = s;
  }
}

template <typename T>
__global__ void fused_reduce_kernel(const T* __restrict__ partial, int64_t m, int64_t tiles,
                                    T* __restrict__ quad) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= m) return;
  T s = T(0);
  for (int64_t i = 0; i < tiles; ++i) s += partial[i * m + q];
  quad[q] = s;
}

template <typename T, class Gen>
__global__ void fused_mean_kernel(const T* __restrict__ q, int64_t m, const T* __restrict__ cols,
                                  int64_t c, const T* __restrict__ alpha, int kid, T ls, T sv,
                                  T* __restrict__ mean) {
  const int64_t qi = (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (qi >= m) return;
  const T qv[3] = {q[qi * 3], q[qi * 3 + 1], q[qi * 3 + 2]};
  T s = T(0);
  for (int64_t k = lane; k < c; k += 32)
    s += Gen::eval(kid, qv, cols + k * Gen::STRIDE, ls, sv) * alpha[k];
#pragma unroll
  for (int off = 16; off > 0; off /= 2) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) mean[qi] = s;
}

template <typename T, class Gen>
static int launch_fused(const T* q, int64_t m, const T* cols, int64_t c, const T* w,
                        const T* alpha, int kid, T ls, T sv, T* partial, T* mean, T* quad,
                        cudaStream_t s) {
  fused_partial_kernel<T, Gen><<<ceil_div(c, TILE) * ceil_div(m, TILE), NTHREADS, 0, s>>>(
      q, m, cols, c, w, c, c, 0, kid, ls, sv, partial);
  fused_reduce_kernel<T><<<ceil_div(m, 256), 256, 0, s>>>(partial, m, (c + TILE - 1) / TILE,
                                                          quad);
  fused_mean_kernel<T, Gen><<<ceil_div(m, NTHREADS / 32), NTHREADS, 0, s>>>(
      q, m, cols, c, alpha, kid, ls, sv, mean);
  return (int)cudaGetLastError();
}

template <typename T, class Gen>
static int launch_band(const T* q, int64_t m, const T* cols, int64_t c, const T* w, int64_t ldw,
                       int64_t rows, int64_t row0, int kid, T ls, T sv, T* partial, T* quad,
                       cudaStream_t s) {
  fused_partial_kernel<T, Gen><<<ceil_div(rows, TILE) * ceil_div(m, TILE), NTHREADS, 0, s>>>(
      q, m, cols, c, w, ldw, rows, row0, kid, ls, sv, partial);
  fused_reduce_kernel<T><<<ceil_div(m, 256), 256, 0, s>>>(partial, m, (rows + TILE - 1) / TILE,
                                                          quad);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_quad_band(const T* q, int64_t m, const T* cols, int64_t c, int joint,
                            const T* w, int64_t ldw, int64_t rows, int64_t row0, int kid,
                            double ls, double sv, T* partial, T* quad, void* stream) {
  if (m == 0 || rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (joint)
    return launch_band<T, JointGen>(q, m, cols, c, w, ldw, rows, row0, kid, (T)ls, (T)sv,
                                    partial, quad, s);
  return launch_band<T, ValueGen>(q, m, cols, c, w, ldw, rows, row0, kid, (T)ls, (T)sv, partial,
                                  quad, s);
}

template <typename T>
static int launch_fused_quad(const T* q, int64_t m, const T* cols, int64_t c, int joint,
                             const T* w, const T* alpha, int kid, double ls, double sv,
                             T* partial, T* mean, T* quad, void* stream) {
  if (m == 0 || c == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (joint)
    return launch_fused<T, JointGen>(q, m, cols, c, w, alpha, kid, (T)ls, (T)sv, partial, mean,
                                     quad, s);
  return launch_fused<T, ValueGen>(q, m, cols, c, w, alpha, kid, (T)ls, (T)sv, partial, mean,
                                   quad, s);
}

}  // namespace gpis

extern "C" {

int gpis_fused_quad_f32(const float* q, int64_t m, const float* cols, int64_t c, int joint,
                        const float* w, const float* alpha, int kid, double ls, double sv,
                        float* partial, float* mean, float* quad, void* stream) {
  return gpis::launch_fused_quad<float>(q, m, cols, c, joint, w, alpha, kid, ls, sv, partial,
                                        mean, quad, stream);
}

int gpis_fused_quad_f64(const double* q, int64_t m, const double* cols, int64_t c, int joint,
                        const double* w, const double* alpha, int kid, double ls, double sv,
                        double* partial, double* mean, double* quad, void* stream) {
  return gpis::launch_fused_quad<double>(q, m, cols, c, joint, w, alpha, kid, ls, sv, partial,
                                         mean, quad, stream);
}

int gpis_quad_band_f32(const float* q, int64_t m, const float* cols, int64_t c, int joint,
                       const float* w, int64_t ldw, int64_t rows, int64_t row0, int kid,
                       double ls, double sv, float* partial, float* quad, void* stream) {
  return gpis::launch_quad_band<float>(q, m, cols, c, joint, w, ldw, rows, row0, kid, ls, sv,
                                       partial, quad, stream);
}

int gpis_quad_band_f64(const double* q, int64_t m, const double* cols, int64_t c, int joint,
                       const double* w, int64_t ldw, int64_t rows, int64_t row0, int kid,
                       double ls, double sv, double* partial, double* quad, void* stream) {
  return gpis::launch_quad_band<double>(q, m, cols, c, joint, w, ldw, rows, row0, kid, ls, sv,
                                        partial, quad, stream);
}

}  // extern "C"
