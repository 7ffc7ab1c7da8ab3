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
// would exceed the staging cap.  The generators are quad.cuh's.
//
// Band mode: W is a row band, rows [row_base, row_base + R) of the factor's
// W, stored with its own leading dimension (the out-of-core store keeps
// trimmed panels).  Its row tile at band row r0 ends at global row
// row_base + r0 + tile, so its live columns are k < row_base + r0 + tile,
// not r0 + tile: the bound carries the band's offset.  The out-of-core
// query adds the band's colsum(v^2) into each chunk's quad, panel by panel.
//
// The structure is Kernel D's (query.cu): one block owns a (row tile of W,
// query tile) pair, loops k over the tile's live columns only, keeps
// v = W kq^T in registers and writes partial[i, q] = colsum(v^2); a second
// pass sums the partials in a fixed order (no atomics).  What differs: each
// k chunk of kq is generated from coordinates instead of being loaded.
//   * float32: the split-TF32 tensor-core tile (tc_nn.cuh), NT layout with
//     the QUAD epilogue and a generated B, in D's warp-specialised body: W
//     comes through TMA, and the producer warpgroup computes each
//     128-query x 32-column kq chunk straight into B's split hi and lo
//     tiles (thread p: query p, the chunk's 32 columns) while the consumers
//     run earlier chunks on the tensor cores, from column metadata staged in
//     shared memory two chunks ahead.  The plan (`_tc_plan` upper "rows",
//     k_offset = the band's first row, never split) gives each tile its
//     live k range.
//   * float64: the SIMT tile of common.cuh, 64 x 64: each 16-column k slice
//     of kq is generated into shared memory; thread t generates query t % 64
//     (its coordinates held in registers for the whole block) at columns
//     t / 64 + 4 j, so a warp reads one column's metadata (a broadcast) and
//     writes 32 consecutive shared-memory words.
// A block of W row tile i sees only columns below its bound, so the mean
// needs every column in a pass of its own: a warp per query regenerates its
// kq row (the TPU kernel took it from its i == 0 grid plane), SIMT in both.
//
// What bounds it on the H100: arithmetic, as for D (~c^2 / 2 * m FMAs, at
// the split-TF32 rate in float32), plus the generation: every live (W tile,
// query tile) pair regenerates its kq slice, c / 128 / 2 times per kq
// element on average in float32 (one exp for the value model, two for the
// joint one), on the SIMT cores beside the tensor cores' product.
#include "common.cuh"
#include "quad.cuh"
#include "tc_nn.cuh"

namespace gpis {

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

// float64: the SIMT body over 64-row tiles, the partials' sum, the mean.
template <class Gen>
static int launch_fused_f64(const double* q, int64_t m, const double* cols, int64_t c,
                            const double* w, const double* alpha, int kid, double ls, double sv,
                            double* partial, double* mean, double* quad, cudaStream_t s) {
  fused_partial_kernel<double, Gen><<<ceil_div(c, TILE) * ceil_div(m, TILE), NTHREADS, 0, s>>>(
      q, m, cols, c, w, c, c, 0, kid, ls, sv, partial);
  quad_reduce_kernel<double><<<ceil_div(m, 256), 256, 0, s>>>(partial, m, ceil_div(c, TILE),
                                                              quad);
  fused_mean_kernel<double, Gen><<<ceil_div(m, NTHREADS / 32), NTHREADS, 0, s>>>(
      q, m, cols, c, alpha, kid, ls, sv, mean);
  return (int)cudaGetLastError();
}

template <class Gen>
static int launch_band_f64(const double* q, int64_t m, const double* cols, int64_t c,
                           const double* w, int64_t ldw, int64_t rows, int64_t row0, int kid,
                           double ls, double sv, double* partial, double* quad, cudaStream_t s) {
  fused_partial_kernel<double, Gen>
      <<<ceil_div(rows, TILE) * ceil_div(m, TILE), NTHREADS, 0, s>>>(
          q, m, cols, c, w, ldw, rows, row0, kid, ls, sv, partial);
  quad_reduce_kernel<double><<<ceil_div(m, 256), 256, 0, s>>>(partial, m, ceil_div(rows, TILE),
                                                              quad);
  return (int)cudaGetLastError();
}

// float32: the tensor-core tile over the plan, A = W's rows [0, rows) (k
// extent k_end: W's stored width), B generated by Gen from the queries and
// the first k_end columns, the QUAD epilogue into partial (ceil(rows / 128),
// m); then the partials' sum over the row tiles.
template <class Gen>
static int launch_quad_f32(const float* q, int64_t m, const float* cols, const float* w,
                           int64_t ldw, int64_t rows, int64_t k_end, int kid, double ls,
                           double sv, float* partial, float* quad, const void* units,
                           int64_t n_units, const void* tiles, int64_t n_tiles, float* ws,
                           cudaStream_t s) {
  const tc::GenArgs g{q, cols, k_end, kid, (float)ls, (float)sv};
  const int err = tc::launch<tc::NT, tc::QUAD, Gen>(
      w, ldw, nullptr, 0, k_end, m, nullptr, 0, partial, m, rows, m,
      static_cast<const tc::Unit*>(units), n_units, static_cast<const tc::FinishTile*>(tiles),
      n_tiles, ws, s, g);
  if (err) return err;
  quad_reduce_kernel<float><<<ceil_div(m, 256), 256, 0, s>>>(partial, m, ceil_div(rows, tc::BM),
                                                             quad);
  return (int)cudaGetLastError();
}

template <class Gen>
static int launch_fused_f32(const float* q, int64_t m, const float* cols, int64_t c,
                            const float* w, const float* alpha, int kid, double ls, double sv,
                            float* partial, float* mean, float* quad, const void* units,
                            int64_t n_units, const void* tiles, int64_t n_tiles, float* ws,
                            cudaStream_t s) {
  const int err = launch_quad_f32<Gen>(q, m, cols, w, c, c, c, kid, ls, sv, partial, quad, units,
                                       n_units, tiles, n_tiles, ws, s);
  if (err) return err;
  fused_mean_kernel<float, Gen><<<ceil_div(m, NTHREADS / 32), NTHREADS, 0, s>>>(
      q, m, cols, c, alpha, kid, (float)ls, (float)sv, mean);
  return (int)cudaGetLastError();
}

}  // namespace gpis

extern "C" {

// F in float32: the tensor-core tile with a generated B over the plan
// (`_tc_plan(c, m, c, upper="rows", whole=True)`), the reduce, the mean.
int gpis_fused_quad_f32(const float* q, int64_t m, const float* cols, int64_t c, int joint,
                        const float* w, const float* alpha, int kid, double ls, double sv,
                        float* partial, float* mean, float* quad, const void* units,
                        int64_t n_units, const void* tiles, int64_t n_tiles, float* ws,
                        void* stream) {
  if (m == 0 || c == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (joint)
    return gpis::launch_fused_f32<gpis::JointGen>(q, m, cols, c, w, alpha, kid, ls, sv, partial,
                                                  mean, quad, units, n_units, tiles, n_tiles,
                                                  ws, s);
  return gpis::launch_fused_f32<gpis::ValueGen>(q, m, cols, c, w, alpha, kid, ls, sv, partial,
                                                mean, quad, units, n_units, tiles, n_tiles, ws,
                                                s);
}

// F in float64 keeps the SIMT tile; it takes no plan.
int gpis_fused_quad_f64(const double* q, int64_t m, const double* cols, int64_t c, int joint,
                        const double* w, const double* alpha, int kid, double ls, double sv,
                        double* partial, double* mean, double* quad, const void*, int64_t,
                        const void*, int64_t, double*, void* stream) {
  if (m == 0 || c == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (joint)
    return gpis::launch_fused_f64<gpis::JointGen>(q, m, cols, c, w, alpha, kid, ls, sv, partial,
                                                  mean, quad, s);
  return gpis::launch_fused_f64<gpis::ValueGen>(q, m, cols, c, w, alpha, kid, ls, sv, partial,
                                                mean, quad, s);
}

// F's band mode in float32: the band (rows x width, ldw) at global row row0,
// over the plan (`_tc_plan(rows, m, width, upper="rows", k_offset=row0,
// whole=True)`: each tile's live k ends at row0 + its last band row + 1).
int gpis_quad_band_f32(const float* q, int64_t m, const float* cols, int64_t c, int joint,
                       const float* w, int64_t ldw, int64_t rows, int64_t width, int64_t row0,
                       int kid, double ls, double sv, float* partial, float* quad,
                       const void* units, int64_t n_units, const void* tiles, int64_t n_tiles,
                       float* ws, void* stream) {
  (void)c;
  (void)row0;  // the plan carries the band's offset
  if (m == 0 || rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (joint)
    return gpis::launch_quad_f32<gpis::JointGen>(q, m, cols, w, ldw, rows, width, kid, ls, sv,
                                                 partial, quad, units, n_units, tiles, n_tiles,
                                                 ws, s);
  return gpis::launch_quad_f32<gpis::ValueGen>(q, m, cols, w, ldw, rows, width, kid, ls, sv,
                                               partial, quad, units, n_units, tiles, n_tiles,
                                               ws, s);
}

// F's band mode in float64 keeps the SIMT tile; it takes no plan.
int gpis_quad_band_f64(const double* q, int64_t m, const double* cols, int64_t c, int joint,
                       const double* w, int64_t ldw, int64_t rows, int64_t width, int64_t row0,
                       int kid, double ls, double sv, double* partial, double* quad,
                       const void*, int64_t, const void*, int64_t, double*, void* stream) {
  (void)width;
  if (m == 0 || rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (joint)
    return gpis::launch_band_f64<gpis::JointGen>(q, m, cols, c, w, ldw, rows, row0, kid, ls, sv,
                                                 partial, quad, s);
  return gpis::launch_band_f64<gpis::ValueGen>(q, m, cols, c, w, ldw, rows, row0, kid, ls, sv,
                                               partial, quad, s);
}

}  // extern "C"
