// Kernel D: the staged variance quad and mean of the dense-grid query.
//
// Replaces gpis_tpu/kernels/pallas_query.py `staged_query_from_kq`
// (pallas_call at :319, body `_staged_kernel` :250).  Given a staged
// kq = K(Q, X) (m, c), W = L^{-1} (c, c) lower-triangular and alpha (c,):
//     mean[q] = sum_k kq[q, k] alpha[k]
//     quad[q] = sum_i (sum_k W[i, k] kq[q, k])^2      (var = k(0) - quad)
//
// The TPU kernel carries its v = W kq^T accumulator in scratch across a
// sequential grid.  GPU blocks run in no order, so that does not carry
// over.  Instead one block owns a (row tile of W, query tile) pair, loops k
// over the tile's live columns only (k < the tile's last row + 1: the rest
// of W is zero), keeps v in registers, and writes partial[i, q] =
// colsum(v^2) over its rows.  A second pass sums the partials over i in a
// fixed order: no atomics, so a result repeats bit for bit.  The mean is a
// third, warp-per-query pass.
//
// What bounds it on the H100: arithmetic.  A 8,192-query chunk against
// C = 16,384 is ~C^2 / 2 * m multiply-adds (1.1e12) on 1 GiB of W plus
// 512 MiB of kq, far above the memory roofline.  The product is the
// split-TF32 tensor-core tile (tc_nn.cuh), NT layout with the QUAD
// epilogue: 128 x 128 tiles (W rows x queries), W and kq through TMA, each
// tile over k < its last row + 1 (`_tc_plan` upper "rows", never split),
// squared and summed over its rows in registers; partial is
// (ceil(c / 128), m).  Bound: 123.7 TFLOP/s of useful work.  It takes
// float32 only: its wrapper refuses a float64 card query (`_build.takes_kernel`).
// W is re-read once per query tile; the 50 MB L2 absorbs part of that.  The
// mean (a GEMV on kq, bound by its bytes) is a SIMT kernel.
#include "common.cuh"
#include "quad.cuh"
#include "tc_nn.cuh"

namespace gpis {

template <typename T>
__global__ void mean_kernel(const T* __restrict__ kq, int64_t m, const T* __restrict__ alpha,
                            int64_t c, T* __restrict__ mean) {
  const int64_t q = (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (q >= m) return;
  const T* row = kq + q * c;
  T s = T(0);
  for (int64_t k = lane; k < c; k += 32) s += row[k] * alpha[k];
#pragma unroll
  for (int off = 16; off > 0; off /= 2) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) mean[q] = s;
}

// The partials' sum over `tiles` row tiles, then the mean.
template <typename T>
static int finish_staged_quad(const T* kq, int64_t m, const T* alpha, int64_t c, int64_t tiles,
                              const T* partial, T* mean, T* quad, cudaStream_t s) {
  quad_reduce_kernel<T><<<ceil_div(m, 256), 256, 0, s>>>(partial, m, tiles, quad);
  mean_kernel<T><<<ceil_div(m, NTHREADS / 32), NTHREADS, 0, s>>>(kq, m, alpha, c, mean);
  return (int)cudaGetLastError();
}

}  // namespace gpis

extern "C" {

// D in float32: the tensor-core tile over the plan (`_tc_plan(c, m, c,
// upper="rows", whole=True)`: A = W, B = kq), then the reduce and the mean.
int gpis_staged_quad_f32(const float* kq, int64_t m, const float* w, const float* alpha,
                         int64_t c, float* partial, float* mean, float* quad, const void* units,
                         int64_t n_units, const void* tiles, int64_t n_tiles, float* ws,
                         void* stream) {
  if (m == 0 || c == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int err = gpis::tc::launch<gpis::tc::NT, gpis::tc::QUAD>(
      w, c, kq, c, c, m, nullptr, 0, partial, m, c, m,
      static_cast<const gpis::tc::Unit*>(units), n_units,
      static_cast<const gpis::tc::FinishTile*>(tiles), n_tiles, ws, s);
  if (err) return err;
  return gpis::finish_staged_quad<float>(kq, m, alpha, c, gpis::ceil_div(c, gpis::tc::BM),
                                         partial, mean, quad, s);
}

}  // extern "C"
