// Kernels B and C: the two products of the left-looking blocked Cholesky and
// of the left-looking blocked TRSM W = L^{-1}; Kernels G, H and I, the
// products and the stripe write of the out-of-core (panel-streamed) factor
// and TRSM (gpis_tpu_torch/linalg/outofcore.py); Kernels J and K, the panel
// and row solves of the factor and TRSM's `panel_solve="inv"` option; and
// Kernel L, the trailing update of the row-sharded right-looking TRSM
// (gpis_tpu_torch/linalg/sharded.py).
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
// G, masked NT product, replaces `gemm_nt_masked_pallas` (pallas_chol.py,
// pallas_call at :307, body `_gemm_nt_kernel` :249):
//     out[r, s] = S[r, s] - sum_{k < k0} A[r, k] * B[s, k]
// with k0 a runtime value.  Every operand is a row-major view with its own
// leading dimension, so the out-of-core k-step hands over its (R, C) row
// band and a (R, P) stripe of it without copying either; out may be S.
//
// H, masked NN accumulate, replaces `gemm_nn_acc_masked_pallas` (pallas_call
// at :380, body `_gemm_nn_masked_kernel` :315):
//     U[r, c] += sum_{k < K} A[r, k] * B[k, c]      for columns c < w
// in place, A a strided (R, K) view.  Only output tiles at columns < w are
// launched: the rest are neither loaded nor written.  U and B may be rows
// of one buffer (the TRSM finish reads rows < r0 and writes rows >= r0 of
// it) as long as the rows of B that the k loop reads are not rows of U.
//
// I, stripe write, replaces `stripe_write_pallas` (pallas_call at :429, body
// `_stripe_kernel` :389):  dst[:, c0 : c0 + W] = blk, in place.  On the TPU
// it existed because XLA did not alias dynamic_update_slice; here it is a
// copy bound by bytes (2 R W elements moved, nothing computed), so what
// matters is keeping enough loads in flight for HBM: 16-byte vectors, four
// a thread loaded before any is stored, 256 threads a CTA, four CTAs
// resident a multiprocessor (64 KB in flight an SM, where Little's law at
// 3.35 TB/s and ~1 us asks for ~25 KB).  A grid of 8 CTAs a multiprocessor
// walks (rows, column chunk) work items (scripts/torch_stripe_variants.py
// measured 2, 4 and 8, and 8 loads a thread); a narrow stripe packs several
// rows into one item.  Vectors need dst + c0 and blk at the same offset mod
// 16 bytes and both row pitches a multiple of 16 bytes (every out-of-core
// call: c0 a multiple of the panel, the pitches C and P); each row's scalar
// head (up to the first 16-byte boundary) and tail, or the whole row where
// vectors are not allowed, are copied by the same grid afterwards, one
// element a thread.
//
// J, panel scale, replaces `panel_scale_pallas` (pallas_call at :461, body
// `_panel_scale_kernel` :446), the Cholesky panel solve of the
// `panel_solve="inv"` option:
//     out[r, c] = sum_{k <= c} acc[r, k] * V[c, k]      (acc V^T, V = Ljj^{-1})
// acc a strided (R, B) view (the panel below the diagonal block, leading
// dimension n), out a separate (R, B) buffer.  V is lower-triangular, so an
// output tile stops its k loop at its last column.
//
// K, row scale, replaces `row_scale_pallas` (pallas_call at :488, body
// `_row_scale_kernel` :475), the TRSM row solve of the same option:
//     out[r, c] = sum_{k <= r} V[r, k] * rhs[k, c]      (V rhs)
// rhs a strided (B, N) view, out a separate (B, N) buffer; an output tile
// stops its k loop at its last row.
//
// The Pallas kernels were one bf16x3 `_dot3` pass each over a constant V
// block.  Here J is the tensor-core tile's NT layout and K its NN layout,
// both with the STORE epilogue (tc_nn.cuh), each 128 x 128 tile over its
// own k range [0, min(tile's last column (J) or row (K) + 1, B)): the
// plan's per-tile upper bound (`_tc_plan` upper), at most B = 256 deep, so
// never split.
//
// L, band trailing update, replaces `band_trail_update_pallas` (pallas_call
// at :241, body `_trail_kernel` :188), the right-looking sharded TRSM step
// (gpis_tpu_torch/linalg/sharded.py `sharded_linv`):
//     S[r, c] -= sum_{k < B} Lcol[r, k] * Wj[k, c]
// in place on a rank's (R, C) band of S at global rows [row0, row0 + R), for
// rows whose global index is >= j0 + B and columns c < j0 + B.  Wj, the
// broadcast W row panel j, is zero at columns >= j0 + B (W is
// lower-triangular), and Lcol is masked to zero above row j0 + B: the
// wrapper trims both ranges (cuda_chol.py `_trail_ranges`, the one place
// that computes them) and hands both entry points the live block, so no
// tile is launched outside it.  The Pallas kernel copied those tiles
// through, which is why it lost to XLA on the TPU
// (gpis_tpu/linalg/sharded.py:317-322).  L is H's product with the sign
// flipped, on that row-trimmed view: the tensor-core tile's NN layout with
// the SUB_FROM epilogue in place (out = S; the tile reads only Lcol and Wj,
// other buffers), at most B = 256 deep, so never split.
//
// B, C, G, H, J, K and L run on the tensor cores (tc_nn.cuh: split-TF32
// wgmma, TMA, a fixed-order split-K reduce; B, G and J as its NT layout, B
// as G in place) and take float32 only: their wrappers refuse a float64
// card tensor (`_build.takes_kernel`).  I, a copy, takes both.
//
// What bounds them on the H100: arithmetic for B, C, G, H and L; bytes for
// I, J and K.
// At n = 16,384 each factor is ~n^3/3 multiply-adds, against 2 n^2 * 4 bytes
// of traffic per step, so the products sit far above the memory roofline at
// the split-TF32 rate (494.7 / 4 TFLOP/s, tc_nn.cuh).
// I moves 2 R W elements and computes nothing.  J and K are one (R, B) x
// (B, B) product each (~1 GFLOP at R = 16,128, B = 256, 33 MB moved): at
// the split-TF32 rate their bytes bound them (~10 us), and launched 63 and
// 64 times a factor behind the factor step's host sync, their launches and
// the host loop around them set much of their share of fit_s (PERF.md
// section 5).
// What the design does about it: each output tile's k range is its live
// one (`_tc_plan`).  B's and G's stop at j0 (k0), so the dead k >= j0 half
// of every product is never loaded or multiplied -- "port the skip, not the
// DMA trick" of the Pallas index maps.  C's also start at the tile's first
// column, since W[k, c] = 0 for k < c, and its finish tiles past j0's tile
// write zeros without reading anything; H plans no tile at columns >= w.
// J's and K's stop at the tile's last column (row) of the triangle; L plans
// tiles only in the live rows and columns.
#include "common.cuh"
#include "tc_nn.cuh"

namespace gpis {

// I's work items: STRIPE_ITEM vectors each, `1 << vpr_log2` of one row's
// vectors (a power of two, >= the row's count up to STRIPE_ITEM) from each of
// STRIPE_ITEM >> vpr_log2 rows.
constexpr int STRIPE_THREADS = 256;
constexpr int STRIPE_UNROLL = 4;  // vector loads a thread issues before its stores
constexpr int STRIPE_ITEM_LOG2 = 10;
constexpr int STRIPE_ITEM = 1 << STRIPE_ITEM_LOG2;
static_assert(STRIPE_ITEM == STRIPE_THREADS * STRIPE_UNROLL, "one vector a thread a load");
constexpr int STRIPE_CTAS_PER_SM = 8;  // 4 resident at once (60 registers a thread)

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

// dst (already at column c0) [:, :w] = blk: each row's `head` scalars, then
// `nvec` 16-byte vectors, then its scalar tail (w - head - nvec * PER).
template <typename T>
__global__ void __launch_bounds__(STRIPE_THREADS)
stripe_write_kernel(T* __restrict__ dst, int64_t ldd, const T* __restrict__ blk, int64_t ldb,
                    int64_t r, int64_t w, int64_t head, int64_t nvec, int vpr_log2) {
  using V = typename Vec16<T>::type;
  constexpr int PER = 16 / sizeof(T);
  const int64_t vpr = int64_t(1) << vpr_log2;
  const int rpi_log2 = STRIPE_ITEM_LOG2 - vpr_log2;
  const int64_t col_items = (nvec + vpr - 1) >> vpr_log2;
  const int64_t items = nvec > 0 ? col_items * ((r + (int64_t(1) << rpi_log2) - 1) >> rpi_log2) : 0;
  for (int64_t it = blockIdx.x; it < items; it += gridDim.x) {
    const int64_t row0 = (it / col_items) << rpi_log2;
    const int64_t vec0 = (it % col_items) << vpr_log2;
    V v[STRIPE_UNROLL];
#pragma unroll
    for (int j = 0; j < STRIPE_UNROLL; ++j) {
      const int e = j * STRIPE_THREADS + threadIdx.x;
      const int64_t row = row0 + (e >> vpr_log2), vec = vec0 + (e & (vpr - 1));
      if (row < r && vec < nvec) v[j] = reinterpret_cast<const V*>(blk + row * ldb + head)[vec];
    }
#pragma unroll
    for (int j = 0; j < STRIPE_UNROLL; ++j) {
      const int e = j * STRIPE_THREADS + threadIdx.x;
      const int64_t row = row0 + (e >> vpr_log2), vec = vec0 + (e & (vpr - 1));
      if (row < r && vec < nvec) reinterpret_cast<V*>(dst + row * ldd + head)[vec] = v[j];
    }
  }
  const int64_t nscal = w - nvec * PER;  // head + tail of a row
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < r * nscal;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = i / nscal, k = i % nscal;
    const int64_t col = k < head ? k : k + nvec * PER;
    dst[row * ldd + col] = blk[row * ldb + col];
  }
}

template <typename T>
static int launch_stripe_write(T* dst, int64_t ldd, const T* blk, int64_t ldb, int64_t r,
                               int64_t w, int64_t c0, void* stream) {
  if (r <= 0 || w <= 0) return 0;
  constexpr int PER = 16 / sizeof(T);
  T* out = dst + c0;
  const uintptr_t off = reinterpret_cast<uintptr_t>(blk) % 16;
  // Vectors where every row of out and blk sits at the same offset mod 16.
  const bool vec = reinterpret_cast<uintptr_t>(out) % 16 == off &&
                   (ldd * (int64_t)sizeof(T)) % 16 == 0 && (ldb * (int64_t)sizeof(T)) % 16 == 0;
  const int64_t to16 = (int64_t)((16 - off) % 16 / sizeof(T));  // scalars to a 16-byte boundary
  const int64_t head = vec && to16 < w ? to16 : w;
  const int64_t nvec = vec ? (w - head) / PER : 0;
  int vpr_log2 = 0;
  while (vpr_log2 < STRIPE_ITEM_LOG2 && (int64_t(1) << vpr_log2) < nvec) ++vpr_log2;
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  const int64_t rows_per_item = int64_t(1) << (STRIPE_ITEM_LOG2 - vpr_log2);
  const int64_t items = nvec > 0 ? ((nvec + (int64_t(1) << vpr_log2) - 1) >> vpr_log2) *
                                       ((r + rows_per_item - 1) / rows_per_item)
                                 : 0;
  const int64_t scalar_ctas = ceil_div(r * (w - nvec * PER), STRIPE_THREADS);
  const int64_t want = items > scalar_ctas ? items : scalar_ctas;
  const int64_t cap = (int64_t)STRIPE_CTAS_PER_SM * (n_sm > 0 ? n_sm : 132);
  const unsigned int grid = (unsigned int)(want < cap ? want : cap);
  stripe_write_kernel<T><<<grid, STRIPE_THREADS, 0, (cudaStream_t)stream>>>(
      out, ldd, blk, ldb, r, w, head, nvec, vpr_log2);
  return (int)cudaGetLastError();
}

}  // namespace gpis

extern "C" {

// B in float32: G in place on the tensor cores, over the plan (`_tc_plan`):
// A = M[j0:, :j0], B = M[j0:j0+bw, :j0], S = out = M[j0:, j0:j0+bw].
int gpis_panel_update_f32(float* mat, int64_t n, int64_t j0, int64_t bw, const void* units,
                          int64_t n_units, const void* tiles, int64_t n_tiles, float* ws,
                          void* stream) {
  if (j0 <= 0 || bw <= 0 || j0 >= n) return 0;
  float* rows = mat + j0 * n;
  return gpis::tc::launch<gpis::tc::NT, gpis::tc::SUB_FROM>(
      rows, n, rows, n, j0, bw, rows + j0, n, rows + j0, n, n - j0, bw,
      static_cast<const gpis::tc::Unit*>(units), n_units,
      static_cast<const gpis::tc::FinishTile*>(tiles), n_tiles, ws, (cudaStream_t)stream);
}

// C in float32: out (bw x n) = lrow[:, :j0] W[:j0, :j0] on the tensor cores,
// over W's live triangle as planned by `_nn_plan` (units, finish tiles and
// the partials' workspace); B's columns >= j0 read as zeros, so the tile
// holding j0 writes zeros past it and the finish tiles beyond write zeros.
int gpis_row_update_f32(const float* lrow, const float* w, int64_t n, int64_t j0, int64_t bw,
                        float* out, const void* units, int64_t n_units, const void* tiles,
                        int64_t n_tiles, float* ws, void* stream) {
  if (n <= 0 || bw <= 0) return 0;
  return gpis::tc::launch<gpis::tc::NN, gpis::tc::STORE>(
      lrow, n, w, n, j0, j0, nullptr, 0, out, n, bw, n, static_cast<const gpis::tc::Unit*>(units),
      n_units, static_cast<const gpis::tc::FinishTile*>(tiles), n_tiles, ws, (cudaStream_t)stream);
}

// H in float32: u[:, :w] += a b[:, :w] on the tensor cores over the plan.
int gpis_gemm_nn_acc_masked_f32(const float* a, int64_t lda, int64_t r, const float* b,
                                int64_t ldb, int64_t kd, float* u, int64_t ldu, int64_t w,
                                const void* units, int64_t n_units, const void* tiles,
                                int64_t n_tiles, float* ws, void* stream) {
  if (r <= 0 || w <= 0 || kd <= 0) return 0;
  return gpis::tc::launch<gpis::tc::NN, gpis::tc::ADD>(
      a, lda, b, ldb, kd, w, nullptr, 0, u, ldu, r, w, static_cast<const gpis::tc::Unit*>(units),
      n_units, static_cast<const gpis::tc::FinishTile*>(tiles), n_tiles, ws, (cudaStream_t)stream);
}

// G in float32: out = s - a[:, :k0] b[:, :k0]^T on the tensor cores over the
// plan; at k0 = 0 the plan has no unit and its finish tiles copy s.
int gpis_gemm_nt_masked_f32(const float* a, int64_t lda, int64_t r, const float* b, int64_t ldb,
                            int64_t p, const float* s, int64_t lds, float* out, int64_t ldo,
                            int64_t k0, const void* units, int64_t n_units, const void* tiles,
                            int64_t n_tiles, float* ws, void* stream) {
  if (r <= 0 || p <= 0) return 0;
  return gpis::tc::launch<gpis::tc::NT, gpis::tc::SUB_FROM>(
      a, lda, b, ldb, k0, p, s, lds, out, ldo, r, p, static_cast<const gpis::tc::Unit*>(units),
      n_units, static_cast<const gpis::tc::FinishTile*>(tiles), n_tiles, ws,
      (cudaStream_t)stream);
}

#define GPIS_STRIPE_ENTRY_POINTS(T, SUF)                                                        \
  int gpis_stripe_write_##SUF(T* dst, int64_t ldd, const T* blk, int64_t ldb, int64_t r,       \
                              int64_t w, int64_t c0, void* stream) {                           \
    return gpis::launch_stripe_write<T>(dst, ldd, blk, ldb, r, w, c0, stream);                 \
  }

GPIS_STRIPE_ENTRY_POINTS(float, f32)
GPIS_STRIPE_ENTRY_POINTS(double, f64)

// J in float32: out (r x b) = acc V^T on the tensor cores, NT layout (V is
// B's operand, k-contiguous like acc), over the plan (`_tc_plan` upper
// "cols": each 128-column tile stops at k = its last column + 1, V being
// lower-triangular).  STORE reads nothing of out, which is a fresh buffer.
int gpis_panel_scale_f32(const float* acc, int64_t lda, int64_t r, const float* v, int64_t ldv,
                         int64_t b, float* out, int64_t ldo, const void* units, int64_t n_units,
                         const void* tiles, int64_t n_tiles, float* ws, void* stream) {
  if (r <= 0 || b <= 0) return 0;
  return gpis::tc::launch<gpis::tc::NT, gpis::tc::STORE>(
      acc, lda, v, ldv, b, b, nullptr, 0, out, ldo, r, b, static_cast<const gpis::tc::Unit*>(units),
      n_units, static_cast<const gpis::tc::FinishTile*>(tiles), n_tiles, ws, (cudaStream_t)stream);
}

// K in float32: out (b x n) = V rhs on the tensor cores, NN layout, over the
// plan (`_tc_plan` upper "rows": each 128-row tile stops at k = its last
// row + 1).  STORE, as C.
int gpis_row_scale_f32(const float* v, int64_t ldv, int64_t b, const float* rhs, int64_t ldr,
                       int64_t n, float* out, int64_t ldo, const void* units, int64_t n_units,
                       const void* tiles, int64_t n_tiles, float* ws, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  return gpis::tc::launch<gpis::tc::NN, gpis::tc::STORE>(
      v, ldv, rhs, ldr, b, n, nullptr, 0, out, ldo, b, n, static_cast<const gpis::tc::Unit*>(units),
      n_units, static_cast<const gpis::tc::FinishTile*>(tiles), n_tiles, ws, (cudaStream_t)stream);
}

// L in float32: S -= Lcol Wj on the live block, on the tensor cores: the NN
// layout with SUB_FROM in place (S = out), over the plan (`_tc_plan` of the
// live rows x w columns, k < bw; at bw <= 256 one unit a tile).  s and lcol
// point at the block's first row (`_trail_ranges` in the wrapper); the tile
// reads only lcol and wj, other buffers than s.
int gpis_band_trail_f32(float* s, int64_t lds, const float* lcol, int64_t ldl, const float* wj,
                        int64_t ldw, int64_t rows, int64_t w, int64_t bw, const void* units,
                        int64_t n_units, const void* tiles, int64_t n_tiles, float* ws,
                        void* stream) {
  if (rows <= 0 || w <= 0 || bw <= 0) return 0;
  return gpis::tc::launch<gpis::tc::NN, gpis::tc::SUB_FROM>(
      lcol, ldl, wj, ldw, bw, w, s, lds, s, lds, rows, w,
      static_cast<const gpis::tc::Unit*>(units), n_units,
      static_cast<const gpis::tc::FinishTile*>(tiles), n_tiles, ws, (cudaStream_t)stream);
}

}  // extern "C"
