// The float32 products of Kernels B, C, D, F, G, H, J, K and L on the tensor
// cores (sm_90a):
//
//     NN: out[m, n] (=, or +=) sum_{k in [kb, ke)} A[m, k] * B[k, n],
//         or (SUB_FROM) S[m, n] minus the sum
//     NT: out[m, n] = S[m, n] - sum_{k in [kb, ke)} A[m, k] * B[n, k],
//         or (STORE) the sum alone,
//         or (QUAD) partial[m0 / 128, n] = sum over the tile's 128 rows m of
//         the sum squared
//
// with A row-major and k-contiguous; in NN B is row-major and n-contiguous,
// in NT row-major and k-contiguous like A.  C (row_update) is the in-core
// TRSM's row update, out = L_row[:, :j0] W[:j0] over W's live triangle; H
// (gemm_nn_acc_masked) the out-of-core TRSM's U[:, :w] += A B.  G
// (gemm_nt_masked) is the out-of-core factor's S - A[:, :k0] B[:, :k0]^T,
// and B (panel_update) the in-core factor's panel update, G in place on the
// one n x n matrix.  J (panel_scale) and K (row_scale) are the inv option's
// panel and row solves, one product each with V = Ljj^{-1} (B x B,
// lower-triangular): J = acc V^T, NT with STORE, each 128-column tile over
// k up to its last column; K = V rhs, NN with STORE, each 128-row tile over
// k up to its last row (the plan's per-tile k range).  L (band_trail) is the
// sharded TRSM's S -= Lcol Wj on a rank's live block, NN with SUB_FROM in
// place, B = 256 deep.  D (staged_quad) and F (fused_quad, quad_band) are
// the variance quad colsum((W kq^T)^2), NT with QUAD: A = W (or a row band
// of it at global row row0), B = kq, each 128-row tile of W over k up to
// its last global row (W is lower-triangular); D reads kq through TMA, F
// generates each kq chunk from coordinates straight into B's split tiles (a
// generator `GEN`, quad.cuh).  All nine take float32 only; their wrappers
// refuse a float64 card tensor (`_build.takes_kernel`).
//
// Precision: FP32-grade products from TF32 wgmma ("split TF32").
//   * Each operand is split as x = hi + lo, hi = rna_tf32(x),
//     lo = rna_tf32(x - hi): x - hi - lo is a rounding of ~2^-22 |x|.
//   * All four products lo*lo, lo*hi, hi*lo, hi*hi are summed, small first,
//     into a FRESH register tile for each 8-deep k step.
//   * The tensor core's FP32 accumulator truncates (rounds toward zero), so
//     each step's result T sits up to one ulp below the exact sum: summed
//     over K / 8 steps that bias reaches ~1e-7 of the result on nonnegative
//     operands.  The step's T is therefore rounded to the nearest 23-bit
//     value, ties away from zero ((bits + 1) & ~1 on its bit pattern), whose
//     error is symmetric about the exact sum when the truncated fraction is
//     uniform, and only then added to the running FP32 sum (round to
//     nearest).
//   * NT (B and G) sums the rounded steps of each 2,048-deep k segment in
//     registers and then subtracts the segment's sum from its output (or
//     adds it to its partial slot) in FP32.  The Cholesky's diagonal blocks
//     are sums of squares up to k = C deep, where one running FP32 sum of
//     K / 8 same-sign steps drifts by ~sqrt(K / 8) of its ulps: 2.9e-6 of
//     sum|a||b| at k 24,576, past the 2e-6 gate, where 2,048-deep segments
//     keep to ~0.2e-6 (sqrt(256) ulps a segment, sqrt(12) segments).  A
//     segment's flush reads and writes the 128 x 128 tile once, its loads
//     issued in groups.  NN (C, H, K and L) keeps its single running sum,
//     bit for bit; L's S - sum is then rounded once in FP32, as `addmm_`.
//   * QUAD (D and F) keeps one running sum over the tile's whole k range too:
//     a segment flushed mid-k would be squared apart from the rest.  Its
//     gates are per query (1e-4 of the quad) and a 2e-8 mean bias, which one
//     running sum holds at C = 16,384 deep (tests/test_torch_tc_nn.py).
//     After the k loop each thread squares its 64 sums and adds its two rows
//     a column, xor shuffles over 4, 8 and 16 lanes add a warp's 16 rows,
//     and the eight warps' sums meet in shared memory (the raw ring, free
//     after the loop), added in warp order: no atomics, the same bits every
//     run.  QUAD units own their tile's whole k range (the plan never splits
//     them) and write `partial[m0 / 128, n0 + j]`; a second kernel sums a
//     query's partials over the row tiles in order.
//
// What bounds it: four TF32 passes, 494.7 TFLOP/s / 4 = 124 TFLOP/s of
// useful work on an H100 at 700 W; the operands are read once per 128 x 128
// output tile per k chunk (~34 flops a byte), far above the memory roofline.
// Short of that, each 8-deep step costs the CUDA cores as much as the tensor
// cores: a warp's 64 step values take 64 x (+1, & ~1, FADD) to round and
// add, and a 32-deep chunk's split 2 x 4,096 values x (two cvt.rna, each
// four instructions, and a subtraction).  Measured inside D (clock64 a
// region, M 8,192 x C 16,384, an H100 at 700 W): a chunk ~4,200 cycles
// against the four passes' 2,048, a warp's rounding of its step ~350-400,
// about twice the issue time of its 128 integer instructions; with the
// rounding and the split both cut out (wrong results, for the measurement)
// the same schedule ran the call in 21.8 ms against its 37.3.
//
// Layout and pipeline of the lockstep body (B, C, G, H, J, K and L), one
// 128 x 128 output tile over one k range [kb, ke) a CTA, 256 threads = two
// warpgroups of 64 x 128 (the QUAD kernels' differs; below):
//   * TMA loads raw 32-deep k chunks, A as a 128 x 32 box and B as four
//     32 x 32 boxes, 128-byte swizzled, into a two-stage ring signalled by
//     mbarriers; thread 0 issues them (a producer warp would cap the
//     consumers' registers).  The tensor maps' k extent is the live k range's
//     end, so TMA zero-fills the ragged k, row and column edges.
//   * TF32 wgmma reads shared-memory operands only k-major.  A is k-major
//     already, and so is B in NT: its chunk loads as one 128 x 32 box, as
//     A's, and splits as A's.  In NN B is n-major, so the pass that splits a
//     raw chunk into hi and lo writes B's halves transposed: the transpose
//     costs nothing beyond the split.  Split tiles use the no-swizzle
//     core-matrix layout (8 rows x 16 bytes), 8-row groups 1,040 bytes apart
//     so that the transposing stores of a quarter warp fall on distinct banks.
//   * The split of chunk c + 1 runs while chunk c's first step is on the
//     tensor cores; two split buffers alternate.
//   * D and F (QUAD) run the warp-specialised body, `tc_quad_ws`, on 384
//     threads: two consumer warpgroups (threads 0-255, the lockstep body's
//     rows and step order) and a third, the producer, that issues the TMA
//     loads and splits every chunk, so no consumer splits.  Its split tiles
//     keep TMA's 128-byte-swizzled layout (each 16 bytes of a raw box to the
//     same 16 bytes of its hi and lo tiles, 1 KB-aligned 16 KB tiles that
//     wgmma reads in its 128B-swizzle mode), split buffer c & 1 signalled
//     full by the producer's 128 threads and empty by the consumers' 8 warps
//     on mbarriers, not __syncthreads.  The consumers ping-pong: they take
//     turns on two named barriers to issue a step, so one warpgroup's four
//     products run while the other waits for and rounds its own; each holds
//     one step tile (acc and step, ~150 registers of the 168 a 384-thread
//     CTA gives, so no setmaxnreg).  Two step tiles in flight a warpgroup
//     (wgmma.wait_group 1) needed 192 accumulator registers, and ptxas
//     serialized its wgmmas (C7514) in every form tried.
//   * A generated B (F): the raw ring carries A's box alone, and the
//     producer generates kq's 128 x 32 chunk beside A's split.  Producer
//     thread p generates query row p (its coordinates in registers for the
//     whole unit) at the chunk's 32 columns, and stores each k group of four
//     columns' hi and lo as one 16-byte vector at the offset TMA would have
//     put it.  The metadata of a chunk's 32 columns sits in shared memory
//     (the raw stage's unused B half), field-major, so that a k group's four
//     columns of one field are one broadcast 16-byte load; the producer
//     loads it from memory two chunks ahead.  kq is computed in FP32 by the
//     generator and split as a loaded operand is.  Columns past the
//     generator's extent and queries past n generate 0; columns past a
//     tile's live end meet W's zeros past its diagonal, as TMA's reads there
//     do.  The producer issues on the same schedulers as the consumers'
//     rounding, which already fill them, so its generator is kept lean: the
//     covariance is a template argument of the producer (one instantiation
//     a covariance, picked a launch), which folds the generator's dispatch
//     away, and a chunk whose columns and query are all live skips the
//     mask, and the metadata is read with `ld.shared.v4` a group ahead.
//     With the dispatch, the mask and generic loads inside each value F ran
//     no faster in this body than in the lockstep one (M 8,192, C 16,384,
//     an H100 at 700 W: 57.3 against 56.8 ms; 44.0 ms without).
//   * B, C, G, H, J, K and L keep the lockstep body: together they take
//     about a twentieth of D's device time in a surface, and C's and H's
//     bits are recorded.
//   * A CTA writes its tile directly when it owns the tile's whole k range,
//     else to an f32 partial in a workspace; `tc_nn_finish_kernel` sums a
//     tile's partials in a fixed order (no atomics: the same bits every run)
//     and applies the epilogue.  The plan (units and finish tiles) is made in
//     Python (gpis_tpu_torch/linalg/cuda_chol.py `_tc_plan`).
//
// Aliasing.  The units only read A and B (through TMA, never past the live
// k range's end, which the tensor maps' extent holds them to) and write
// their own output tile or workspace slot; S is read, and out written, by
// the same thread of the same epilogue, and the finish kernel runs after
// the units on the same stream.  So out may be S, and out may lie in the
// buffer A and B are views of, as long as out's columns are not among the
// columns < ke that A and B are read at:
//   * B (panel_update) is in place: A = M[j0:, :j0], B = M[j0:j0+bw, :j0],
//     S = out = M[j0:, j0:j0+bw]: reads at columns < j0, writes at [j0, j0+bw).
//   * The out-of-core diagonal block (`_chol_diag`) passes A = B = the band
//     and S its columns >= j0, with k0 = j0; out is a new tensor.
//   * The right-looking TRSM (`_trsm_right_blocked`) passes A = S's own
//     buffer at columns < c0 and S its columns [c0, c0 + block); out is new.
//   * J reads the factor's panel below the diagonal block and writes a new
//     buffer: in place it could not be, since its tile at columns [0, 128)
//     writes what its tile at [128, 256) reads.  K writes a new buffer too.
//   * L (NN, SUB_FROM) is in place on the band's live block, S = out; A is
//     the band's column panel of L and B the broadcast W row panel, other
//     buffers than S, so no unit reads what any unit writes.
//   * D and F (QUAD) write a fresh partial buffer, one row a 128-row tile.
// No unit reads what another unit, or the finish kernel, writes.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace gpis {
namespace tc {

constexpr int BM = 128, BN = 128, BK = 32;  // output tile, k chunk
constexpr int THREADS = 256;                 // two warpgroups
constexpr int STEP_K = 8;                    // k depth of one fresh step tile
constexpr int SEG_CHUNKS = 64;               // NT: k chunks (2,048 deep) a running sum takes
constexpr int GROUP_BYTES = 1040;            // 8 rows x 32 k x 4 B, +16 against bank conflicts
constexpr int SPLIT_BYTES = 16 * GROUP_BYTES;  // 128 rows
constexpr int RAW_A_BYTES = BM * BK * 4;       // 16 KB
constexpr int RAW_B_BYTES = BK * BN * 4;       // 16 KB: NN four 32 x 32 boxes, NT one 128 x 32
constexpr int RAW_BYTES = RAW_A_BYTES + RAW_B_BYTES;
constexpr int SMEM_BYTES = 1024 + 2 * RAW_BYTES + 2 * 4 * SPLIT_BYTES + 64;

// B's layout: NN (k rows, n-contiguous) or NT (n rows, k-contiguous).
enum Layout { NN = 0, NT = 1 };
// Epilogues: C, J and K store, H adds into U's old values, B, G and L
// subtract from S, D and F square and sum over the tile's rows (NT only).
enum Epilogue { STORE = 0, ADD = 1, SUB_FROM = 2, QUAD = 3 };

// B's source: TMA from memory (every kernel but F), or a generator GEN of
// kq from coordinates (F: quad.cuh ValueGen, JointGen) with these arguments.
struct TmaB {};
struct GenArgs {
  const float* q;     // (n, 3) queries: B's rows
  const float* cols;  // (ncols, GEN::STRIDE) column metadata
  int64_t ncols;      // columns >= ncols generate 0
  int kid;            // covariance function (common.cuh KernelId)
  float ls, sv;
};
template <class GEN>
constexpr bool kTmaB = std::is_same<GEN, TmaB>::value;

// One CTA's work: output tile (m0, n0), k range [kb, ke), and the partial
// slot it writes (-1: it owns the tile's whole range and writes the output).
struct Unit {
  int m0, n0, kb, ke, slot;
};
// A tile whose units wrote partials [slot0, slot0 + cnt).  cnt 0 (no live k)
// sums to 0: STORE writes zeros, SUB_FROM copies S.
struct FinishTile {
  int m0, n0, slot0, cnt;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = __uint_as_float(rna_tf32(x));
  lo = __uint_as_float(rna_tf32(x - hi));
}

// Round a truncated step result to the nearest 23-bit value, ties away from
// zero (sign-magnitude: adding 1 to the pattern moves away from zero).
__device__ __forceinline__ float round23(float t) {
  return __int_as_float((__float_as_int(t) + 1) & ~1);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor: no swizzle, k-major core matrices of 8 rows x 16 bytes;
// LBO = 128 bytes between the two k-adjacent core matrices of a k8 step,
// SBO = GROUP_BYTES between 8-row groups.
__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(GROUP_BYTES >> 4) << 32);
}

// d (64 x 128 fp32, 64 registers a thread) (+)= A (64 x 8) B (8 x 128), tf32.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Pins the step tile's registers at this point of the program, so that no
// read of them moves above the wait, nor a write below a wgmma.
__device__ __forceinline__ void fence_operand(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Byte offset of element (row, k) of a split tile: 8-row group, k group of
// four (16 bytes), row within the group.
__device__ __forceinline__ int split_off(int row, int k4) {
  return (row >> 3) * GROUP_BYTES + k4 * 128 + (row & 7) * 16;
}

struct Smem {
  char* raw[2];    // TMA ring: A box (128 x 32), then B's (NN four 32 x 32, NT one 128 x 32)
  char* split[2];  // A hi, A lo, B hi, B lo (k-major, split_off layout)
  uint64_t* full;  // one mbarrier per raw stage
};

// Split a k-contiguous 128 x 32 box (A's; B's in NT) into hi and lo tiles.
// Raw boxes are 128-byte swizzled: 16-byte chunk c of box row r lies at
// chunk c ^ (r & 7).
__device__ __forceinline__ void split_rows(const char* raw, char* hi, char* lo) {
  const int t = threadIdx.x;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int idx = it * THREADS + t;
    const int row = (idx & 7) + 8 * (idx >> 6);
    const int k4 = (idx >> 3) & 7;
    const float4 v =
        *reinterpret_cast<const float4*>(raw + row * 128 + ((k4 ^ (row & 7)) << 4));
    float4 h, l;
    split(v.x, h.x, l.x);
    split(v.y, h.y, l.y);
    split(v.z, h.z, l.z);
    split(v.w, h.w, l.w);
    *reinterpret_cast<float4*>(hi + split_off(row, k4)) = h;
    *reinterpret_cast<float4*>(lo + split_off(row, k4)) = l;
  }
}

// Split NN's B chunk, four 32 x 32 boxes (32 k x 128 n), into hi and lo
// tiles transposed to k-major.
__device__ __forceinline__ void split_cols(const char* raw, char* hi, char* lo) {
  // Thread t owns the 4 x 4 block at n = 4 (t % 32) + j, k = 4 (t / 32) + i.
  const int t = threadIdx.x;
  const int n4 = t & 31, k4 = t >> 5;
  const char* box = raw + (n4 >> 3) * (BK * 128);
  float v[4][4];  // [i: k][j: n]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = 4 * k4 + i;
    const float4 r =
        *reinterpret_cast<const float4*>(box + k * 128 + (((n4 & 7) ^ (k & 7)) << 4));
    v[i][0] = r.x;
    v[i][1] = r.y;
    v[i][2] = r.z;
    v[i][3] = r.w;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float4 h, l;
    split(v[0][j], h.x, l.x);
    split(v[1][j], h.y, l.y);
    split(v[2][j], h.z, l.z);
    split(v[3][j], h.w, l.w);
    const int n = 4 * n4 + j;
    *reinterpret_cast<float4*>(hi + split_off(n, k4)) = h;
    *reinterpret_cast<float4*>(lo + split_off(n, k4)) = l;
  }
}

// Split raw chunk `raw` into A hi, A lo, B hi and B lo tiles at `dst`.
template <int LAYOUT>
__device__ __forceinline__ void split_chunk(const char* raw, char* dst) {
  split_rows(raw, dst, dst + SPLIT_BYTES);
  if constexpr (LAYOUT == NT)
    split_rows(raw + RAW_A_BYTES, dst + 2 * SPLIT_BYTES, dst + 3 * SPLIT_BYTES);
  else
    split_cols(raw + RAW_A_BYTES, dst + 2 * SPLIT_BYTES, dst + 3 * SPLIT_BYTES);
}

template <int LAYOUT, class GEN>
__device__ __forceinline__ void issue_chunk(const Smem& s, int stage, const CUtensorMap* ta,
                                            const CUtensorMap* tb, int m0, int n0, int k) {
  if constexpr (!kTmaB<GEN>) {  // B is generated: A's box alone
    mbar_expect_tx(&s.full[stage], RAW_A_BYTES);
    tma_load_2d(s.raw[stage], ta, &s.full[stage], k, m0);
    return;
  }
  mbar_expect_tx(&s.full[stage], RAW_BYTES);
  tma_load_2d(s.raw[stage], ta, &s.full[stage], k, m0);
  if constexpr (LAYOUT == NT) {
    tma_load_2d(s.raw[stage] + RAW_A_BYTES, tb, &s.full[stage], k, n0);
  } else {
#pragma unroll
    for (int j = 0; j < BN / 32; ++j)
      tma_load_2d(s.raw[stage] + RAW_A_BYTES + j * BK * 128, tb, &s.full[stage], n0 + 32 * j,
                  k);
  }
}

// Output rows and columns of accumulator register i of thread `lane` in warp
// `warp` of its warpgroup (wgmma's m64nN fp32 layout).
__device__ __forceinline__ int acc_row(int warp, int lane, int i) {
  return warp * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int lane, int i) {
  return (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
}

// The epilogue of out (m x n, ldo) at (row, col) and the product's v, in
// two halves: `old_value` reads what v combines with (nothing for STORE,
// out's old value for ADD, S (lds) for SUB_FROM), `combine` makes the value
// to store.  S is read before out is written, so out may be S; and since
// it may, the compiler keeps a thread's loads and stores in program order,
// so `flush` issues a group of loads before the group's stores.
template <int EPI>
__device__ __forceinline__ float old_value(const float* out, int64_t ldo, const float* s,
                                           int64_t lds, int64_t row, int64_t col) {
  if (EPI == STORE) return 0.0f;
  if (EPI == ADD) return out[row * ldo + col];
  return s[row * lds + col];
}

template <int EPI>
__device__ __forceinline__ float combine(float old, float v) {
  if (EPI == STORE) return v;
  if (EPI == ADD) return old + v;
  return old - v;  // SUB_FROM
}

template <int EPI>
__device__ __forceinline__ void epilogue(float* out, int64_t ldo, const float* s, int64_t lds,
                                         int64_t m, int64_t n, int64_t row, int64_t col,
                                         float v) {
  if (row >= m || col >= n) return;
  out[row * ldo + col] = combine<EPI>(old_value<EPI>(out, ldo, s, lds, row, col), v);
}

// Hands a unit's running sum to where it goes: a split tile's partial slot,
// or (owning the tile's whole k range) the output.  The unit's first flush
// stores the slot, or combines with old_value (STORE reads nothing); a later
// one (NT's segments) adds to the slot, or takes out itself as the old value:
// subtracts from it (SUB_FROM) or adds to it (STORE, ADD).
template <int EPI>
__device__ __forceinline__ void flush(const float (&acc)[64], const Unit& u, bool first,
                                      float* ws, const float* s, int64_t lds, float* out,
                                      int64_t ldo, int64_t m, int64_t n, int wg, int warp,
                                      int lane) {
  if (u.slot >= 0) {  // a partial of a split tile: the finish kernel sums it
    float2* p = reinterpret_cast<float2*>(ws + (int64_t)u.slot * BM * BN);
#pragma unroll
    for (int g = 0; g < 64; g += 8) {
      float2 old[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = g + 2 * j;
        const int row = 64 * wg + acc_row(warp, lane, i), col = acc_col(lane, i);
        old[j] = first ? make_float2(0.0f, 0.0f) : p[(row * BN + col) / 2];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = g + 2 * j;
        const int row = 64 * wg + acc_row(warp, lane, i), col = acc_col(lane, i);
        p[(row * BN + col) / 2] =
            first ? make_float2(acc[i], acc[i + 1])
                  : make_float2(old[j].x + acc[i], old[j].y + acc[i + 1]);
      }
    }
    return;
  }
  const float* src = first ? s : out;
  const int64_t ld_src = first ? lds : ldo;
  const bool add = EPI == STORE && !first;  // a later segment of a STORE
#pragma unroll
  for (int g = 0; g < 64; g += 8) {
    float old[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t row = u.m0 + 64 * wg + acc_row(warp, lane, g + j);
      const int64_t col = u.n0 + acc_col(lane, g + j);
      old[j] = row >= m || col >= n ? 0.0f
               : add              ? out[row * ldo + col]
                                  : old_value<EPI>(out, ldo, src, ld_src, row, col);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t row = u.m0 + 64 * wg + acc_row(warp, lane, g + j);
      const int64_t col = u.n0 + acc_col(lane, g + j);
      if (row < m && col < n)
        out[row * ldo + col] = add ? old[j] + acc[g + j] : combine<EPI>(old[j], acc[g + j]);
    }
  }
}

// The QUAD kernels' warp-specialised body (tc_quad_ws): three warpgroups,
// the two that run the products (consumers, the lockstep body's threads
// 0-255 with their rows) and one that loads, generates and splits (the
// producer, threads 256-383).
constexpr int WS_THREADS = 3 * 128;
// Named barriers (0 is __syncthreads): the consumers', the producer's, and
// the consumers' turns to issue (TURN_BAR for WG 0, TURN_BAR + 1 for WG 1).
constexpr int CONSUMER_BAR = 1, PRODUCER_BAR = 2, TURN_BAR = 3;

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// QUAD: the tile's colsum(acc^2) over its 128 rows into partial row m0 / 128
// of out (ldo = n), columns masked at n; rows past the operand's were read
// as zeros and add 0.  A thread's two rows a column, then the warp's 16 rows
// by xor shuffles over the lanes of equal lane & 3 (every lane ends with the
// same bits), then the eight warps' sums in `red` (8 x 128 floats), added in
// warp order, by the two consumer warpgroups.
__device__ __forceinline__ void quad_colsum(const float (&acc)[64], const Unit& u, float* red,
                                            float* out, int64_t ldo, int64_t n, int wg, int warp,
                                            int lane) {
  float sq[32];  // [col group i >> 2][col i & 1]
#pragma unroll
  for (int g = 0; g < 16; ++g) {
#pragma unroll
    for (int b = 0; b < 2; ++b)
      sq[2 * g + b] = acc[4 * g + b] * acc[4 * g + b] + acc[4 * g + 2 + b] * acc[4 * g + 2 + b];
  }
#pragma unroll
  for (int off = 4; off < 32; off *= 2) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], off);
  }
  named_sync(CONSUMER_BAR, 2 * 128);  // red is free: the k loop is done with it
  if (lane < 4) {
    float* r = red + (4 * wg + warp) * BN;
#pragma unroll
    for (int g = 0; g < 16; ++g) {
      r[acc_col(lane, 4 * g)] = sq[2 * g];
      r[acc_col(lane, 4 * g + 1)] = sq[2 * g + 1];
    }
  }
  named_sync(CONSUMER_BAR, 2 * 128);
  const int t = threadIdx.x;
  if (t < BN && u.n0 + t < n) {
    float sum = red[t];
#pragma unroll
    for (int w = 1; w < 8; ++w) sum += red[w * BN + t];
    out[(int64_t)(u.m0 / BM) * ldo + u.n0 + t] = sum;
  }
}

// The lockstep body (B, C, G, H, J, K and L): 256 threads, each chunk split
// by all of them, each step's four products waited for and rounded by the
// warpgroup that issued them (see the note at the top).
template <int LAYOUT, int EPI>
__device__ __forceinline__ void tc_lockstep(const Smem& s, const CUtensorMap* ta,
                                            const CUtensorMap* tb, const Unit& u,
                                            const float* s_in, int64_t lds, float* out,
                                            int64_t ldo, int64_t m, int64_t n, float* ws) {
  static_assert(EPI != QUAD, "QUAD runs the warp-specialised body");
  const int nch = (u.ke - u.kb + BK - 1) / BK;
  const int t = threadIdx.x;
  constexpr bool segmented = LAYOUT == NT;  // NT sums in 2,048-deep segments
  if (t == 0) {
    mbar_init(&s.full[0], 1);
    mbar_init(&s.full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    issue_chunk<LAYOUT, TmaB>(s, 0, ta, tb, u.m0, u.n0, u.kb);
    if (nch > 1) issue_chunk<LAYOUT, TmaB>(s, 1, ta, tb, u.m0, u.n0, u.kb + BK);
  }
  mbar_wait(&s.full[0], 0);
  split_chunk<LAYOUT>(s.raw[0], s.split[0]);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (t == 0 && nch > 2) issue_chunk<LAYOUT, TmaB>(s, 0, ta, tb, u.m0, u.n0, u.kb + 2 * BK);

  const int wg = t >> 7, warp = (t >> 5) & 3, lane = t & 31;
  float acc[64], step[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  for (int c = 0; c < nch; ++c) {
    const char* sp = s.split[c & 1];
    const char* a_hi = sp + wg * 8 * GROUP_BYTES;  // this warpgroup's 64 rows
    const char* a_lo = a_hi + SPLIT_BYTES;
    const char* b_hi = sp + 2 * SPLIT_BYTES;
    const char* b_lo = b_hi + SPLIT_BYTES;
#pragma unroll
    for (int st = 0; st < BK / STEP_K; ++st) {
      // One fresh step tile: the four products of STEP_K / 8 k8 slices,
      // small products first (the accumulator aligns to its largest term).
      fence_operand(step);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < STEP_K / 8; ++kk) {
        const int off = (st * STEP_K / 8 + kk) * 256;  // two k groups of four a k8 slice
        wgmma_tf32(step, desc(a_lo + off), desc(b_lo + off), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < STEP_K / 8; ++kk) {
        const int off = (st * STEP_K / 8 + kk) * 256;
        wgmma_tf32(step, desc(a_lo + off), desc(b_hi + off), 1);
        wgmma_tf32(step, desc(a_hi + off), desc(b_lo + off), 1);
      }
#pragma unroll
      for (int kk = 0; kk < STEP_K / 8; ++kk) {
        const int off = (st * STEP_K / 8 + kk) * 256;
        wgmma_tf32(step, desc(a_hi + off), desc(b_hi + off), 1);
      }
      wgmma_commit();
      if (st == 0 && c + 1 < nch) {  // split the next chunk while this step runs
        mbar_wait(&s.full[(c + 1) & 1], ((c + 1) >> 1) & 1);
        split_chunk<LAYOUT>(s.raw[(c + 1) & 1], s.split[(c + 1) & 1]);
      }
      wgmma_wait();
      fence_operand(step);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += round23(step[i]);
    }
    if (segmented && (c + 1) % SEG_CHUNKS == 0 && c + 1 < nch) {
      flush<EPI>(acc, u, c + 1 == SEG_CHUNKS, ws, s_in, lds, out, ldo, m, n, wg, warp, lane);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    }
    if (c + 1 < nch) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      if (t == 0 && c + 3 < nch)
        issue_chunk<LAYOUT, TmaB>(s, (c + 1) & 1, ta, tb, u.m0, u.n0, u.kb + (c + 3) * BK);
    }
  }

  flush<EPI>(acc, u, !segmented || nch <= SEG_CHUNKS, ws, s_in, lds, out, ldo, m, n, wg, warp,
             lane);
}

// The QUAD body's split tiles keep TMA's own layout: a 128 x 32 float tile,
// row r's 16-byte chunk j at r * 128 + ((j ^ (r & 7)) << 4) (128-byte
// swizzle), so the split maps each 16 bytes of a raw box to the same 16
// bytes of its hi and lo tiles, and wgmma reads them in its 128B-swizzle
// mode: 8-row groups 1,024 bytes apart, an 8-deep k slice 32 bytes into each
// row (the hardware applies the XOR).  Tiles are 1 KB aligned.
constexpr int SW_TILE_BYTES = BM * BK * 4;  // 16 KB
constexpr int SW_SPLIT_BYTES = 4 * SW_TILE_BYTES;  // A hi, A lo, B hi, B lo
static_assert(SW_SPLIT_BYTES <= 4 * SPLIT_BYTES, "the QUAD split buffers fit the common layout's");

__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts128(uint32_t addr, const float4& v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}

// BOXES raw boxes of a chunk (A's, then D's B) into the split buffer at dst,
// by the producer's 128 threads, of which this is thread t: the same split
// as split_rows', 16 bytes at a time, each to the same offset of its hi and
// lo tiles.  A thread's eight loads of a box go out together: the producer
// has one warp on each of the SM's four schedulers, so the loads' latency
// is hidden by the thread's own independent loads, not by other warps.
template <int BOXES>
__device__ __forceinline__ void split_swizzled(uint32_t raw, uint32_t dst, int t) {
  constexpr int PER_BOX = SW_TILE_BYTES / 16 / 128;  // 16-byte vectors a thread a box: 8
#pragma unroll 1
  for (int box = 0; box < BOXES; ++box) {
    float4 v[PER_BOX];
#pragma unroll
    for (int j = 0; j < PER_BOX; ++j)
      v[j] = lds128(raw + box * SW_TILE_BYTES + (j * 128 + t) * 16);
#pragma unroll
    for (int j = 0; j < PER_BOX; ++j) {
      const uint32_t off = (j * 128 + t) * 16;
      float4 h, l;
      split(v[j].x, h.x, l.x);
      split(v[j].y, h.y, l.y);
      split(v[j].z, h.z, l.z);
      split(v[j].w, h.w, l.w);
      sts128(dst + 2 * box * SW_TILE_BYTES + off, h);
      sts128(dst + (2 * box + 1) * SW_TILE_BYTES + off, l);
    }
  }
}

// A generated B's column metadata: a chunk's 32 columns, GEN::STRIDE floats
// each, field-major in the raw stage's B half (TMA leaves it alone when B
// is generated): field f of column j at f * 32 + j.  Producer thread p
// fetches elements p, p + 128, ... of the chunk's block from memory (0 past
// the columns) two chunks ahead, and stores them once the slot is free.
__device__ __forceinline__ float* meta_of(const Smem& s, int stage) {
  return reinterpret_cast<float*>(s.raw[stage] + RAW_A_BYTES);
}
template <class GEN>
struct GenMeta {
  static constexpr int COUNT = BK * GEN::STRIDE;
  static constexpr int PER_THREAD = (COUNT + 127) / 128;
  float v[PER_THREAD];
  __device__ __forceinline__ void fetch(const GenArgs& g, int64_t k0, int p) {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int e = p + 128 * i;
      v[i] = e < COUNT && k0 + e / GEN::STRIDE < g.ncols ? g.cols[k0 * GEN::STRIDE + e] : 0.0f;
    }
  }
  __device__ __forceinline__ void store(float* meta, int p) const {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int e = p + 128 * i;
      if (e < COUNT) meta[(e % GEN::STRIDE) * BK + e / GEN::STRIDE] = v[i];
    }
  }
};
struct NoMeta {};
// GenMeta<TmaB> is only named here, never instantiated.
template <class GEN>
using MetaRegs = std::conditional_t<kTmaB<GEN>, NoMeta, GenMeta<GEN>>;

// The four fields of column j .. j + 3 of a chunk's metadata (at shared
// address meta): a broadcast 16-byte load a field.
template <class GEN>
__device__ __forceinline__ void meta_fields(float4 (&f)[GEN::STRIDE], uint32_t meta, int j) {
#pragma unroll
  for (int i = 0; i < GEN::STRIDE; ++i) f[i] = lds128(meta + (i * BK + j) * 4);
}

// kq's 32-deep chunk for query row p (coordinates qv) from the chunk's
// metadata at shared address meta, split into B's hi tile at b_hi and its
// lo tile after it: each k group of four columns one 16-byte store to each
// tile, at the offset TMA would have given it.  The chunk's first `lim`
// columns are live; the others, past the generator's extent or (lim 0) past
// the queries, generate 0 (MASKED false: all 32 are live).  KID, the
// covariance function, is a template argument so that the generator's
// dispatch on it folds away.  Each group's metadata is loaded while the
// group before it is computed.
template <class GEN, int KID, bool MASKED>
__device__ __forceinline__ void gen_chunk(const GenArgs& g, uint32_t meta, const float (&qv)[3],
                                          int lim, uint32_t b_hi, int p) {
  const uint32_t row = b_hi + p * 128;
  const int sw = p & 7;
  float4 f[GEN::STRIDE], next[GEN::STRIDE];
  meta_fields<GEN>(f, meta, 0);
#pragma unroll
  for (int k4 = 0; k4 < BK / 4; ++k4) {
    if (k4 + 1 < BK / 4) meta_fields<GEN>(next, meta, 4 * k4 + 4);
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float col[GEN::STRIDE];
#pragma unroll
      for (int i = 0; i < GEN::STRIDE; ++i)
        col[i] = e == 0 ? f[i].x : e == 1 ? f[i].y : e == 2 ? f[i].z : f[i].w;
      const float x = GEN::eval(KID, qv, col, g.ls, g.sv);
      v[e] = !MASKED || 4 * k4 + e < lim ? x : 0.0f;
    }
    float4 h, l;
    split(v[0], h.x, l.x);
    split(v[1], h.y, l.y);
    split(v[2], h.z, l.z);
    split(v[3], h.w, l.w);
    const uint32_t off = row + ((k4 ^ sw) << 4);
    sts128(off, h);
    sts128(off + SW_TILE_BYTES, l);
#pragma unroll
    for (int i = 0; i < GEN::STRIDE; ++i) f[i] = next[i];
  }
}

// The producer warpgroup (thread p of 128): chunk c's raw stage c & 1 into
// split buffer c & 1, A's box split and B's box split (D) or B generated
// (F, covariance KID).  Barriers in s.full: raw[2] (TMA bytes),
// split_full[2] (the producer's 128 threads), split_empty[2] (the
// consumers' 8 warps).
template <int LAYOUT, class GEN, int KID>
__device__ __forceinline__ void quad_producer(const Smem& s, const CUtensorMap* ta,
                                              const CUtensorMap* tb, const Unit& u, int64_t n,
                                              const GenArgs& g, int nch, int p) {
  uint64_t* split_full = s.full + 2;
  uint64_t* split_empty = s.full + 4;
  if (p == 0) {
    issue_chunk<LAYOUT, GEN>(s, 0, ta, tb, u.m0, u.n0, u.kb);
    if (nch > 1) issue_chunk<LAYOUT, GEN>(s, 1, ta, tb, u.m0, u.n0, u.kb + BK);
  }
  // A generated B: this thread's query for the unit, and chunk c + 2's
  // metadata in flight.
  [[maybe_unused]] float qv[3] = {0.0f, 0.0f, 0.0f};
  [[maybe_unused]] bool live = false;
  [[maybe_unused]] MetaRegs<GEN> next;
  if constexpr (!kTmaB<GEN>) {
    const int64_t qi = u.n0 + p;
    live = qi < n;
    if (live) {
      qv[0] = g.q[qi * 3];
      qv[1] = g.q[qi * 3 + 1];
      qv[2] = g.q[qi * 3 + 2];
    }
    next.fetch(g, u.kb, p);
    next.store(meta_of(s, 0), p);
    next.fetch(g, u.kb + BK, p);
    next.store(meta_of(s, 1), p);
    named_sync(PRODUCER_BAR, 128);
  }
  const uint32_t raw0 = smem_u32(s.raw[0]), split0 = smem_u32(s.split[0]);
  for (int c = 0; c < nch; ++c) {
    const int b = c & 1;
    if constexpr (!kTmaB<GEN>) {
      if (c + 2 < nch) next.fetch(g, u.kb + (c + 2) * BK, p);
    }
    mbar_wait(&s.full[b], (c >> 1) & 1);
    if (c >= 2) mbar_wait(&split_empty[b], ((c >> 1) - 1) & 1);  // chunk c - 2 is done
    const uint32_t dst = split0 + b * SW_SPLIT_BYTES;
    split_swizzled<(kTmaB<GEN> ? 2 : 1)>(raw0 + b * RAW_BYTES, dst, p);
    if constexpr (!kTmaB<GEN>) {
      const int64_t k0 = u.kb + c * BK;
      const int lim = live ? (int)(g.ncols - k0 < BK ? g.ncols - k0 : BK) : 0;
      const uint32_t meta = smem_u32(meta_of(s, b)), b_hi = dst + 2 * SW_TILE_BYTES;
      if (lim == BK)
        gen_chunk<GEN, KID, false>(g, meta, qv, lim, b_hi, p);
      else
        gen_chunk<GEN, KID, true>(g, meta, qv, lim, b_hi, p);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(&split_full[b]);
    // The raw stage (and a generated B's metadata slot) is read: chunk
    // c + 2 into it.  A generated B meets here one chunk earlier too, so
    // that the metadata stored at chunk c is seen by all at chunk c + 2.
    if (c + (kTmaB<GEN> ? 2 : 1) < nch) {
      named_sync(PRODUCER_BAR, 128);
      if (c + 2 < nch) {
        if (p == 0) issue_chunk<LAYOUT, GEN>(s, b, ta, tb, u.m0, u.n0, u.kb + (c + 2) * BK);
        if constexpr (!kTmaB<GEN>) next.store(meta_of(s, b), p);
      }
    }
  }
}

// One step of the QUAD body's: the four products of its 8-deep k slice st,
// small first, into a fresh tile d, committed as one group.  The lockstep
// body's order, pass for pass.
__device__ __forceinline__ void quad_step(float (&d)[64], const char* a_lo, const char* a_hi,
                                          const char* b_lo, const char* b_hi, int st) {
  const int off = st * STEP_K * 4;
  fence_operand(d);
  wgmma_fence();
  wgmma_tf32(d, desc_sw128(a_lo + off), desc_sw128(b_lo + off), 0);
  wgmma_tf32(d, desc_sw128(a_lo + off), desc_sw128(b_hi + off), 1);
  wgmma_tf32(d, desc_sw128(a_hi + off), desc_sw128(b_lo + off), 1);
  wgmma_tf32(d, desc_sw128(a_hi + off), desc_sw128(b_hi + off), 1);
  wgmma_commit();
}

// D's and F's body: a producer warpgroup loads, generates and splits, two
// consumer warpgroups take turns on the tensor cores (see the note at the
// top).
template <int LAYOUT, class GEN>
__device__ __forceinline__ void tc_quad_ws(const Smem& s, const CUtensorMap* ta,
                                           const CUtensorMap* tb, const Unit& u, float* out,
                                           int64_t ldo, int64_t n, const GenArgs& g) {
  uint64_t* split_full = s.full + 2;
  uint64_t* split_empty = s.full + 4;
  const int nch = (u.ke - u.kb + BK - 1) / BK;
  const int t = threadIdx.x;
  if (t == 0) {
    mbar_init(&s.full[0], 1);
    mbar_init(&s.full[1], 1);
    mbar_init(&split_full[0], 128);
    mbar_init(&split_full[1], 128);
    mbar_init(&split_empty[0], 8);
    mbar_init(&split_empty[1], 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (t >= 2 * 128) {
    const int p = t - 2 * 128;
    if constexpr (kTmaB<GEN>) {
      quad_producer<LAYOUT, GEN, 0>(s, ta, tb, u, n, g, nch, p);
    } else {
      switch (g.kid) {  // the generator's covariance (common.cuh KernelId)
        case RBF:
          quad_producer<LAYOUT, GEN, RBF>(s, ta, tb, u, n, g, nch, p);
          break;
        case LAPLACE:
          quad_producer<LAYOUT, GEN, LAPLACE>(s, ta, tb, u, n, g, nch, p);
          break;
        case INVERSE_MULTIQUADRIC:
          quad_producer<LAYOUT, GEN, INVERSE_MULTIQUADRIC>(s, ta, tb, u, n, g, nch, p);
          break;
        default:
          quad_producer<LAYOUT, GEN, THIN_PLATE>(s, ta, tb, u, n, g, nch, p);
      }
    }
    return;
  }

  // wg through a shuffle: ptxas then knows it, and the descriptors made
  // from it, to be warp-uniform, and builds them on the uniform datapath.
  const int wg = __shfl_sync(0xffffffffu, t >> 7, 0), warp = (t >> 5) & 3, lane = t & 31;
  float acc[64], d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  // Ping-pong: the warpgroups take turns to issue a step (WG 0 at TURN_BAR,
  // WG 1 at TURN_BAR + 1, each opened by the other's arrival after its own
  // issue), so that one's step runs on the tensor cores while the other
  // waits for and rounds its own.  WG 1 opens WG 0's first turn; its last
  // step opens none.
  if (wg == 1) named_arrive(TURN_BAR, 2 * 128);
  for (int c = 0; c < nch; ++c) {
    const int b = c & 1;
    mbar_wait(&split_full[b], (c >> 1) & 1);
    const char* sp = s.split[0] + b * SW_SPLIT_BYTES;
    const char* a_hi = sp + wg * 64 * BK * 4;  // this warpgroup's 64 rows
    const char* a_lo = a_hi + SW_TILE_BYTES;
    const char* b_hi = sp + 2 * SW_TILE_BYTES;
    const char* b_lo = b_hi + SW_TILE_BYTES;
#pragma unroll
    for (int st = 0; st < BK / STEP_K; ++st) {
      named_sync(TURN_BAR + wg, 2 * 128);
      quad_step(d, a_lo, a_hi, b_lo, b_hi, st);
      if (wg == 0 || c + 1 < nch || st + 1 < BK / STEP_K)
        named_arrive(TURN_BAR + 1 - wg, 2 * 128);
      wgmma_wait();
      fence_operand(d);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += round23(d[i]);
    }
    if (lane == 0) mbar_arrive(&split_empty[b]);  // this warp is done with chunk c
  }
  // The producer is past its last read of the raw ring's A boxes: it split
  // every chunk (a generated B's metadata lies past the 4 KB `red` takes).
  quad_colsum(acc, u, reinterpret_cast<float*>(s.raw[0]), out, ldo, n, wg, warp, lane);
}

// The launch shape: D and F (QUAD) warp-specialised, 384 threads; every
// other kernel the lockstep body's 256.
template <int EPI>
struct CtaShape {
  static constexpr bool warp_specialised = EPI == QUAD;
  static constexpr int threads = warp_specialised ? WS_THREADS : THREADS;
};

template <int LAYOUT, int EPI, class GEN = TmaB>
__global__ void __launch_bounds__(CtaShape<EPI>::threads, 1)
tc_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
          const Unit* __restrict__ units, const float* s_in, int64_t lds, float* out,
          int64_t ldo, int64_t m, int64_t n, float* __restrict__ ws, const GenArgs g) {
  static_assert(EPI != QUAD || LAYOUT == NT, "QUAD is NT's epilogue");
  static_assert(kTmaB<GEN> || EPI == QUAD, "a generated B is the QUAD body's");
  extern __shared__ char smem_raw[];
  char* base = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                       ~uintptr_t(1023));  // 128-byte swizzle: 1 KB aligned
  Smem s;
  s.raw[0] = base;
  s.raw[1] = base + RAW_BYTES;
  s.split[0] = base + 2 * RAW_BYTES;
  s.split[1] = s.split[0] + 4 * SPLIT_BYTES;
  s.full = reinterpret_cast<uint64_t*>(s.split[1] + 4 * SPLIT_BYTES);
  const Unit u = units[blockIdx.x];
  if constexpr (CtaShape<EPI>::warp_specialised)
    tc_quad_ws<LAYOUT, GEN>(s, &ta, &tb, u, out, ldo, n, g);
  else
    tc_lockstep<LAYOUT, EPI>(s, &ta, &tb, u, s_in, lds, out, ldo, m, n, ws);
}

// One tile's partials summed in slot order, then the epilogue; blockIdx.y
// picks 8 of its 128 rows.
template <int EPI>
__global__ void __launch_bounds__(THREADS)
tc_finish_kernel(const FinishTile* __restrict__ tiles, const float* __restrict__ ws,
                 const float* s, int64_t lds, float* out, int64_t ldo, int64_t m, int64_t n) {
  const FinishTile f = tiles[blockIdx.x];
  const int e = blockIdx.y * 8 * BN + threadIdx.x * 4;  // 4 elements a thread
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < f.cnt; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(ws + (int64_t)(f.slot0 + i) * BM * BN + e);
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }
  const int64_t row = f.m0 + e / BN, col = f.n0 + e % BN;
  epilogue<EPI>(out, ldo, s, lds, m, n, row, col, sum.x);
  epilogue<EPI>(out, ldo, s, lds, m, n, row, col + 1, sum.y);
  epilogue<EPI>(out, ldo, s, lds, m, n, row, col + 2, sum.z);
  epilogue<EPI>(out, ldo, s, lds, m, n, row, col + 3, sum.w);
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows x cols) row-major float32 view with leading dimension ld, cut into
// box_rows x 32 boxes, 128-byte swizzled; reads past rows or cols give 0.
inline int make_map(CUtensorMap* map, const float* p, int64_t rows, int64_t cols, int64_t ld,
                    int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// out (m x n, ldo) (=, +=) A (m x k_end, lda) B, or (SUB_FROM) S (lds) - A B,
// or (QUAD) the partials colsum((A B^T)^2) (ceil(m / 128) x n, ldo), over the
// planned units, then the finish tiles.  B is (k_end x n_live) in NN,
// (n_live x k_end) in NT, leading dimension ldb; n_live is B's extent along
// n, past which TMA reads zeros.  With a generator GEN, B is not read (b may
// be null): `g` generates it.  With no unit (NT at k_end 0) no tensor map is
// made.  Returns a cudaError_t.
template <int LAYOUT, int EPI, class GEN = TmaB>
int launch(const float* a, int64_t lda, const float* b, int64_t ldb, int64_t k_end,
           int64_t n_live, const float* s, int64_t lds, float* out, int64_t ldo, int64_t m,
           int64_t n, const Unit* units, int64_t n_units, const FinishTile* tiles,
           int64_t n_tiles, float* ws, cudaStream_t stream, const GenArgs& g = GenArgs{}) {
  int err = 0;
  if (n_units > 0) {
    CUtensorMap ta, tb;
    err = make_map(&ta, a, m, k_end, lda, BM);
    if (!err && kTmaB<GEN>)
      err = LAYOUT == NT ? make_map(&tb, b, n_live, k_end, ldb, BM)
                         : make_map(&tb, b, k_end, n_live, ldb, BK);
    if (err) return err;
    if (!kTmaB<GEN>) tb = ta;  // not read
    cudaFuncSetAttribute(tc_kernel<LAYOUT, EPI, GEN>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    tc_kernel<LAYOUT, EPI, GEN>
        <<<(unsigned int)n_units, CtaShape<EPI>::threads, SMEM_BYTES, stream>>>(
            ta, tb, units, s, lds, out, ldo, m, n, ws, g);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  if constexpr (EPI == QUAD) {  // whole units only: a split tile's square is not its parts'
    if (n_tiles > 0) return (int)cudaErrorInvalidValue;
  } else if (n_tiles > 0) {
    tc_finish_kernel<EPI><<<dim3((unsigned int)n_tiles, BM / 8), THREADS, 0, stream>>>(
        tiles, ws, s, lds, out, ldo, m, n);
    err = (int)cudaGetLastError();
  }
  return err;
}

}  // namespace tc
}  // namespace gpis
