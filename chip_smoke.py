#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`gpis_tpu_torch`), one GPU.

    python3 chip_smoke.py

Phases, one printed line or more each; any failure exits nonzero:

0. The card: torch.cuda must be available; its name and power limit.
1. Build every kernel from gpis_tpu_torch/csrc/ (one nvcc per source, all
   started together; sm_90a).
2. Each kernel against its plain PyTorch twin on the card, at the slices'
   shapes (C = 4,096 and 16,384, 8,192-query chunks; the joint J = 21,504),
   with the tolerance stated beside the error, and the kernel's and the
   twin's time (CUDA events).  The quads of Kernels D and F (in float32
   the split-TF32 tensor-core tile with the QUAD epilogue, F's kq
   generated in the tile) are held per query against the twin run in
   float64, at ragged shapes, twice bit for bit, in float64 too, and to the
   bias gate on nonnegative W and kq (`quad_kernel_checks`).  Plus the
   variance-quad regime the JAX package's `_QSPLIT` note measured
   (C = 1,024, noise 1e-3), D and F held against a float64 plain run, D
   timed at M = 128 beside M = 8,192, and the staged route (A or E, then
   D) timed against the on-the-fly one (F) at one shape: the card's
   crossover.
3. The value slice through the user entry point: ObjectModelSession.start
   on a 16,256-point sphere (capacity 16,384), a few queries, the 64^3
   grid, extract_surface and a 65,536-point query (the on-the-fly route).
   Gates: surface RMSE < 0.02, no NaN, the large query agreeing with the
   chunked staged route, every kernel of the path launched by this run.  A
   small float64 session on the card is also held to the CPU path at 1e-6.
4. The joint (surface-normal) slice: start(points, normals=...) on a
   4,992-point sphere (J = 21,504), the 64^3 grid, extract_surface, a
   65,536-point query and predict_gradient at 256 surface points.  Gates:
   surface RMSE < 0.02, min cos(normal, radial) > 0.99, no NaN, every
   kernel of the path launched by this run; a small float64 joint session
   on the card held to the CPU path at 1e-6.
5. The out-of-core value slice: start(points, out_of_core=True) on phase
   3's cloud (C = 16,384, panel 1,024), the 64^3 grid, extract_surface and
   a 65,536-point query.  Gates: surface RMSE < 0.02, no NaN, the grid
   within 1e-2 of phase 3's in-core grid, every kernel of the path
   launched; a small float64 out-of-core session held to the CPU path at
   1e-6.
6. The out-of-core joint slice: the same on phase 4's cloud with normals
   (J = 20,480, panel 1,024), against phase 4's grid.
7. The host spill: ooc_fit on a 32,640-point sphere's training set
   (C = 32,768, panel 4,096) in a tiered store held to a 1 GB device budget,
   then a 65,536-point query.  Gates: spilled W panels, peak device memory
   under the budget plus the fit's own reserve, and the answer within 1e-2
   of an in-core fit_inference of the same set in float64 (in float32 the
   in-core factor at this size needs the jitter ladder's first rung,
   4 eps C k(0) ~ 1.6e-2, which moves the posterior by about as much as the
   gate: the two float32 fits would solve different systems).

8. The `panel_solve="inv"` option: phase 3's value session with the module
   default set to "inv" (Kernels J and K in the factor and the TRSM).
   Gates: surface RMSE < 0.02, the 64^3 grid within 1e-2 of phase 3's, J
   and K launched; then, on phase 3's Gram, ||L L^T - A|| and ||W L - I||
   (max entry) of the inv route each at most 8 x the substitution route's
   + 2e-4 (tests/test_tpu_smoke.py's gate), and fit_inference timed in
   turns on both routes.
9. The row-sharded pipeline on a one-rank NCCL group: fit_sharded on phase
   3's training set (C = 16,384, block 256), W again through Kernel L
   (sharded_linv(use_kernel=True)) held to the fit's plain W and put in the
   model, then the 64^3 grid, the surface and a 65,536-point query.  Gates:
   surface RMSE < 0.02, the grid within 1e-2 of phase 3's, no NaN, Kernels
   A band, G, L, A and F band launched; then sharded_linv timed in turns
   with and without Kernel L.
10. Tactile updates and surface projection: phase 3's sphere (16,256
   points) and phase 4's (4,992) with their cap z > 0.8 left out, the part
   a camera did not see, where the contacts (64 a batch) go.  The value
   session with 256 touch slots (capacity 17,408): four batches, a
   65,536-point query, the 64^3 grid, surface_points(n=256) and a fifth
   batch on the observed part of the sphere; the
   out-of-core value session and the one-rank sharded model (NCCL): two
   batches each, then the grid; phase 4's joint session (J = 21,504,
   1,024 slots): sixteen bordering batches and a seventeenth that
   overflows into the refit (J = 26,624), then the grid and
   predict_gradient; the out-of-core joint session: two batches, a big
   query and the grid.  Each update is timed on the host clock.  Gates: at
   every touched point the variance fell and |mean - target| <= 1e-3 (on
   the observed part, where a float32 touch moves the variance by less
   than its rounding, the fall is held on a float64 run of the same
   session and the float32 variance may rise by at most its quad's error
   against float64 there; after the joint refit, whose float32 W-quad errs
   by more than a touch beside the cloud lowers the variance, the fall is
   held on a float64 run and the float32 variance within 5e-4 of it; both
   float64 runs follow the counted run); surface RMSE
   < 0.02 and no NaN; each out-of-core and the sharded grid within 1e-2 of
   the in-core grid after the same touches; surface_points within 1e-5 of
   f = 0 with >= 95 % of seeds converged; A, E, D, F, F band, B and C
   launched; small float64 sessions (value with surface_points, joint
   through its refit, out of core) updated on the card and held to the CPU
   path at 1e-6.
11. Marginal-likelihood hyperparameter optimization (config 3) through the
   entry points a user calls.  (a) BASELINE.md's config-3 bar in float64:
   y drawn from an RBF GP of lengthscale 0.5 on 4,000 points (capacity
   4,096, so the MLL's Gram is Kernel A under `gram_ad` and its factor
   Kernel B under `blocked_cholesky_ad`), `optimize` from 2.0 (4x off) for
   150 Adam steps; gates: the lengthscale within 10 % of 0.5, the start's
   gradient within 1e-4 (norm-wise) of a central difference and within
   1e-6 of the CPU twins'.  (b) Phase 3's value session (float32,
   C = 16,384): optimize_hyperparameters(steps=10), the refit's 64^3 grid
   and surface; gates: no NaN in the history, the best MLL above the
   start's, RMSE < 0.02; then one objective step timed whole and split
   (Kernel A's primal, Kernel B's factor, the solves, the Cholesky
   pullback, the Gram pullback) beside the same step through the
   library's factor and its autograd.  (c) Phase 4's joint session
   (J = 21,504): five steps, the refit; gates: RMSE < 0.02, min
   cos(normal, radial) > 0.99.  (d) Phase 5's out-of-core session,
   method="stream": one objective step timed, its start gradient held to
   (b)'s dense float32 one within twice that one's distance to float64
   plus 1e-4 x max|g|, two steps and the refit; a small float64 stream
   objective held to the CPU path at 1e-6.  (e) Phase 6's out-of-core joint
   session, one stream step, and phase 9's one-rank NCCL sharded model,
   method="distributed", two steps.  Each refit's grid in (d) and (e)
   within 1e-2 of the in-core pipeline's at the refit's hyperparameters,
   and every refit's surface RMSE < 0.02.
   Launches: A and B in (a) and (b), E and B in (c), A band, G, H, I and B
   in (d), E, G, H and I in (e)'s out-of-core run, A band and G in its
   sharded one.

Kernel E is held to its twin in float32 (1e-5 x max|K|) and float64 (1e-10)
for the three covariances with coincident points, at an aligned and a
ragged layout (J % 4 == 3), as value rows and as an off-tile band with
noise, and on general metadata, over NaN-filled outputs, twice bit for bit
(`joint_kernel_checks`); then timed at the Gram, the cross and phase 6's
band (the band by the card's time, behind a spin kernel).
Phase 2 also holds the out-of-core kernels (I, and A and F in band mode)
to their twins at phase 7's shapes, I bit for bit also at its scalar edges
(heads and tails, odd pitches, float64, 70,000 rows).  B, C, G, H, J, K and
L, in float32 one split-TF32 tensor-core kernel (C, H, K and L its NN
layout, B, G and J its NT layout), are held to their twins run in float64
at 2e-6 x sum|a||b| of the worst output (B, G, H and L plus 4 ulps of
max|S| or max|U|), and to a bias gate on nonnegative operands, |mean (out
- twin) / sum|a||b|| <= 2e-8, for B and G with a = b (sums of squares on
the diagonal); B, G, J, K and L also in float64 (the SIMT tile); L also
leaves S bit-identical outside its live block.  C's and
H's bits are held by one sha256 to those recorded before B and G joined
their tile.  C and B are timed across j0, H at phase 7's k-step and finish
shapes, G at its k-step and diagonal-block shapes, J and K at the first, a
middle and the last step of the in-core factor and TRSM (C = 16,384,
B = 256), L at the sharded TRSM's middle step and I at phase 7's k-step
(both also by CUDA events back to back and by the host's enqueue), and the
in-core TRSM at C = 16,384 against the library's
triangular solve.  Every kernel's line carries its bound: the larger of
its operations over the card's FP32 rate (67 TFLOP/s; for B, C, D, F, G,
H, J, K and L the products at the split-TF32 rate, 494.7 / 4 TFLOP/s, and
F's kq generation beside them at the FP32 rate) and its bytes over its
memory rate (3.35 TB/s), counted from the shapes and data of the timed
call, and the time of the one PyTorch call that computes the same
function, where there is one.

The second-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

RMSE_GATE = 0.02
COS_GATE = 0.99  # min cos(posterior normal, radial): BASELINE.md's config-2 gate
QUAD_REL_TOL = 1e-4  # Kernels D and F: quad against the float64 twin, per query
BIG_QUERY = 65536  # a 256 x 256 depth image: its staged kq exceeds the cap
JOINT_SPHERE = (4992, 0.35, (0.2, -0.1, 0.05))  # bench/session_scenario.py --normals 4992
OOC_GRID_GAP = 1e-2  # out-of-core grid against the in-core one: float32, two factor orders
SPILL_N = 32640  # phase 7's sphere: with 127 external points and 1 internal, C = 32,768
SPILL_PANEL = 4096
SPILL_BUDGET = 1_000_000_000  # holds trimmed W panels 0-3 (0.81 GB); 4-7 spill
SHARDED_W_GAP = 1e-3  # W through Kernel L against the plain W, relative to max|W|
FP32_FLOPS = 67e12  # the H100's FP32 rate outside the tensor cores (700 W)
HBM_BYTES = 3.35e12  # its memory rate
TF32_FLOPS = 494.7e12  # its dense TF32 tensor-core rate
SPLIT_TF32_FLOPS = TF32_FLOPS / 4  # four TF32 passes a product: float32 B-D, F-H, J-L
TC_TOL = 2e-6  # those against the float64 twin: x sum|a||b| of the worst output
TC_BIAS = 2e-8  # |mean (out - f64 twin) / sum|a||b|| on nonnegative operands
F32_EPS = 2.0**-23
# sha256 of float32 C and H at fixed inputs (`tc_nn_digest`), recorded on an
# H100 with 132 multiprocessors (the split-K plan depends on the count) before
# B and G joined the tile: the NN path's bits, held through the NT layout.
TC_NN_SHA256 = "80f361d50b98a21f53c802b2af88c8539f44861abac322890bda8cc4a7b3fd30"
TC_NN_SHA256_SMS = 132


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call of the card's own time (CUDA events, after
    a warm-up), the calls queued behind a 3 ms spin kernel so that the host
    has enqueued them all before the card reaches the first: a call whose
    host time (`host_us`) exceeds its kernel's is timed by the kernel."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(6_000_000)  # ~3 ms at the H100's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(torch, fn, reps: int = 200) -> float:
    """Mean microseconds of host time per call of fn, enqueue only: the
    calls are queued back to back and the clock stops before the card is
    waited for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def bound(flops: float, nbytes: float, rate: float = FP32_FLOPS, simt_flops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the operations over
    `rate` (the FP32 rate unless said otherwise), the operations done beside
    them on the FP32 SIMT cores (`simt_flops`, F's kq generation) over the
    FP32 rate, and the bytes over the memory rate, and which binds."""
    t_ops = max(flops / rate, simt_flops / FP32_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_rate_tflops": rate / 1e12}


def check(name: str, err: float, tol: float, ms: float | None = None,
          plain_ms: float | None = None, err_name: str = "max_abs_err") -> None:
    timing = "" if ms is None else f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
    verdict = "ok" if err <= tol else "FAILED"
    say(f"  {name}: {err_name} {err:.3e} <= tol {tol:.3e} {verdict}{timing}")
    if not err <= tol:
        fail(f"{name} disagrees with its plain twin")


def query_kernel(torch, gen, kq, results: dict | None) -> None:
    """Kernel D against its twin at capacity C = kq.shape[1]; timed, and
    recorded in `results`, when `results` is given."""
    from gpis_tpu_torch.kernels import cuda_query

    dev = kq.device
    m, c = kq.shape

    def timed(fn, reps):
        return None if results is None else time_ms(torch, fn, reps)

    # D: staged quad + mean on a real kq chunk and a random lower W, against
    # the plain twin run in float64 on the same values.
    w = quad_test_w(torch, c, gen)
    alpha = torch.randn((c,), generator=gen, device=dev)
    mean, quad = cuda_query.staged_quad(kq, w, alpha)
    mean_r, quad_r = cuda_query.staged_quad_reference(kq.double(), w.double(), alpha.double())
    err_mean = (mean.double() - mean_r).abs().max().item()
    err_quad = (quad.double() - quad_r).abs().max().item()
    rel_quad = quad_rel_err(torch, quad, quad_r)
    tol_mean = 1e-4 * (kq.abs() @ alpha.abs()).max().item()
    del mean_r, quad_r
    ms = timed(lambda: cuda_query.staged_quad(kq, w, alpha), 3)
    plain = timed(lambda: cuda_query.staged_quad_reference(kq, w, alpha), 3)
    check(f"staged_quad mean M={m} C={c} (tol 1e-4 x sum|kq||alpha|)", err_mean, tol_mean)
    say(f"  staged_quad quad M={m} C={c}: max_abs_err {err_quad:.3e}")
    check(f"staged_quad quad M={m} C={c}, per query", rel_quad, QUAD_REL_TOL, ms, plain,
          err_name="max_rel_err")
    if results is not None:
        # Library call: the product W kq^T alone (the quad squares and sums it).
        lib = timed(lambda: torch.matmul(w, kq.T), 3)
        # A small query: one wave of C / 128 units, the longest C / 32 chunks deep.
        small = kq[:128]
        small_ms = timed(lambda: cuda_query.staged_quad(small, w, alpha), 10)
        small_lib = timed(lambda: torch.matmul(w, small.T), 10)
        say(f"  staged_quad M=128 C={c}: kernel {small_ms:.4f} ms  matmul {small_lib:.4f} ms")
        # The host's first call at a shape makes its plan (Python, then int32
        # tensors on the card; cached after): timed here uncached.
        from gpis_tpu_torch.linalg import cuda_chol

        t0 = time.perf_counter()
        cuda_chol._tc_plan_on.__wrapped__(kq.device, c, m, c, False, 0, "rows", 0, True)
        torch.cuda.synchronize()
        plan_ms = (time.perf_counter() - t0) * 1e3
        say(f"  staged_quad plan M={m} C={c}: {-(-c // 128) * -(-m // 128)} units made in "
            f"{plan_ms:.1f} ms of host time (a shape's first call)")
        # The triangular product at the split-TF32 rate (float32: the tensor-core
        # tile); the mean's GEMV and the squares beside it.
        results["staged_quad"] = dict(max_abs_err=max(err_mean, err_quad), ms=ms,
                                      plain_ms=plain, library_ms=lib, m128_ms=small_ms,
                                      m128_library_ms=small_lib, plan_host_ms=plan_ms,
                                      **bound(m * c * c + 4 * m * c,
                                              4 * (m * c + c * c / 2 + c + 2 * m),
                                              SPLIT_TF32_FLOPS))


def quad_test_w(torch, c: int, gen):
    """A random lower-triangular W for Kernel D's check.  Row i is scaled by
    1/sqrt(i+1), so every 64-row tile of W carries a share of each query's
    quad that a kernel skipping it would miss by far more than QUAD_REL_TOL."""
    w = torch.tril(torch.randn((c, c), generator=gen, device=gen.device))
    return w.div_(torch.arange(1, c + 1, device=w.device, dtype=w.dtype).sqrt()[:, None])


def quad_rel_err(torch, quad, quad_ref) -> float:
    """max over queries of |quad - quad_ref| / quad_ref.  quad is a sum of
    squares, so each query is held to its own value: a missed W row tile or
    k slice moves some query's quad by 1e-3 or more of itself, float32
    summation by ~1e-6."""
    ref = quad_ref.clamp_min(torch.finfo(torch.float64).tiny)
    return ((quad.double() - quad_ref).abs() / ref).max().item()


def joint_columns(torch, dev):
    """Joint metadata at the joint slice's shape: C = 5,120 points on the
    unit sphere and T = 1,024 touch slots at the origin (coincident among
    themselves), J = 4C + T = 21,504."""
    from gpis_tpu_torch.data.gpis import fibonacci_sphere
    from gpis_tpu_torch.kernels import cuda_joint

    x = torch.as_tensor(fibonacci_sphere(5120), dtype=torch.float32, device=dev)
    return cuda_joint.joint_meta(x, torch.zeros((1024, 3), device=dev))


def joint_kernel_checks(torch, gen, results: dict) -> None:
    """Kernel E against its twin at its edges, in float32 and float64, for
    the three covariances with coincident points: an aligned layout (C =
    1,024, T = 256: J % 4 == 0, the vector stores) and a ragged one (C =
    1,001, T = 63: J = 4,067, J % 4 == 3, the scalar path, the kinds'
    boundaries mid-tile), each as the Gram with noise, as value rows (64
    queries on data points) and as a band of 517 rows at row0 1,037 (off a
    tile, the noise diagonal entering mid-tile) with noise; and the ragged
    Gram of general metadata (random directions and flags: the full blend).  Every
    output is allocated over NaN (a missed element shows), and a second
    call must repeat the first bit for bit.  Tolerance: 1e-5 x max|K| in
    float32, 1e-10 x max(1, max|K|) in float64 (only rounding differs: one
    exp or sqrt against three)."""
    from gpis_tpu_torch.data.gpis import fibonacci_sphere
    from gpis_tpu_torch.kernels import cuda_joint

    dev = gen.device
    worst = 0.0
    for dt in (torch.float32, torch.float64):
        for layout, c, t in (("aligned", 1024, 256), ("ragged", 1001, 63)):
            x = torch.as_tensor(fibonacci_sphere(c), dtype=dt, device=dev)
            x[c // 2:c // 2 + 64] = x[:64]  # distinct indices, coincident points
            meta = cuda_joint.joint_meta(x, torch.zeros((t, 3), dtype=dt, device=dev))
            j = meta[0].shape[0]
            noise = torch.rand((j,), generator=gen, device=dev, dtype=dt) * 9e-3 + 1e-3
            q = torch.rand((1984, 3), generator=gen, device=dev, dtype=dt) * 3.0 - 1.5
            cases = [("gram+noise", meta, meta, noise, 0),
                     ("value rows", cuda_joint.value_meta(torch.cat([x[:64], q])), meta, None, 0),
                     ("band+noise 517 rows at row0 1037",
                      tuple(m[1037:1037 + 517] for m in meta), meta, noise, 1037)]
            if layout == "ragged":
                general = (meta[0], torch.randn((j, 3), generator=gen, device=dev, dtype=dt),
                           torch.rand((j,), generator=gen, device=dev, dtype=dt))
                cases.append(("general metadata", general, general, noise, 0))
            for name, ls in (("rbf", 0.4), ("thin_plate", 2.5), ("inverse_multiquadric", 0.4)):
                p = {"lengthscale": ls, "signal_variance": 1.0}
                for mode, rows, cols, nz, row0 in cases:
                    want = cuda_joint.joint_rows_reference(name, rows, cols, p, noise_col=nz,
                                                           row0=row0)
                    shape = (rows[0].shape[0], j)
                    poisoned_empty(torch, shape, dev, dt)
                    got = cuda_joint.joint_rows(name, rows, cols, p, noise_col=nz, row0=row0)
                    poisoned_empty(torch, shape, dev, dt)
                    again = cuda_joint.joint_rows(name, rows, cols, p, noise_col=nz, row0=row0)
                    err = (got - want).abs().max().item()
                    scale = max(1.0, want.abs().max().item())
                    tol = (1e-5 if dt == torch.float32 else 1e-10) * scale
                    what = (f"joint_cov {name} {layout} {mode} {shape[0]}x{j} {str(dt)[6:]}")
                    check(f"{what} (tol {tol / scale:.0e} x max(1, max|K|))", err, tol)
                    if not torch.equal(got, again):
                        fail(f"{what}: a second call gave other bits")
                    if dt == torch.float32:
                        worst = max(worst, err)
                    del want, got, again
    results["joint_cov_checks"] = worst


def joint_cov_kernel(torch, gen, q, results: dict) -> dict:
    """Kernel E against its twin in rbf at the joint slice's shapes, timed:
    the Gram with noise (J = 21,504), the value-query cross (no noise) and
    phase 6's band of 1,024 rows at row0 19,456 with noise."""
    from gpis_tpu_torch.kernels import cuda_joint

    dev = q.device
    p = {"lengthscale": 0.4, "signal_variance": 1.0}
    meta = joint_columns(torch, dev)
    j = meta[0].shape[0]
    noise = torch.full((j,), 1e-3, device=dev)
    got = cuda_joint.joint_rows("rbf", meta, meta, p, noise_col=noise)
    want = cuda_joint.joint_rows_reference("rbf", meta, meta, p, noise_col=noise)
    err = (got - want).abs().max().item()
    tol = 1e-5 * max(1.0, want.abs().max().item())
    del got, want
    ms = time_ms(torch, lambda: cuda_joint.joint_rows("rbf", meta, meta, p, noise_col=noise), 5)
    plain = time_ms(torch, lambda: cuda_joint.joint_rows_reference("rbf", meta, meta, p,
                                                                   noise_col=noise), 1)
    check(f"joint_cov rbf gram J={j} (tol 1e-5 x max|K|)", err, tol, ms, plain)
    qmeta = cuda_joint.value_meta(q)
    want = cuda_joint.joint_rows_reference("rbf", qmeta, meta, p)
    err_x = (cuda_joint.joint_rows("rbf", qmeta, meta, p) - want).abs().max().item()
    tol_x = 1e-5 * max(1.0, want.abs().max().item())
    del want
    ms_x = time_ms(torch, lambda: cuda_joint.joint_rows("rbf", qmeta, meta, p), 5)
    plain_x = time_ms(torch, lambda: cuda_joint.joint_rows_reference("rbf", qmeta, meta, p), 1)
    check(f"joint_cov rbf cross M={q.shape[0]} J={j}", err_x, tol_x, ms_x, plain_x)
    row0, rb = 19456, 1024
    band = tuple(m[row0:row0 + rb] for m in meta)
    want = cuda_joint.joint_rows_reference("rbf", band, meta, p, noise_col=noise, row0=row0)
    err_b = (cuda_joint.joint_rows("rbf", band, meta, p, noise_col=noise, row0=row0)
             - want).abs().max().item()
    tol_b = 1e-5 * max(1.0, want.abs().max().item())
    del want
    # A ~0.05 ms launch: the card's time (queued behind a spin), not the host's.
    ms_b = device_ms(torch, lambda: cuda_joint.joint_rows("rbf", band, meta, p, noise_col=noise,
                                                          row0=row0), 20)
    plain_b = device_ms(torch, lambda: cuda_joint.joint_rows_reference(
        "rbf", band, meta, p, noise_col=noise, row0=row0), 3)
    check(f"joint_cov rbf band R={rb} at row0 {row0} J={j}", err_b, tol_b, ms_b, plain_b)
    # About 30 operations and one exp an element; one store an element, the
    # rows' and columns' 7-float metadata and the noise read once.
    results["joint_cov"] = dict(max_abs_err=max(results.get("joint_cov_checks", 0.0), err, err_x,
                                                err_b),
                                ms=ms, plain_ms=plain, library_ms=None,
                                **bound(30 * j * j, 4 * (j * j + 15 * j)))
    m = q.shape[0]
    return {"joint_cov_cross": dict(ms=ms_x, plain_ms=plain_x,
                                    **bound(30 * m * j, 4 * (m * j + 7 * j + 7 * m))),
            "joint_cov_band": dict(ms=ms_b, plain_ms=plain_b,
                                   **bound(30 * rb * j, 4 * (rb * j + 7 * rb + 8 * j)))}


def fused_quad_kernel(torch, gen, q, cols, kind: str) -> dict:
    """Kernel F with generator `kind` against its twin run in float64 at
    columns `cols`, and timed beside the f32 twin and the staged route."""
    from gpis_tpu_torch.kernels import cuda_joint, cuda_query
    from gpis_tpu_torch.kernels import gram as kg

    n = cols.shape[0]
    p = {"lengthscale": 0.4, "signal_variance": 1.0}
    w = quad_test_w(torch, n, gen)
    alpha = torch.randn((n,), generator=gen, device=q.device)
    mean, quad = cuda_query.fused_quad(kind, "rbf", q, cols, p, alpha, w)
    kq64 = cuda_query.generated_kq(kind, "rbf", q.double(), cols.double(), p)
    mean_r, quad_r = cuda_query.staged_quad_reference(kq64, w.double(), alpha.double())
    scale = (kq64.abs() @ alpha.double().abs()).max().item()
    del kq64
    err_mean = (mean.double() - mean_r).abs().max().item()
    err_quad = (quad.double() - quad_r).abs().max().item()
    rel_quad = quad_rel_err(torch, quad, quad_r)
    del mean_r, quad_r
    ms = time_ms(torch, lambda: cuda_query.fused_quad(kind, "rbf", q, cols, p, alpha, w), 3)
    plain = time_ms(torch, lambda: cuda_query.fused_quad_reference(kind, "rbf", q, cols, p,
                                                                   alpha, w), 3)
    def staged():  # the staged route at the same shape: kq written (A or E), then D
        if kind == "value":
            kq = kg.cross_cov("rbf", q, cols, p)
        else:
            kq = cuda_joint.joint_rows("rbf", cuda_joint.value_meta(q),
                                       (cols[:, :3], cols[:, 3:6], cols[:, 6]), p)
        return cuda_query.staged_quad(kq, w, alpha)

    staged_ms = time_ms(torch, staged, 3)
    shape = f"{kind} M={q.shape[0]} {'C' if kind == 'value' else 'J'}={n}"
    check(f"fused_quad {shape} mean (tol 1e-4 x sum|kq||alpha|)", err_mean, 1e-4 * scale)
    say(f"  fused_quad {shape} quad: max_abs_err {err_quad:.3e}")
    check(f"fused_quad {shape} quad, per query", rel_quad, QUAD_REL_TOL, ms, plain,
          err_name="max_rel_err")
    say(f"  crossover {shape}: staged route (kq written, then D) {staged_ms:.4f} ms, "
        f"on the fly (F) {ms:.4f} ms")
    # The triangular product (m n^2) at the split-TF32 rate, and beside it
    # on the SIMT cores kq generated once for the quad and once for the mean
    # (about 12 operations an element for a value column, 30 for a joint one).
    m = q.shape[0]
    gen_ops = 2 * (12 if kind == "value" else 30) + 2
    return dict(max_abs_err=max(err_mean, err_quad), ms=ms, plain_ms=plain, staged_ms=staged_ms,
                **bound(m * n * n, 4 * (n * n / 2 + cols.numel() + n + 5 * m), SPLIT_TF32_FLOPS,
                        simt_flops=gen_ops * m * n))


def band_test_w(torch, rows: int, row0: int, width: int, gen):
    """A W row band at global rows [row0, row0 + rows), zero past each row's
    own global index (W is lower-triangular), row i scaled by 1/sqrt(row0 +
    i + 1) as in `quad_test_w`, so every live column tile carries a share of
    each query's quad that a kernel skipping it would miss."""
    w = torch.tril(torch.randn((rows, width), generator=gen, device=gen.device), diagonal=row0)
    scale = torch.arange(row0 + 1, row0 + rows + 1, device=w.device, dtype=w.dtype).sqrt()
    return w.div_(scale[:, None])


def quad_band_kernel(torch, gen, q, cols, kind: str, rows: int, row0: int) -> dict:
    """Kernel F's band mode against its twin run in float64, per query."""
    from gpis_tpu_torch.kernels import cuda_query

    p = {"lengthscale": 0.4, "signal_variance": 1.0}
    n = cols.shape[0]
    w = band_test_w(torch, rows, row0, n, gen)
    quad = cuda_query.quad_band(kind, "rbf", q, cols, p, w, row0)
    quad_r = cuda_query.quad_band_reference(kind, "rbf", q.double(), cols.double(), p, w.double(),
                                            row0)
    err = (quad.double() - quad_r).abs().max().item()
    rel = quad_rel_err(torch, quad, quad_r)
    del quad_r
    ms = time_ms(torch, lambda: cuda_query.quad_band(kind, "rbf", q, cols, p, w, row0), 3)
    plain = time_ms(torch, lambda: cuda_query.quad_band_reference(kind, "rbf", q, cols, p, w,
                                                                  row0), 3)
    shape = f"{kind} M={q.shape[0]} R={rows} {'C' if kind == 'value' else 'J'}={n} row0={row0}"
    say(f"  quad_band {shape}: max_abs_err {err:.3e}")
    check(f"quad_band {shape}, per query", rel, QUAD_REL_TOL, ms, plain, err_name="max_rel_err")
    # The band's nonzeros (row row0 + i has row0 + i + 1) at the split-TF32
    # rate, and beside them kq generated once per (query, column): about 12
    # operations (value) or 30 (joint).
    m = q.shape[0]
    nnz = rows * row0 + rows * (rows + 1) // 2
    gen_ops = 12 if kind == "value" else 30
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
                **bound(2 * m * nnz + 2 * m * rows, 4 * (nnz + cols.numel() + 4 * m),
                        SPLIT_TF32_FLOPS, simt_flops=gen_ops * m * (row0 + rows)))


def ooc_kernels(torch, gen, results: dict) -> None:
    """The out-of-core kernel I, and A and F in band mode, against their
    twins at phase 7's shapes (panel 4,096, sweep 2, so a band of R = 8,192
    rows, C = 32,768), and the joint band quad at phase 6's (J = 20,480,
    panel 1,024).  G is held in `nt_kernel_checks`, H in `nn_kernel_checks`."""
    from gpis_tpu_torch.data.gpis import fibonacci_sphere
    from gpis_tpu_torch.kernels import cuda_gram, cuda_joint
    from gpis_tpu_torch.linalg import cuda_chol

    dev = gen.device
    r, p, c = 2 * SPILL_PANEL, SPILL_PANEL, 32768

    # I: an (R, P) stripe into the (R, C) band at column 16,384; exact.  Timed
    # three ways beside `copy_`: the card's own time (`device_ms`, the kernels
    # line's), CUDA events around back-to-back calls, and the host's enqueue.
    dst = torch.zeros((r, c), device=dev)
    blk = torch.randn((r, p), generator=gen, device=dev)
    c0 = c // 2
    got = cuda_chol.stripe_write(dst.clone(), blk, c0)
    err = (got - cuda_chol.stripe_write_reference(dst.clone(), blk, c0)).abs().max().item()
    del got
    kernel = lambda: cuda_chol.stripe_write(dst, blk, c0)  # noqa: E731
    copy = lambda: dst[:, c0:c0 + p].copy_(blk)  # noqa: E731
    ms = device_ms(torch, kernel, 20)
    plain = device_ms(torch, lambda: cuda_chol.stripe_write_reference(dst, blk, c0), 20)
    check(f"stripe_write ({r}, {p}) into ({r}, {c}) at {c0} (exact)", err, 0.0, ms, plain)
    lib = device_ms(torch, copy, 20)
    results["stripe_write"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
        events_ms=time_ms(torch, kernel, 20), library_events_ms=time_ms(torch, copy, 20),
        host_us=host_us(torch, kernel), library_host_us=host_us(torch, copy),
        **bound(0, 4 * 2 * r * p))
    t = results["stripe_write"]
    say(f"  stripe_write: card {ms:.4f} ms (copy_ {lib:.4f}), events {t['events_ms']:.4f} ms "
        f"(copy_ {t['library_events_ms']:.4f}), host {t['host_us']:.1f} us a call (copy_ "
        f"{t['library_host_us']:.1f}); bound {t['bound_ms']:.4f} ms")
    del dst, blk
    # I's edges, exact: a scalar head and tail around the vectors (c0 1 or 3
    # with blk at the same offset mod 16 bytes), scalars alone (other
    # offsets, an odd pitch), float64, and rows past the old 65,535 grid.
    for dtype, rows, c0, w_, lead, off in (
            (torch.float32, 300, 1, 301, 304, 1), (torch.float32, 300, 3, 7, 16, 3),
            (torch.float32, 300, 0, 301, 304, 0), (torch.float32, 300, 3, 301, 304, 0),
            (torch.float32, 300, 1, 7, 7, 0), (torch.float64, 300, 1, 300, 302, 1),
            (torch.float64, 300, 3, 7, 9, 0), (torch.float32, 70000, 0, 8, 8, 0),
            (torch.float32, 70000, 3, 8, 8, 0)):
        dst = torch.randn((rows, 1000), generator=gen, device=dev, dtype=dtype)
        blk = torch.randn((rows, lead), generator=gen, device=dev, dtype=dtype)[:, off:off + w_]
        got = cuda_chol.stripe_write(dst.clone(), blk, c0)
        want = cuda_chol.stripe_write_reference(dst.clone(), blk, c0)
        check(f"stripe_write {str(dtype)[6:]} ({rows}, {w_}) at {c0}, blk pitch {lead} at "
              f"column {off} (exact)", float(not torch.equal(got, want)), 0.0,
              err_name="rows or columns wrong")
    del dst, blk, got, want

    # A in band mode: rows [16,384, 24,576) of the C = 32,768 Gram.
    params = {"lengthscale": 0.4, "signal_variance": 1.0}
    x = torch.as_tensor(fibonacci_sphere(c), dtype=torch.float32, device=dev)
    noise = torch.full((r,), 1e-3, device=dev)
    row0 = c // 2
    band = x[row0:row0 + r]
    got = cuda_gram.cov("rbf", band, x, params, noise=noise, sym=True, row0=row0)
    want = cuda_gram.cov_reference("rbf", band, x, params, noise=noise, sym=True, row0=row0)
    err = (got - want).abs().max().item()
    diag_ok = torch.equal(got[:, row0:row0 + r].diagonal(), want[:, row0:row0 + r].diagonal())
    del got, want
    ms = time_ms(torch, lambda: cuda_gram.cov("rbf", band, x, params, noise=noise, sym=True,
                                              row0=row0), 5)
    plain = time_ms(torch, lambda: cuda_gram.cov_reference("rbf", band, x, params, noise=noise,
                                                           sym=True, row0=row0), 3)
    check(f"gram_band {r}x{c} at row0={row0}", err, 1e-5, ms, plain)
    if not diag_ok:
        fail("gram_band put its diagonal elsewhere than global row == column")
    results["gram_band"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
                                **bound(10 * r * c, 4 * (r * c + 3 * r + 3 * c + r)))

    # F in band mode: phase 7's last W panel (value), phase 6's (joint).
    q = (torch.rand((8192, 3), generator=gen, device=dev) * 3.0 - 1.5).contiguous()
    value = quad_band_kernel(torch, gen, q, x, "value", p, c - p)
    jcols = cuda_joint.pack_meta(cuda_joint.joint_meta(
        torch.as_tensor(fibonacci_sphere(5120), dtype=torch.float32, device=dev)))
    joint = quad_band_kernel(torch, gen, q, jcols, "joint", 1024, jcols.shape[0] - 1024)
    results["quad_band"] = dict(value, max_abs_err=max(value["max_abs_err"],
                                                       joint["max_abs_err"]))
    say(json.dumps({"quad_band_joint": joint, "card": card_line()}))


def tc_err(got, want, a, b) -> tuple[float, float]:
    """(max |got - want|, TC_TOL x sum|a||b| of the worst output): want is
    the float64 twin, a and b the product's operands (the worst output's
    magnitude sum, computed in float64)."""
    err = (got.double() - want).abs().max().item()
    return err, TC_TOL * (a.double().abs() @ b.double().abs()).max().item()


def tc_bias(got, want) -> float:
    """mean over outputs of (out - f64 twin) / sum|a||b|, on nonnegative
    operands (where sum|a||b| is the twin's own value): the tensor core's
    truncating accumulator shows here as a negative mean of ~1e-7."""
    return ((got.double() - want) / want.clamp_min(1e-300)).mean().item()


def nn_kernel_checks(torch, gen, results: dict) -> None:
    """Kernels C and H in float32 (the split-TF32 tensor-core body) against
    their twins run in float64: tol TC_TOL x sum|a||b| of the worst output,
    plus 4 float32 ulps of max|U| for H (the old values it adds to); and the
    bias gate, |mean (out - twin) / sum|a||b|| <= TC_BIAS on nonnegative
    operands.  C at the in-core TRSM's shapes (C = 16,384, B = 256, j0 256
    and 8,192: split into units); H at phase 7's k-step (R 8,192, K 4,096,
    w 4,096 and 32,768) and its finish (256 rows of the (R, C) buffer over k = r0 < its own rows: a
    wide one without split, a narrow one with)."""
    from gpis_tpu_torch.linalg import cuda_chol

    dev = gen.device
    c, bw = 16384, 256
    worst_c = 0.0
    w = torch.tril(torch.randn((c, c), generator=gen, device=dev)) / (c // 2) ** 0.5
    l_row = torch.randn((bw, c), generator=gen, device=dev)
    for j0 in (256, c // 2):
        got = cuda_chol.row_update(w, l_row, j0)
        want = cuda_chol.row_update_reference(w.double(), l_row.double(), j0)
        err, tol = tc_err(got, want, l_row[:, :j0], w[:j0, :j0])
        zeros = torch.equal(got[:, j0:], torch.zeros_like(got[:, j0:]))
        del got, want
        check(f"row_update C={c} j0={j0} B={bw} f32 vs f64 twin (tol {TC_TOL} x sum|a||b|)",
              err, tol)
        if not zeros:
            fail(f"row_update wrote nonzeros at columns >= j0={j0}")
        worst_c = max(worst_c, err)
    # The bias gate on nonnegative operands.
    j0 = c // 2
    w.uniform_(0.0, 1.0, generator=gen).tril_()
    l_row.uniform_(0.0, 1.0, generator=gen)
    got = cuda_chol.row_update(w, l_row, j0)
    bias = tc_bias(got[:, :j0], cuda_chol.row_update_reference(
        w.double(), l_row.double(), j0)[:, :j0])
    check(f"row_update bias on nonnegative operands, j0={j0}", abs(bias), TC_BIAS,
          err_name="|mean rel err|")
    results["row_update"] = dict(max_abs_err=worst_c)
    del w, l_row, got
    torch.cuda.empty_cache()

    r, k, wide = 2 * SPILL_PANEL, SPILL_PANEL, 32768
    lj = torch.randn((r, wide), generator=gen, device=dev) / k**0.5
    a = lj[:, wide - 2 * k:wide - k]  # the k-step's strided column slice
    wk = torch.randn((k, wide), generator=gen, device=dev)
    u0 = torch.randn((r, wide), generator=gen, device=dev)
    ulps = 4 * torch.finfo(torch.float32).eps * u0.abs().max().item()
    worst_h = 0.0
    for w_ in (k, wide):
        got = cuda_chol.gemm_nn_acc_masked(u0.clone(), a, wk, w_)
        untouched = torch.equal(got[:, w_:], u0[:, w_:])
        want = u0.double()
        want[:, :w_] += a.double() @ wk[:, :w_].double()
        err, tol = tc_err(got, want, a, wk[:, :w_])
        del got, want
        check(f"gemm_nn_acc_masked R={r} K={k} w={w_} f32 vs f64 twin "
              f"(tol {TC_TOL} x sum|a||b| + 4 ulp max|U|)", err, tol + ulps)
        if not untouched:
            fail(f"gemm_nn_acc_masked wrote columns >= w={w_}")
        worst_h = max(worst_h, err)
    del lj, a, wk
    # The finish: rows [r0, r0 + 256) of u += (-Ljj[r0 rows, :r0]) u[:r0].
    ljj = torch.randn((r, r), generator=gen, device=dev) / r**0.5
    for r0, width in ((r - 256, wide), (k, 2 * k)):
        a = -ljj[r0:r0 + 256, :r0]
        got = u0.clone()
        cuda_chol.gemm_nn_acc_masked(got[r0:r0 + 256, :width], a, got[:r0], width)
        want = u0[r0:r0 + 256].double()
        want[:, :width] += a.double() @ u0[:r0, :width].double()
        err, tol = tc_err(got[r0:r0 + 256], want, a, u0[:r0, :width])
        untouched = (torch.equal(got[:r0], u0[:r0]) and torch.equal(got[r0 + 256:], u0[r0 + 256:])
                     and torch.equal(got[:, width:], u0[:, width:]))
        del got, want
        check(f"gemm_nn_acc_masked finish rows [{r0}, {r0 + 256}) w={width} k={r0} (alias) "
              "f32 vs f64 twin", err, tol + ulps)
        if not untouched:
            fail("gemm_nn_acc_masked (finish) wrote outside its rows and columns")
        worst_h = max(worst_h, err)
    del ljj, u0
    torch.cuda.empty_cache()
    # The bias gate, U = 0 and nonnegative operands: 512 tiles, no split.
    a = torch.rand((2048, k), generator=gen, device=dev)
    b = torch.rand((k, 4096), generator=gen, device=dev)
    got = cuda_chol.gemm_nn_acc_masked(torch.zeros((2048, 4096), device=dev), a, b, 4096)
    bias = tc_bias(got, a.double() @ b.double())
    check(f"gemm_nn_acc_masked bias on nonnegative operands, R=2048 K={k} w=4096",
          abs(bias), TC_BIAS, err_name="|mean rel err|")
    results["gemm_nn_acc_masked"] = dict(max_abs_err=worst_h)
    del a, b, got
    torch.cuda.empty_cache()


def nn_kernel_times(torch, gen, results: dict) -> None:
    """Kernels C and H timed beside their float32 twins and their library
    calls, with the bound at the split-TF32 rate (SPLIT_TF32_FLOPS: four
    TF32 passes a product): C across j0 at C = 16,384, B = 256 (the kernels
    line takes j0 8,192); H at phase 7's k-step (the line takes w 32,768)
    and finish shapes.  Then the in-core TRSM, `blocked_linv` at C = 16,384,
    in turns against the library's triangular solve of L against I (a
    yardstick: the port never calls it)."""
    from gpis_tpu_torch.linalg import cuda_chol

    dev = gen.device
    c, bw = 16384, 256
    w = torch.tril(torch.randn((c, c), generator=gen, device=dev)) / (c // 2) ** 0.5
    l_row = torch.randn((bw, c), generator=gen, device=dev)
    per_j0 = {}
    for j0 in (256, 4096, 8192, 12288, 16128):
        ms = time_ms(torch, lambda: cuda_chol.row_update(w, l_row, j0), 10)
        plain = time_ms(torch, lambda: cuda_chol.row_update_reference(w, l_row, j0), 10)
        lib = time_ms(torch, lambda: torch.matmul(l_row[:, :j0], w[:j0, :j0]), 10)
        # W is lower-triangular: the product needs j0^2 / 2 of its entries.
        per_j0[j0] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                          **bound(bw * j0 * j0, 4 * (bw * j0 + j0 * j0 / 2 + bw * c),
                                  SPLIT_TF32_FLOPS))
        say(f"  row_update C={c} B={bw} j0={j0}: kernel {ms:.4f} ms  plain {plain:.4f} ms  "
            f"matmul {lib:.4f} ms  bound {per_j0[j0]['bound_ms']:.4f} ms")
    results["row_update"].update(per_j0[8192])
    del w, l_row
    torch.cuda.empty_cache()

    r, k, wide = 2 * SPILL_PANEL, SPILL_PANEL, 32768
    lj = torch.randn((r, wide), generator=gen, device=dev) / k**0.5
    a = lj[:, wide - 2 * k:wide - k]
    wk = torch.randn((k, wide), generator=gen, device=dev)
    u = torch.randn((r, wide), generator=gen, device=dev)
    shapes = {}
    for w_ in (k, wide):
        ms = time_ms(torch, lambda: cuda_chol.gemm_nn_acc_masked(u, a, wk, w_), 3)
        plain = time_ms(torch, lambda: cuda_chol.gemm_nn_acc_masked_reference(u, a, wk, w_), 3)
        lib = time_ms(torch, lambda: torch.addmm(u[:, :w_], a, wk[:, :w_]), 3)
        shapes[f"kstep_R{r}_K{k}_w{w_}"] = dict(
            ms=ms, plain_ms=plain, library_ms=lib,
            **bound(2 * r * k * w_, 4 * (r * k + k * w_ + 2 * r * w_), SPLIT_TF32_FLOPS))
    results["gemm_nn_acc_masked"].update(shapes[f"kstep_R{r}_K{k}_w{wide}"])
    del lj, a, wk
    ljj = torch.randn((256, r), generator=gen, device=dev) / r**0.5
    for r0, width in ((r - 256, wide), (k, 2 * k)):
        a = ljj[:, :r0].contiguous()
        xr, b = u[r0:r0 + 256, :width], u[:r0]
        ms = time_ms(torch, lambda: cuda_chol.gemm_nn_acc_masked(xr, a, b, width), 5)
        plain = time_ms(torch, lambda: cuda_chol.gemm_nn_acc_masked_reference(xr, a, b, width), 5)
        lib = time_ms(torch, lambda: torch.addmm(xr, a, b[:, :width]), 5)
        shapes[f"finish_rows256_k{r0}_w{width}"] = dict(
            ms=ms, plain_ms=plain, library_ms=lib,
            **bound(2 * 256 * r0 * width, 4 * (256 * r0 + r0 * width + 2 * 256 * width),
                    SPLIT_TF32_FLOPS))
    for name, v in shapes.items():
        say(f"  gemm_nn_acc_masked {name}: kernel {v['ms']:.4f} ms  plain {v['plain_ms']:.4f} ms"
            f"  addmm {v['library_ms']:.4f} ms  bound {v['bound_ms']:.4f} ms")
    del ljj, u
    torch.cuda.empty_cache()

    # The in-core TRSM on a well-conditioned factor, in turns.
    g = torch.randn((c, c), generator=gen, device=dev)
    spd = torch.addmm(torch.eye(c, device=dev), g, g.T, alpha=1.0 / c)
    del g
    l = torch.linalg.cholesky(spd).contiguous()
    del spd
    eye = torch.eye(c, device=dev)
    trsm = []
    for route in ("blocked_linv", "solve_triangular", "solve_triangular", "blocked_linv"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if route == "blocked_linv":
            out = cuda_chol.blocked_linv(l, 256)
        else:
            out = torch.linalg.solve_triangular(l, eye, upper=False)
        torch.cuda.synchronize()
        trsm.append([route, time.perf_counter() - t0])
        del out
    say(json.dumps({"row_update_by_j0": per_j0, "gemm_nn_acc_masked_shapes": shapes,
                    "trsm_C16384_s_in_turns": trsm, "card": card_line()}))
    del l, eye
    torch.cuda.empty_cache()


def fixed_matrix(torch, rows: int, cols: int, seed: int, dev):
    """A float32 matrix that is the same on every machine and library
    version: 24-bit fractions of a multiplicative hash of the element index
    (exact in float32), in [-0.5, 0.5)."""
    i = torch.arange(rows * cols, dtype=torch.int64, device=dev)
    v = (i * 2654435761 + seed * 40503) % (1 << 24)
    return (v.to(torch.float32) / (1 << 24) - 0.5).reshape(rows, cols)


def tc_nn_digest(torch) -> str:
    """sha256 over float32 C at j0 700, 8,192 and 16,128 (C = 16,384,
    B = 256) and H at the k-step (R 8,192, K 4,096, w 4,096) and the finish
    (256 rows, k 4,096, w 8,192, a split tile), on `fixed_matrix` inputs."""
    import hashlib

    from gpis_tpu_torch.linalg import cuda_chol

    dev = torch.device("cuda")
    h = hashlib.sha256()
    w = fixed_matrix(torch, 16384, 16384, 1, dev).tril_()
    l_row = fixed_matrix(torch, 256, 16384, 2, dev)
    for j0 in (700, 8192, 16128):
        h.update(cuda_chol.row_update(w, l_row, j0).cpu().numpy().tobytes())
    del w, l_row
    a = fixed_matrix(torch, 8192, 4096, 3, dev)
    b = fixed_matrix(torch, 4096, 4096, 4, dev)
    u = fixed_matrix(torch, 8192, 4096, 5, dev)
    h.update(cuda_chol.gemm_nn_acc_masked(u, a, b, 4096).cpu().numpy().tobytes())
    a = fixed_matrix(torch, 256, 4096, 6, dev)
    buf = fixed_matrix(torch, 8192, 8192, 7, dev)
    cuda_chol.gemm_nn_acc_masked(buf[4096:4352], a, buf[:4096], 8192)
    h.update(buf[4096:4352].cpu().numpy().tobytes())
    del a, b, u, buf
    torch.cuda.empty_cache()
    return h.hexdigest()


def tc_nn_bits(torch) -> None:
    """C and H must come out of the NT layout's addition bit for bit: their
    digest against the recorded one (TC_NN_SHA256), on a card of
    TC_NN_SHA256_SMS multiprocessors; on another count the plan differs and
    only the digest is printed."""
    digest = tc_nn_digest(torch)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    if n_sm != TC_NN_SHA256_SMS:
        say(f"  C/H sha256 {digest}: not compared ({n_sm} multiprocessors, the reference "
            f"was taken at {TC_NN_SHA256_SMS})")
        return
    same = digest == TC_NN_SHA256
    say(f"  C/H sha256 {digest} {'ok' if same else 'FAILED'} (recorded: {TC_NN_SHA256})")
    if not same:
        fail("float32 C or H no longer gives its recorded bits")


def nt_kernel_checks(torch, gen, results: dict) -> None:
    """Kernels B and G in float32 (the split-TF32 tensor-core body, NT
    layout) against their twins run in float64: tol TC_TOL x sum|a||b| of
    the worst output plus 4 float32 ulps of max|S| (the values the product
    is subtracted from); and the bias gate, |mean (out - twin) / sum|a||b||
    <= TC_BIAS on nonnegative operands with a = b -- B on a panel of one
    matrix, G at `_chol_diag`'s shape with a = b = the band -- whose
    diagonal outputs are sums of squares (S = 0 there, so out = -product).
    B in place at the in-core factor's shapes (C = 16,384, B = 256, j0 256,
    8,192 and 16,128); G at phase 7's k-step (R 8,192, P 4,096, k0 0, 4,096
    and 28,672; at k0 0 out is S, bit for bit), its right-looking TRSM (256
    columns of the k-step's output over k = c0 3,840) and its diagonal
    block (a = b = the band, k0 24,576).  Then B and G in float64, the SIMT
    tile, against their twins at 1e-12 x sum|a||b|."""
    from gpis_tpu_torch.linalg import cuda_chol

    dev = gen.device
    c, bw = 16384, 256
    worst_b = 0.0
    mat = torch.randn((c, c), generator=gen, device=dev) / (c // 2) ** 0.5
    for j0 in (256, c // 2, c - bw):
        a, b, s = mat[j0:, :j0], mat[j0:j0 + bw, :j0], mat[j0:, j0:j0 + bw]
        got = cuda_chol.panel_update(mat.clone(), j0, bw)
        want = s.double() - a.double() @ b.double().T
        err, tol = tc_err(got[j0:, j0:j0 + bw], want, a, b.T)
        ulps = 4 * F32_EPS * s.abs().max().item()
        untouched = (torch.equal(got[:j0], mat[:j0]) and torch.equal(got[j0:, :j0], a)
                     and torch.equal(got[j0:, j0 + bw:], mat[j0:, j0 + bw:]))
        rerun = torch.equal(cuda_chol.panel_update(mat.clone(), j0, bw), got)
        del got, want
        check(f"panel_update C={c} j0={j0} B={bw} f32 vs f64 twin "
              f"(tol {TC_TOL} x sum|a||b| + 4 ulp max|S|)", err, tol + ulps)
        if not untouched:
            fail(f"panel_update wrote outside rows >= {j0}, columns [{j0}, {j0 + bw})")
        if not rerun:
            fail(f"panel_update j0={j0}: a rerun gave other bits")
        worst_b = max(worst_b, err)
    del a, b, s
    # The bias gate, a = b: rows [j0, j0 + B) of the panel's product are
    # M[j0:j0+B, :j0] times itself transposed.
    j0 = c // 2
    mat.uniform_(0.0, 1.0, generator=gen)
    mat[:, j0:j0 + bw] = 0.0
    prod = mat[j0:, :j0].double() @ mat[j0:j0 + bw, :j0].double().T
    acc = -cuda_chol.panel_update(mat, j0, bw)[j0:, j0:j0 + bw]
    bias = tc_bias(acc, prod)
    diag = ((acc[:bw].double() - prod[:bw]) / prod[:bw]).diagonal().mean().item()
    check(f"panel_update bias on nonnegative operands, a = b rows, j0={j0} "
          f"(sums of squares on the diagonal: {diag:.3e})", abs(bias), TC_BIAS,
          err_name="|mean rel err|")
    results["panel_update"] = dict(max_abs_err=worst_b)
    del mat, prod, acc
    torch.cuda.empty_cache()

    r, p, wide = 2 * SPILL_PANEL, SPILL_PANEL, 32768
    kmax = wide - p
    cur = torch.randn((r, wide), generator=gen, device=dev) / kmax**0.5
    lk = torch.randn((p, wide), generator=gen, device=dev) / kmax**0.5
    worst_g = 0.0

    def held(what, a, b, s, k0):
        nonlocal worst_g
        got = cuda_chol.gemm_nt_masked(a, b, s, k0)
        want = s.double() - a[:, :k0].double() @ b[:, :k0].double().T
        err, tol = tc_err(got, want, a[:, :k0], b[:, :k0].T)
        ulps = 4 * F32_EPS * s.abs().max().item()
        check(f"gemm_nt_masked {what} k0={k0} f32 vs f64 twin "
              f"(tol {TC_TOL} x sum|a||b| + 4 ulp max|S|)", err, tol + ulps)
        if not torch.equal(cuda_chol.gemm_nt_masked(a, b, s, k0), got):
            fail(f"gemm_nt_masked {what} k0={k0}: a rerun gave other bits")
        worst_g = max(worst_g, err)
        return got

    for k0 in (0, p, kmax):
        got = held(f"k-step R={r} P={p} C={wide}", cur, lk, cur[:, k0:k0 + p], k0)
        if k0 == 0 and not torch.equal(got, cur[:, :p]):
            fail("gemm_nt_masked at k0=0 is not a copy of S")
    # The right-looking TRSM on the last k-step's output: 128 tiles, split.
    c0, blk = 3840, 256
    held(f"TRSM R={r} P={blk}", got, lk[c0:c0 + blk, kmax:], got[:, c0:c0 + blk], c0)
    del got
    j0 = wide - r
    held(f"diagonal block R={r} (a = b)", cur, cur, cur[:, j0:j0 + r], j0)
    # The bias gate at the diagonal block, a = b = the band, S = 0.
    cur.uniform_(0.0, 1.0, generator=gen)
    cur[:, j0:] = 0.0
    acc = -cuda_chol.gemm_nt_masked(cur, cur, cur[:, j0:], j0)
    prod = cur[:, :j0].double() @ cur[:, :j0].double().T
    bias = tc_bias(acc, prod)
    diag = ((acc.double() - prod) / prod).diagonal().mean().item()
    check(f"gemm_nt_masked bias on nonnegative operands, a = b, R={r} k0={j0} "
          f"(sums of squares on the diagonal: {diag:.3e})", abs(bias), TC_BIAS,
          err_name="|mean rel err|")
    results["gemm_nt_masked"] = dict(max_abs_err=worst_g)
    del cur, lk, acc, prod
    torch.cuda.empty_cache()

    # float64, the SIMT tile: B in place, G with a ragged k0.
    n, j0 = 4096, 2048
    m64 = torch.randn((n, n), generator=gen, device=dev, dtype=torch.float64) / j0**0.5
    got = cuda_chol.panel_update(m64.clone(), j0, bw)
    want = cuda_chol.panel_update_reference(m64.clone(), j0, bw)
    scale = (m64[j0:, :j0].abs() @ m64[j0:j0 + bw, :j0].abs().T).max().item()
    check(f"panel_update float64 C={n} j0={j0} (tol 1e-12 x sum|a||b|)",
          (got - want).abs().max().item(), 1e-12 * scale)
    a64, b64 = m64[:2048], m64[2048:3072]
    k0 = 3000
    s64 = m64[:2048, k0:k0 + 1024]
    got = cuda_chol.gemm_nt_masked(a64, b64, s64, k0)
    want = cuda_chol.gemm_nt_masked_reference(a64, b64, s64, k0)
    scale = (a64[:, :k0].abs() @ b64[:, :k0].abs().T).max().item()
    check(f"gemm_nt_masked float64 R={a64.shape[0]} P={b64.shape[0]} k0={k0} "
          "(tol 1e-12 x sum|a||b|)",
          (got - want).abs().max().item(), 1e-12 * scale)
    del m64, got, want
    torch.cuda.empty_cache()


def nt_kernel_times(torch, gen, results: dict) -> None:
    """Kernels B and G timed beside their float32 twins and `addmm`, with
    the bound at the split-TF32 rate: B across j0 at C = 16,384, B = 256
    (the kernels line takes j0 8,192); G at phase 7's k-step (k0 4,096 and
    28,672; the line takes 28,672) and diagonal block (a = b, k0 24,576)."""
    from gpis_tpu_torch.linalg import cuda_chol

    dev = gen.device
    c, bw = 16384, 256
    work = torch.randn((c, c), generator=gen, device=dev) / (c // 2) ** 0.5
    per_j0 = {}
    for j0 in (256, 4096, 8192, 12288, 16128):
        ms = time_ms(torch, lambda: cuda_chol.panel_update(work, j0, bw), 10)
        plain = time_ms(torch, lambda: cuda_chol.panel_update_reference(work, j0, bw), 10)
        lib = time_ms(torch, lambda: torch.addmm(work[j0:, j0:j0 + bw], work[j0:, :j0],
                                                 work[j0:j0 + bw, :j0].T, alpha=-1), 10)
        rows = c - j0
        per_j0[j0] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                          **bound(2 * rows * bw * j0, 4 * (rows * j0 + bw * j0 + 2 * rows * bw),
                                  SPLIT_TF32_FLOPS))
        say(f"  panel_update C={c} B={bw} j0={j0}: kernel {ms:.4f} ms  plain {plain:.4f} ms  "
            f"addmm {lib:.4f} ms  bound {per_j0[j0]['bound_ms']:.4f} ms")
    results["panel_update"].update(per_j0[8192])
    del work
    torch.cuda.empty_cache()

    r, p, wide = 2 * SPILL_PANEL, SPILL_PANEL, 32768
    kmax = wide - p
    cur = torch.randn((r, wide), generator=gen, device=dev) / kmax**0.5
    lk = torch.randn((p, wide), generator=gen, device=dev) / kmax**0.5
    shapes = {}
    j0 = wide - r
    for name, b, k0, cols in ((f"kstep_R{r}_P{p}_k0{p}", lk, p, p),
                              (f"kstep_R{r}_P{p}_k0{kmax}", lk, kmax, p),
                              (f"diag_R{r}_k0{j0}_a_is_b", cur, j0, r)):
        s = cur[:, j0:j0 + cols] if b is cur else cur[:, k0:k0 + cols]
        ms = time_ms(torch, lambda: cuda_chol.gemm_nt_masked(cur, b, s, k0), 3)
        plain = time_ms(torch, lambda: cuda_chol.gemm_nt_masked_reference(cur, b, s, k0), 3)
        lib = time_ms(torch, lambda: torch.addmm(s, cur[:, :k0], b[:, :k0].T, alpha=-1), 3)
        reads = r * k0 + (0 if b is cur else cols * k0)  # a = b is one input
        shapes[name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                            **bound(2 * r * cols * k0, 4 * (reads + 2 * r * cols),
                                    SPLIT_TF32_FLOPS))
        say(f"  gemm_nt_masked {name}: kernel {ms:.4f} ms  plain {plain:.4f} ms  "
            f"addmm {lib:.4f} ms  bound {shapes[name]['bound_ms']:.4f} ms")
    results["gemm_nt_masked"].update(shapes[f"kstep_R{r}_P{p}_k0{kmax}"])
    say(json.dumps({"panel_update_by_j0": per_j0, "gemm_nt_masked_shapes": shapes,
                    "card": card_line()}))
    del cur, lk
    torch.cuda.empty_cache()


def lower_inv(torch, gen, b: int):
    """A B x B V = Ljj^{-1} as the inv option forms it: the inverse of the
    Cholesky factor of a well-conditioned SPD block."""
    g = torch.randn((b, b), generator=gen, device=gen.device)
    ld = torch.linalg.cholesky(g @ g.T / b + torch.eye(b, device=gen.device))
    eye = torch.eye(b, device=gen.device)
    return torch.linalg.solve_triangular(ld, eye, upper=False).contiguous()


# J's panels (R = C - j1 rows below the diagonal block at j0) and K's row
# solves (N = j1 columns) of the in-core factor at C = 16,384, B = 256: the
# first, a middle and the last step of each loop.
INV_J_ROWS = (16128, 8064, 256)
INV_K_COLS = (16384, 8448, 256)


def poisoned_empty(torch, shape, dev, dtype=None):
    """Let the caching allocator's next block of `shape` hold NaN, so that a
    kernel that reads its fresh output before writing it, or leaves an
    element unwritten, shows NaN."""
    torch.full(shape, float("nan"), device=dev, dtype=dtype)


def inv_kernel_checks(torch, gen, results: dict) -> None:
    """Kernels J and K in float32 (the split-TF32 tensor-core tile: J its NT
    layout, K its NN layout, both STORE, each tile over its own triangular k
    range) against their twins run in float64, at the in-core factor's
    shapes (C = 16,384, B = 256; INV_J_ROWS, INV_K_COLS): tol TC_TOL x
    sum|a||b| of the worst output; the output's memory poisoned with NaN
    first (STORE reads none of it), reruns bit-identical; and the bias gate,
    |mean (out - twin) / sum|a||b|| <= TC_BIAS on nonnegative operands (a
    nonnegative lower-triangular V) at the deepest step of each.  Then J and
    K in float64, the SIMT tile, against their twins at 1e-12 x
    sum|a||b|."""
    from gpis_tpu_torch.linalg import cuda_chol

    dev = gen.device
    c, b = 16384, 256
    v = lower_inv(torch, gen, b)
    a = torch.randn((c, c), generator=gen, device=dev)
    worst_j = 0.0
    for r in INV_J_ROWS:
        j0 = c - r - b
        acc = a[j0 + b:, j0:j0 + b]  # the panel below block j0, leading dimension C
        poisoned_empty(torch, (r, b), dev)
        got = cuda_chol.panel_scale(acc, v)
        err, tol = tc_err(got, acc.double() @ v.double().T, acc, v.T)
        check(f"panel_scale R={r} B={b} j0={j0} (a strided view, ld {c}) f32 vs f64 twin "
              f"(tol {TC_TOL} x sum|a||b|)", err, tol)
        if not torch.equal(cuda_chol.panel_scale(acc, v), got):
            fail(f"panel_scale R={r}: a rerun gave other bits")
        worst_j = max(worst_j, err)
    worst_k = 0.0
    for n in INV_K_COLS:
        rhs = torch.randn((b, n), generator=gen, device=dev)  # K's rhs is a fresh (B, j1)
        poisoned_empty(torch, (b, n), dev)
        got = cuda_chol.row_scale(v, rhs)
        err, tol = tc_err(got, v.double() @ rhs.double(), v, rhs)
        check(f"row_scale B={b} N={n} f32 vs f64 twin (tol {TC_TOL} x sum|a||b|)", err, tol)
        if not torch.equal(cuda_chol.row_scale(v, rhs), got):
            fail(f"row_scale N={n}: a rerun gave other bits")
        worst_k = max(worst_k, err)
    # The bias gates: every output a sum of nonnegative products.
    vpos = torch.rand((b, b), generator=gen, device=dev).tril_()
    a.uniform_(0.0, 1.0, generator=gen)
    acc = a[b:, :b]
    bias = tc_bias(cuda_chol.panel_scale(acc, vpos), acc.double() @ vpos.double().T)
    check(f"panel_scale bias on nonnegative operands, R={c - b}", abs(bias), TC_BIAS,
          err_name="|mean rel err|")
    rhs = a[:b]
    bias = tc_bias(cuda_chol.row_scale(vpos, rhs), vpos.double() @ rhs.double())
    check(f"row_scale bias on nonnegative operands, N={c}", abs(bias), TC_BIAS,
          err_name="|mean rel err|")
    results["panel_scale"] = dict(max_abs_err=worst_j)
    results["row_scale"] = dict(max_abs_err=worst_k)
    del a, acc, rhs, got, vpos

    # float64, the SIMT tile, at a ragged shape.
    v64 = lower_inv(torch, gen, b).double()
    a64 = torch.randn((4096, 4096), generator=gen, device=dev, dtype=torch.float64)
    acc64, rhs64 = a64[700:, 300:300 + b], a64[:b, 100:3100]
    for what, got, want, scale in (
            (f"panel_scale float64 R={acc64.shape[0]}", cuda_chol.panel_scale(acc64, v64),
             acc64 @ v64.T, acc64.abs() @ v64.abs().T),
            (f"row_scale float64 N={rhs64.shape[1]}", cuda_chol.row_scale(v64, rhs64),
             v64 @ rhs64, v64.abs() @ rhs64.abs())):
        check(f"{what} B={b} (tol 1e-12 x sum|a||b|)", (got - want).abs().max().item(),
              1e-12 * scale.max().item())
    del a64, acc64, rhs64, v64
    torch.cuda.empty_cache()


def inv_kernel_times(torch, gen, results: dict) -> None:
    """Kernels J and K timed beside their float32 twins and `matmul`, with
    the bound at the split-TF32 rate, at INV_J_ROWS and INV_K_COLS (the
    kernels line takes R 16,128 and N 16,384): the card's time
    (`device_ms`: at R or N 256 the host's enqueue takes longer than the
    kernel), and the host's time per call beside `matmul`'s (`host_us`).  V is lower-triangular: an output of
    column c (J) or row r (K) sums c + 1 (r + 1) products, and V's live half
    is read."""
    from gpis_tpu_torch.linalg import cuda_chol

    dev = gen.device
    c, b = 16384, 256
    v = lower_inv(torch, gen, b)
    a = torch.randn((c, c), generator=gen, device=dev)
    times = {}
    for r in INV_J_ROWS:
        j0 = c - r - b
        acc = a[j0 + b:, j0:j0 + b]
        ms = device_ms(torch, lambda: cuda_chol.panel_scale(acc, v), 20)
        plain = device_ms(torch, lambda: cuda_chol.panel_scale_reference(acc, v), 20)
        lib = device_ms(torch, lambda: torch.matmul(acc, v.T), 20)
        times[f"panel_scale_R{r}"] = dict(
            ms=ms, plain_ms=plain, library_ms=lib,
            host_us=host_us(torch, lambda: cuda_chol.panel_scale(acc, v)),
            library_host_us=host_us(torch, lambda: torch.matmul(acc, v.T)),
            **bound(r * b * (b + 1), 4 * (2 * r * b + b * (b + 1) / 2), SPLIT_TF32_FLOPS))
    del a
    for n in INV_K_COLS:
        rhs = torch.randn((b, n), generator=gen, device=dev)
        ms = device_ms(torch, lambda: cuda_chol.row_scale(v, rhs), 20)
        plain = device_ms(torch, lambda: cuda_chol.row_scale_reference(v, rhs), 20)
        lib = device_ms(torch, lambda: torch.matmul(v, rhs), 20)
        times[f"row_scale_N{n}"] = dict(
            ms=ms, plain_ms=plain, library_ms=lib,
            host_us=host_us(torch, lambda: cuda_chol.row_scale(v, rhs)),
            library_host_us=host_us(torch, lambda: torch.matmul(v, rhs)),
            **bound(n * b * (b + 1), 4 * (2 * b * n + b * (b + 1) / 2), SPLIT_TF32_FLOPS))
    for name, t in times.items():
        say(f"  {name}: kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  "
            f"matmul {t['library_ms']:.4f} ms  bound {t['bound_ms']:.4f} ms ({t['bound_by']}); "
            f"host {t['host_us']:.1f} us a call (matmul {t['library_host_us']:.1f})")
    results["panel_scale"].update(times[f"panel_scale_R{INV_J_ROWS[0]}"])
    results["row_scale"].update(times[f"row_scale_N{INV_K_COLS[0]}"])
    say(json.dumps({"inv_kernel_times": times, "card": card_line()}))
    torch.cuda.empty_cache()


def trail_want(torch, s0, l_col, wj, j0: int, row0: int, b: int):
    """Kernel L's float64 twin, its live block counted here (global rows
    >= j0 + B, columns < j0 + B) rather than by the wrapper's
    `_trail_ranges`: (want, first live row, live columns)."""
    r_b, w = min(max(j0 + b - row0, 0), s0.shape[0]), min(j0 + b, s0.shape[1])
    want = s0.to(torch.float64, copy=True)
    want[r_b:, :w] -= l_col[r_b:].double() @ wj[:, :w].double()
    return want, r_b, w


def inv_and_trail_kernels(torch, gen, results: dict) -> None:
    """J and K (`inv_kernel_checks`), then L at the sharded TRSM's shapes
    (P = 1: R = C = 16,384, B = 256, j0 = 8,192; a P = 4 band at row0 4,096
    whose live block starts inside it): float32 L, the split-TF32 tile's NN
    layout with SUB_FROM in place, against its float64 twin at TC_TOL x
    sum|a||b| of the worst output plus 4 float32 ulps of max|S|, S
    bit-identical outside the live block, the bias gate on nonnegative
    operands; float64 L (the SIMT tile) at 1e-12 x sum|a||b| at a ragged
    shape.  Then L timed beside its float32 twin and `addmm`: the card's
    time (`device_ms`, the kernels line's), CUDA events around back-to-back
    calls, and the host's enqueue."""
    from gpis_tpu_torch.linalg import cuda_chol

    inv_kernel_checks(torch, gen, results)
    dev = gen.device
    c, b = 16384, 256
    ulp = torch.finfo(torch.float32).eps
    s0 = torch.randn((c, c), generator=gen, device=dev)
    l_band = torch.randn((c, c), generator=gen, device=dev) / b**0.5
    wj = torch.randn((b, c), generator=gen, device=dev)
    worst = 0.0
    for j0, row0, rows in ((c // 2, 0, c), (4096, 4096, 4096)):
        l_col = l_band[:rows, j0:j0 + b]  # column panel j of the band, leading dimension C
        w_j = wj.clone()
        w_j[:, j0 + b:] = 0.0  # a lower-triangular W row panel
        s = s0[:rows]
        got = cuda_chol.band_trail(s.clone(), l_col, w_j, j0, row0)
        want, r_b, w = trail_want(torch, s, l_col, w_j, j0, row0, b)
        err, tol = tc_err(got, want, l_col[r_b:], w_j[:, :w])
        untouched = torch.equal(got[:r_b], s[:r_b]) and torch.equal(got[:, w:], s[:, w:])
        del got, want
        check(f"band_trail R={rows} C={c} B={b} j0={j0} row0={row0} f32 vs f64 twin "
              f"(tol {TC_TOL} x sum|a||b| + 4 ulp max|S|)", err,
              tol + 4 * ulp * s.abs().max().item())
        if not untouched:
            fail(f"band_trail (row0 {row0}, j0 {j0}) wrote outside its live rows and columns")
        worst = max(worst, err)
    # The bias gate, S = 0 and nonnegative operands.
    j0 = c // 2
    l_col = torch.rand((c, b), generator=gen, device=dev)
    w_j = torch.rand((b, c), generator=gen, device=dev)
    w_j[:, j0 + b:] = 0.0
    got = -cuda_chol.band_trail(torch.zeros((c, c), device=dev), l_col, w_j, j0, 0)
    bias = tc_bias(got[j0 + b:, :j0 + b], l_col[j0 + b:].double() @ w_j[:, :j0 + b].double())
    check(f"band_trail bias on nonnegative operands, j0={j0}", abs(bias), TC_BIAS,
          err_name="|mean rel err|")
    del got, l_col
    # float64, the SIMT tile: a ragged band (R 3,000 at row0 1,000, B 200).
    s64 = torch.randn((3000, 4000), generator=gen, device=dev, dtype=torch.float64)
    l64 = torch.randn((3000, 4000), generator=gen, device=dev, dtype=torch.float64)[:, 1400:1600]
    w64 = torch.randn((200, 4000), generator=gen, device=dev, dtype=torch.float64)
    w64[:, 1600:] = 0.0
    got = cuda_chol.band_trail(s64.clone(), l64, w64, 1400, 1000)
    want, r_b, w = trail_want(torch, s64, l64, w64, 1400, 1000, 200)
    check("band_trail float64 R=3000 B=200 j0=1400 row0=1000 (tol 1e-12 x sum|a||b|)",
          (got - want).abs().max().item(),
          1e-12 * (l64[r_b:].abs() @ w64[:, :w].abs()).max().item())
    del s64, l64, w64, got, want

    # Timed at P = 1, j0 = 8,192: 7,936 live rows x 8,448 columns, k 256.
    l_col = l_band[:, j0:j0 + b]
    w_j = wj.clone()
    w_j[:, j0 + b:] = 0.0
    r_b, w = j0 + b, j0 + b
    work = s0.clone()
    kernel = lambda: cuda_chol.band_trail(work, l_col, w_j, j0, 0)  # noqa: E731
    lib_fn = lambda: torch.addmm(s0[r_b:, :w], l_col[r_b:], w_j[:, :w], alpha=-1)  # noqa: E731
    ms = device_ms(torch, kernel, 10)
    plain = device_ms(torch, lambda: cuda_chol.band_trail_reference(work, l_col, w_j, j0, 0), 10)
    lib = device_ms(torch, lib_fn, 10)
    rows = c - r_b
    results["band_trail"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain, library_ms=lib,
        events_ms=time_ms(torch, kernel, 10), library_events_ms=time_ms(torch, lib_fn, 10),
        host_us=host_us(torch, kernel, 50), library_host_us=host_us(torch, lib_fn, 50),
        **bound(2 * rows * b * w, 4 * (2 * rows * w + rows * b + b * w), SPLIT_TF32_FLOPS))
    t = results["band_trail"]
    say(f"  band_trail R={c} B={b} j0={j0}: card {ms:.4f} ms (plain {plain:.4f}, addmm "
        f"{lib:.4f}), events {t['events_ms']:.4f} ms (addmm {t['library_events_ms']:.4f}), host "
        f"{t['host_us']:.1f} us a call (addmm {t['library_host_us']:.1f}); bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    del s0, l_band, l_col, wj, w_j, work
    torch.cuda.empty_cache()


def qsplit_problem(torch, dev, m: int):
    """The `_QSPLIT` note's regime (C = 1,024 normal points, noise 1e-3,
    rbf at lengthscale 0.8, where a single-pass bf16 quad measured ~1e-2
    absolute), in float64: x, q (m, 3), W = L^{-1} and alpha."""
    from gpis_tpu_torch.kernels import cuda_gram

    rng = np.random.default_rng(20260818)
    x64 = torch.as_tensor(rng.normal(size=(1024, 3)), device=dev)
    q64 = torch.as_tensor(rng.normal(size=(m, 3)), device=dev)
    y64 = torch.as_tensor(rng.normal(size=1024) * 0.2, device=dev)
    p = {"lengthscale": 0.8, "signal_variance": 1.0}
    k = cuda_gram.cov_reference("rbf", x64, x64, p, noise=torch.full_like(y64, 1e-3), sym=True)
    l64 = torch.linalg.cholesky(k)
    w64 = torch.linalg.solve_triangular(l64, torch.eye(1024, dtype=k.dtype, device=dev),
                                        upper=False).contiguous()
    alpha64 = torch.cholesky_solve(y64[:, None], l64)[:, 0]
    return x64, q64, w64, alpha64, p


def quad_kernel_checks(torch, gen, results: dict) -> None:
    """Kernels D and F against their twins where a fault would show, untimed:
    float32 D on a real 8,192-query kq at C = 4,096; D and F (value) in the
    `_QSPLIT` regime against a float64 plain run of the same GP (2e-3
    absolute, 5x below the single-pass error); D's mean bias on nonnegative
    W and kq (TC_BIAS); F's four modes at ragged shapes (M 129 and 1,000, C
    and R off the 128 tile, a band at row0 700); D, F and F band twice, bit
    for bit; and D, F and F band in float64 (the SIMT bodies) at 1e-10."""
    from gpis_tpu_torch.data.gpis import fibonacci_sphere
    from gpis_tpu_torch.kernels import cuda_joint, cuda_query
    from gpis_tpu_torch.kernels import gram as kg

    del results
    dev = gen.device
    p = {"lengthscale": 0.4, "signal_variance": 1.0}
    x = torch.as_tensor(fibonacci_sphere(4096), dtype=torch.float32, device=dev)
    q = (torch.rand((8192, 3), generator=gen, device=dev) * 3.0 - 1.5).contiguous()
    query_kernel(torch, gen, kg.cross_cov("rbf", q, x, p), None)

    x64, q64, w64, alpha64, pq = qsplit_problem(torch, dev, 8192)
    kq64 = cuda_query.generated_kq("value", "rbf", q64, x64, pq)
    mean_r, quad_r = cuda_query.staged_quad_reference(kq64, w64, alpha64)
    f32 = [t.float().contiguous() for t in (kq64, w64, alpha64, q64, x64)]
    tol_m = 1e-4 * (kq64.abs() @ alpha64.abs()).max().item()
    for route, (mean, quad) in (
            ("staged_quad", cuda_query.staged_quad(*f32[:3])),
            ("fused_quad value", cuda_query.fused_quad("value", "rbf", f32[3], f32[4], pq, f32[2],
                                                       f32[1]))):
        check(f"{route} quad C=1024 noise=1e-3 f32 vs f64", (quad.double() - quad_r).abs().max()
              .item(), 2e-3)
        check(f"{route} mean C=1024 noise=1e-3 f32 vs f64 (tol 1e-4 x sum|kq||alpha|)",
              (mean.double() - mean_r).abs().max().item(), tol_m)
    del kq64, mean_r, quad_r, f32

    # The bias gate: nonnegative W and kq, where truncated steps read low.
    w = torch.tril(torch.rand((4096, 4096), generator=gen, device=dev))
    kq = torch.rand((2048, 4096), generator=gen, device=dev)
    alpha = torch.rand((4096,), generator=gen, device=dev)
    _, quad = cuda_query.staged_quad(kq, w, alpha)
    _, quad_r = cuda_query.staged_quad_reference(kq.double(), w.double(), alpha.double())
    check("staged_quad nonnegative C=4096 M=2048, mean bias (|mean (quad - f64) / f64|)",
          abs(((quad.double() - quad_r) / quad_r).mean().item()), TC_BIAS,
          err_name="bias")
    del w, kq, quad_r

    # F's four modes and D at ragged shapes, float32 against float64 twins,
    # then float64 against float64; each call twice, bit for bit.
    jcols = cuda_joint.pack_meta(cuda_joint.joint_meta(
        torch.as_tensor(fibonacci_sphere(250), dtype=torch.float32, device=dev)))  # J = 1,000
    vcols = x[:1000].contiguous()
    for dtype in (torch.float32, torch.float64):
        tol = QUAD_REL_TOL if dtype == torch.float32 else 1e-10
        t = str(dtype)[6:]
        for kind, cols in (("value", vcols), ("joint", jcols)):
            cols = cols.to(dtype)
            n = cols.shape[0]
            for m in (129, 1000):
                qm = q[:m].to(dtype)
                w = quad_test_w(torch, n, gen).to(dtype)
                alpha = torch.randn((n,), generator=gen, device=dev).to(dtype)
                kq64 = cuda_query.generated_kq(kind, "rbf", qm.double(), cols.double(), p)
                mean_r, quad_r = cuda_query.staged_quad_reference(kq64, w.double(),
                                                                  alpha.double())
                runs = {"fused_quad": lambda: cuda_query.fused_quad(kind, "rbf", qm, cols, p,
                                                                    alpha, w)}
                if kind == "value":
                    kq = kq64.to(dtype)
                    runs["staged_quad"] = lambda: cuda_query.staged_quad(kq, w, alpha)
                for name, run in runs.items():
                    (mean, quad), again = run(), run()
                    shape = f"{t} {kind} M={m} {'C' if kind == 'value' else 'J'}={n}"
                    check(f"{name} {shape} quad, per query", quad_rel_err(torch, quad, quad_r),
                          tol, err_name="max_rel_err")
                    check(f"{name} {shape} mean", (mean.double() - mean_r).abs().max().item(),
                          tol * (kq64.abs() @ alpha.double().abs()).max().item())
                    check(f"{name} {shape} run twice", float(not (
                        torch.equal(mean, again[0]) and torch.equal(quad, again[1]))), 0.0,
                        err_name="bits differ")
            for rows, row0 in ((300, 0), (300, 700), (128, 256)):
                qm = q[:1000].to(dtype)
                w = band_test_w(torch, rows, row0, row0 + rows, gen).to(dtype)
                quad = cuda_query.quad_band(kind, "rbf", qm, cols, p, w, row0)
                quad_r = cuda_query.quad_band_reference(kind, "rbf", qm.double(), cols.double(),
                                                        p, w.double(), row0)
                shape = f"{t} {kind} M=1000 R={rows} row0={row0}"
                check(f"quad_band {shape}, per query", quad_rel_err(torch, quad, quad_r), tol,
                      err_name="max_rel_err")
                check(f"quad_band {shape} run twice", float(not torch.equal(
                    quad, cuda_query.quad_band(kind, "rbf", qm, cols, p, w, row0))), 0.0,
                    err_name="bits differ")


def phase2(torch, results: dict) -> None:
    from gpis_tpu_torch.data.gpis import fibonacci_sphere
    from gpis_tpu_torch.kernels import cuda_gram, cuda_joint, cuda_query
    from gpis_tpu_torch.kernels import gram as kg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    c, m = 16384, 8192
    params = {"lengthscale": 0.4, "signal_variance": 1.0}
    x = torch.as_tensor(fibonacci_sphere(c), dtype=torch.float32, device=dev)
    q = (torch.rand((m, 3), generator=gen, device=dev) * 3.0 - 1.5).contiguous()
    noise = torch.full((c,), 1e-3, device=dev)

    # A: covariance tile.  Values are <= k(0) + noise ~ 1; the two sides
    # differ only by the rounding of r2 and exp (a few ulp): tol 1e-5.
    got = kg.gram("rbf", x, params, noise)
    want = cuda_gram.cov_reference("rbf", x, x, params, noise=noise, sym=True)
    err = (got - want).abs().max().item()
    del got, want
    ms = time_ms(torch, lambda: kg.gram("rbf", x, params, noise), 5)
    plain = time_ms(torch, lambda: cuda_gram.cov_reference("rbf", x, x, params, noise=noise,
                                                           sym=True), 3)
    check(f"cov gram C={c}", err, 1e-5, ms, plain)
    # About ten operations (and one exp) an element; one store an element.
    results["cov"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
                          **bound(10 * c * c, 4 * (c * c + 7 * c)))
    kq = kg.cross_cov("rbf", q, x, params)
    err_x = (kq - cuda_gram.cov_reference("rbf", q, x, params)).abs().max().item()
    ms_x = time_ms(torch, lambda: kg.cross_cov("rbf", q, x, params), 5)
    plain_x = time_ms(torch, lambda: cuda_gram.cov_reference("rbf", q, x, params), 3)
    check(f"cov cross M={m} C={c}", err_x, 1e-5, ms_x, plain_x)
    instances = {"cov_cross": dict(ms=ms_x, plain_ms=plain_x,
                                   **bound(10 * m * c, 4 * (m * c + 3 * m + 3 * c)))}
    for name, ls in (("rbf", 0.8), ("laplace", 0.8), ("inverse_multiquadric", 0.8),
                     ("thin_plate", 2.5)):
        p = {"lengthscale": ls, "signal_variance": 1.1}
        a, b = q[:1024], x[:4096]
        want = cuda_gram.cov_reference(name, a, b, p)
        err_k = (kg.cross_cov(name, a, b, p) - want).abs().max().item()
        check(f"cov {name} 1024x4096 (tol 1e-5 x max|k|)", err_k,
              1e-5 * max(1.0, want.abs().max().item()))

    # D, F and F band checked at their edges (`quad_kernel_checks`: C = 4,096
    # on a real kq, the `_QSPLIT` regime, the bias gate, float64), then D
    # timed at the slice's 16,384 on a real 8,192-query kq chunk.
    quad_kernel_checks(torch, gen, results)
    query_kernel(torch, gen, kq, results)
    del kq

    # E, then F with both generators at the slices' shapes.
    joint_kernel_checks(torch, gen, results)
    instances.update(joint_cov_kernel(torch, gen, q, results))
    value = fused_quad_kernel(torch, gen, q, x, "value")
    joint = fused_quad_kernel(torch, gen, q, cuda_joint.pack_meta(joint_columns(torch, dev)),
                              "joint")
    say(json.dumps({"crossover": {k: {"staged_ms": v["staged_ms"], "onthefly_ms": v["ms"]}
                                  for k, v in (("value_C16384_M8192", value),
                                               ("joint_J21504_M8192", joint))},
                    "card": card_line()}))
    # The kernels line carries the joint instantiation's time (this slice's
    # path) and the worse error of the two.
    results["fused_quad"] = dict(max_abs_err=max(value["max_abs_err"], joint["max_abs_err"]),
                                 ms=joint["ms"], plain_ms=joint["plain_ms"], library_ms=None,
                                 **{k: joint[k] for k in ("bound_ms", "bound_by",
                                                          "bound_rate_tflops")})
    instances["fused_quad_value"] = {k: value[k] for k in ("ms", "plain_ms", "bound_ms",
                                                           "bound_by")}
    say(json.dumps({"instances": instances, "card": card_line()}))
    torch.cuda.empty_cache()
    ooc_kernels(torch, gen, results)
    torch.cuda.empty_cache()
    nn_kernel_checks(torch, gen, results)
    nn_kernel_times(torch, gen, results)
    tc_nn_bits(torch)
    nt_kernel_checks(torch, gen, results)
    nt_kernel_times(torch, gen, results)
    inv_and_trail_kernels(torch, gen, results)
    inv_kernel_times(torch, gen, results)
    torch.cuda.empty_cache()


def phase3(torch, launches) -> dict:
    from gpis_tpu_torch import ModelConfig, ObjectModelSession
    from gpis_tpu_torch.data.gpis import fibonacci_sphere

    # A small float64 session on the card against the CPU path (the port's
    # own plain twins): the 1e-6 parity bar of the CPU tests.
    small = ModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3, n_external=127,
                        n_internal=1, block=128, touch_capacity=0, dtype="float64")
    pts = fibonacci_sphere(896)
    grids = [ObjectModelSession(small, device=d).start(pts).evaluate_grid(24, 1.5)
             for d in ("cuda", "cpu")]
    err = max(np.abs(a - b).max() for a, b in zip(grids[0][:2], grids[1][:2]))
    check("slice float64, C=1024, 24^3 grid, cuda vs cpu (mean and var)", err, 1e-6)

    cfg = ModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3, n_external=127,
                      n_internal=1, block=128, touch_capacity=0, grid_resolution=64,
                      grid_extent=1.5)
    pts = fibonacci_sphere(16256).astype(np.float32)
    big = big_query(torch, pts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.clear()
    sess = ObjectModelSession(cfg, device="cuda").start(pts)
    mean_q, var_q = sess.query(np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [2.0, 0.0, 0.0]]))
    mean, var, _ = sess.evaluate_grid()
    query_s = sess.stats["grid_s"]
    verts, faces, vvar = sess.extract_surface()
    big_mean, big_var, big_s = timed_query(torch, sess, big)
    torch.cuda.synchronize()
    counts = dict(launches)
    say(f"  capacity {sess.model.capacity}, query at centre/surface/outside: "
        f"mean {mean_q.tolist()} var {var_q.tolist()}")
    say(f"  launches in the value slice run: {counts}")
    rmse = surface_rmse(verts)
    finite = bool(np.isfinite(mean).all() and np.isfinite(var).all()
                  and np.isfinite(mean_q).all() and np.isfinite(vvar).all()
                  and np.isfinite(big_mean).all() and np.isfinite(big_var).all())
    fit_s = sess.stats["fit_s"]
    ok = finite and rmse < RMSE_GATE and mean.shape == (64, 64, 64)
    say(json.dumps({
        "value": fit_s + query_s, "fit_s": fit_s, "query_s": query_s, "surface_rmse": rmse,
        "n_train": sess.model.capacity, "n_query": 64**3, "ok": ok,
        "big_query_s": big_s, "n_big_query": BIG_QUERY,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "n_verts": len(verts), "card": card_line(),
    }))
    if not finite:
        fail("NaN or inf in the posterior")
    if not rmse < RMSE_GATE:
        fail(f"surface RMSE {rmse} >= {RMSE_GATE}")
    require_launches(counts, ("cov", "panel_update", "row_update", "staged_quad", "fused_quad"),
                     "value slice")
    agree_with_chunked(torch, sess, big, big_mean, big_var, "value")
    return counts, (cfg, pts, mean, var), fit_s


def big_query(torch, pts) -> np.ndarray:
    """BIG_QUERY world-frame points spread over the cloud's bounding box,
    plus a margin: the size of a 256 x 256 depth image."""
    rng = np.random.default_rng(7)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    pad = 0.25 * (hi - lo)
    return rng.uniform(lo - pad, hi + pad, size=(BIG_QUERY, 3)).astype(np.float32)


def timed_query(torch, sess, pts):
    """sess.query(pts) and its seconds (host clock; query ends in a copy to
    the host, which synchronizes)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean, var = sess.query(pts)
    return mean, var, time.perf_counter() - t0


def require_launches(counts: dict, names, path: str) -> None:
    for name in names:
        if counts.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched by the {path} run")


def agree_with_chunked(torch, sess, pts, mean, var, what: str) -> None:
    """The on-the-fly answer of sess.query(pts) against the chunked staged
    route on the same points.  Both form kq with the same float32
    expressions (for a value query, Kernel E's blend reduces to Kernel F's
    joint generator term by term) and sum it in the same tiling order, so
    they agree bit for bit as compiled today.  The tolerances, 1e-5 x
    sum|kq||alpha| on the mean and 1e-5 x k(0) on the variance, leave room
    only for a compiler contracting the two kernels' arithmetic into FMAs
    differently (Kernel F's own arithmetic is held per query in phase 2)."""
    from gpis_tpu_torch.gp import derivative as gpd
    from gpis_tpu_torch.gp.kinds import model_kind
    from gpis_tpu_torch.kernels import functions as kf
    from gpis_tpu_torch.kernels import gram as kg
    from gpis_tpu_torch.surface import grid

    model = sess.model
    q = sess.frame.to_normalized(torch.as_tensor(pts, device="cuda"))
    mean_c, var_c = (t.cpu().numpy() for t in grid.evaluate_points_chunked(model, q))

    def cross(qc):
        if model_kind(model) == "joint":
            return gpd.joint_cross_value(model, qc)
        return kg.cross_cov(model.kernel, qc, model.x, model.params)

    scale = max((cross(q[i:i + grid.CHUNK]).abs() @ model.alpha.abs()).max().item()
                for i in range(0, q.shape[0], grid.CHUNK))
    k0 = float(kf.k_diag0(model.kernel, model.params))
    check(f"{what} query of {len(pts)} points (on the fly) vs chunked staged: mean "
          f"(tol 1e-5 x sum|kq||alpha|)", float(np.abs(mean - mean_c).max()), 1e-5 * scale)
    check(f"{what} query of {len(pts)} points (on the fly) vs chunked staged: var "
          f"(tol 1e-5 x k(0))", float(np.abs(var - var_c).max()), 1e-5 * k0)


def phase4(torch, launches) -> dict:
    from gpis_tpu_torch import ModelConfig, ObjectModelSession
    from gpis_tpu_torch.data.gpis import fibonacci_sphere
    from gpis_tpu_torch.gp import derivative as gpd

    # A small float64 joint session on the card against the CPU path.
    small = ModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3, n_external=127,
                        n_internal=1, block=128, touch_capacity=128, dtype="float64")
    pts = fibonacci_sphere(384)
    grids = [ObjectModelSession(small, device=d).start(pts, normals=pts).evaluate_grid(16, 1.5)
             for d in ("cuda", "cpu")]
    err = max(np.abs(a - b).max() for a, b in zip(grids[0][:2], grids[1][:2]))
    check("joint slice float64, C=512 J=2176, 16^3 grid, cuda vs cpu (mean and var)", err, 1e-6)

    n, radius, center = JOINT_SPHERE
    center = np.asarray(center, np.float32)
    pts = (fibonacci_sphere(n, radius) + center).astype(np.float32)
    normals = (pts - center) / radius
    cfg = ModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3, n_external=127,
                      n_internal=1, block=128, touch_capacity=256)
    big = big_query(torch, pts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.clear()
    sess = ObjectModelSession(cfg, device="cuda").start(pts, normals=normals)
    mean, var, _ = sess.evaluate_grid()
    query_s = sess.stats["grid_s"]
    verts, faces, vvar = sess.extract_surface(world_frame=False)
    big_mean, big_var, big_s = timed_query(torch, sess, big)
    frame = sess.frame
    c_n = frame.to_normalized(torch.as_tensor(center, device="cuda"))
    r_n = radius / float(frame.scale)
    sel = torch.as_tensor(verts[np.linspace(0, len(verts) - 1, 256).astype(int)],
                          dtype=sess.dtype, device="cuda")
    grad = gpd.predict_gradient(sess.model, sel)
    torch.cuda.synchronize()
    counts = dict(launches)
    say(f"  joint size J {sess.model.chol.shape[0]} (C {sess.model.capacity}, "
        f"T {sess.model.touch_capacity}); launches in the joint slice run: {counts}")
    radial = sel - c_n
    cos = torch.sum(grad * radial, dim=1) / (grad.norm(dim=1) * radial.norm(dim=1))
    min_cos = cos.min().item()
    rad = np.linalg.norm(verts - c_n.cpu().numpy(), axis=1) - r_n
    rmse = float(np.sqrt(np.mean(rad**2))) if len(verts) else float("nan")
    finite = bool(np.isfinite(mean).all() and np.isfinite(var).all() and np.isfinite(vvar).all()
                  and np.isfinite(big_mean).all() and np.isfinite(big_var).all()
                  and torch.isfinite(grad).all().item())
    fit_s = sess.stats["fit_s"]
    ok = finite and rmse < RMSE_GATE and min_cos > COS_GATE and mean.shape == (64, 64, 64)
    say(json.dumps({
        "joint": True, "value": fit_s + query_s, "fit_s": fit_s, "query_s": query_s,
        "surface_rmse": rmse, "min_normal_cos": min_cos, "n_surface": n,
        "joint_size": sess.model.chol.shape[0], "n_query": 64**3, "ok": ok,
        "big_query_s": big_s, "n_big_query": BIG_QUERY,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "n_verts": len(verts), "card": card_line(),
    }))
    if not finite:
        fail("NaN or inf in the joint posterior")
    if not rmse < RMSE_GATE:
        fail(f"joint surface RMSE {rmse} >= {RMSE_GATE}")
    if not min_cos > COS_GATE:
        fail(f"min cos(normal, radial) {min_cos} <= {COS_GATE}")
    require_launches(counts, ("joint_cov", "fused_quad", "staged_quad", "panel_update",
                              "row_update"), "joint slice")
    agree_with_chunked(torch, sess, big, big_mean, big_var, "joint")
    return counts, (cfg, pts, normals, mean, var)


OOC_KERNELS = ("gemm_nt_masked", "gemm_nn_acc_masked", "stripe_write", "quad_band")


def small_ooc_parity(normals: bool) -> None:
    """A small float64 out-of-core session on the card against the CPU path
    (the port's plain twins) at 1e-6: value C = 1,024 (panel 256), or joint
    J = 2,048 (panel 256)."""
    from gpis_tpu_torch import ModelConfig, ObjectModelSession
    from gpis_tpu_torch.data.gpis import fibonacci_sphere

    small = ModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3, n_external=127,
                        n_internal=1, block=128, dtype="float64")
    pts = fibonacci_sphere(384 if normals else 896)
    kw = {"normals": pts} if normals else {}
    sessions = [ObjectModelSession(small, device=d).start(pts, out_of_core=True, **kw)
                for d in ("cuda", "cpu")]
    grids = [s.evaluate_grid(24, 1.5) for s in sessions]
    err = max(np.abs(a - b).max() for a, b in zip(grids[0][:2], grids[1][:2]))
    what = "joint J=2048" if normals else "value C=1024"
    check(f"out-of-core {what} (panel {sessions[0].model.panel}) float64, 24^3 grid, "
          "cuda vs cpu (mean and var)", err, 1e-6)


def ooc_session_phase(torch, launches, incore, normals: bool) -> dict:
    """The out-of-core slice through ObjectModelSession.start(out_of_core=True)
    on an in-core phase's cloud, held to that phase's grid."""
    from gpis_tpu_torch import ObjectModelSession

    small_ooc_parity(normals)
    if normals:
        cfg, pts, nrm, in_mean, in_var = incore
        kw = {"normals": nrm}
    else:
        cfg, pts, in_mean, in_var = incore
        kw = {}
    big = big_query(torch, pts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.clear()
    sess = ObjectModelSession(cfg, device="cuda").start(pts, out_of_core=True, **kw)
    mean, var, _ = sess.evaluate_grid()
    query_s = sess.stats["grid_s"]
    verts, faces, vvar = sess.extract_surface(world_frame=False)
    big_mean, big_var, big_s = timed_query(torch, sess, big)
    torch.cuda.synchronize()
    counts = dict(launches)
    model = sess.model
    what = "joint" if normals else "value"
    say(f"  out-of-core {what}: factor size {model.alpha.shape[0]}, panel {model.panel}; "
        f"launches in the run: {counts}")
    if normals:  # phase 4's sphere: centre and radius in the normalized frame
        n, radius, center = JOINT_SPHERE
        c_n = sess.frame.to_normalized(torch.as_tensor(np.asarray(center, np.float32),
                                                       device="cuda")).cpu().numpy()
        rad = np.linalg.norm(verts - c_n, axis=1) - radius / float(sess.frame.scale)
    else:
        rad = np.linalg.norm(sess.frame.to_world(torch.as_tensor(verts, device="cuda"))
                             .cpu().numpy(), axis=1) - 1.0
    rmse = float(np.sqrt(np.mean(rad**2))) if len(verts) else float("nan")
    gap_mean = float(np.abs(mean - in_mean).max())
    gap_var = float(np.abs(var - in_var).max())
    finite = bool(np.isfinite(mean).all() and np.isfinite(var).all() and np.isfinite(vvar).all()
                  and np.isfinite(big_mean).all() and np.isfinite(big_var).all())
    fit_s = sess.stats["fit_s"]
    ok = finite and rmse < RMSE_GATE and max(gap_mean, gap_var) < OOC_GRID_GAP
    say(json.dumps({
        "out_of_core": what, "value": fit_s + query_s, "fit_s": fit_s, "query_s": query_s,
        "big_query_s": big_s, "n_big_query": BIG_QUERY, "surface_rmse": rmse,
        "grid_gap_mean": gap_mean, "grid_gap_var": gap_var, "factor_size": model.alpha.shape[0],
        "panel": model.panel, "n_query": 64**3, "ok": ok,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "n_verts": len(verts), "card": card_line(),
    }))
    if not finite:
        fail(f"NaN or inf in the out-of-core {what} posterior")
    if not rmse < RMSE_GATE:
        fail(f"out-of-core {what} surface RMSE {rmse} >= {RMSE_GATE}")
    check(f"out-of-core {what} 64^3 grid against the in-core grid: mean", gap_mean, OOC_GRID_GAP)
    check(f"out-of-core {what} 64^3 grid against the in-core grid: var", gap_var, OOC_GRID_GAP)
    require_launches(counts, ("joint_cov" if normals else "gram_band",) + OOC_KERNELS,
                     f"out-of-core {what}")
    return counts


def phase7(torch, launches) -> dict:
    """The host spill: ooc_fit straight on a training set, tiered store held
    to SPILL_BUDGET bytes of device memory, then a 65,536-point query."""
    from gpis_tpu_torch import ModelConfig
    from gpis_tpu_torch.data import gpis
    from gpis_tpu_torch.data.gpis import fibonacci_sphere
    from gpis_tpu_torch.gp import regression
    from gpis_tpu_torch.kernels import functions as kf
    from gpis_tpu_torch.linalg import outofcore as ooc
    from gpis_tpu_torch.surface import grid

    cfg = ModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3, n_external=127,
                      n_internal=1, block=128, touch_capacity=0)
    pts = fibonacci_sphere(SPILL_N).astype(np.float32)
    ts = gpis.build_training_set(pts, cfg, device="cuda")
    params = kf.kernel_params(cfg.lengthscale, cfg.signal_variance)
    q = ts.frame.to_normalized(torch.as_tensor(big_query(torch, pts), device="cuda"))
    c = ts.x.shape[0]
    reserve = int((3 + 4.5) * SPILL_PANEL * c * 4) + 500_000_000  # ooc_fit's sweep 2, TRSM 2
    torch.cuda.synchronize()
    ooc.TRAFFIC.clear()
    torch.cuda.reset_peak_memory_stats()
    launches.clear()
    t0 = time.perf_counter()
    model = ooc.ooc_fit(cfg.kernel, ts.x, ts.y, ts.noise, params, panel=SPILL_PANEL,
                        store="tiered", device_budget=SPILL_BUDGET, pad_noise=cfg.pad_noise)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mean, var = ooc.ooc_predict(model, q)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    counts = dict(launches)
    traffic = dict(ooc.TRAFFIC)
    spilled = model.wstore.spilled()
    mean, var = mean.cpu().numpy(), var.cpu().numpy()
    jitter = float(model.noise[0] - ts.noise[0])  # what the ladder added to the diagonal
    del model
    torch.cuda.empty_cache()
    # The in-core float32 fit of the same set, for its jitter and its gap to
    # float64 (printed, not gated: the gates hold the out-of-core fit).
    ref32 = regression.fit_inference(cfg.kernel, ts.x, ts.y, ts.noise, params, block=cfg.block,
                                     pad_noise=cfg.pad_noise)
    jitter32 = float(ref32.noise[0] - ts.noise[0])
    mean32, var32 = (t.cpu().numpy() for t in grid.evaluate_points_chunked(ref32, q))
    del ref32
    torch.cuda.empty_cache()
    ref = regression.fit_inference(cfg.kernel, ts.x.double(), ts.y.double(), ts.noise.double(),
                                   params, block=cfg.block, pad_noise=cfg.pad_noise)
    ref_jitter = float(ref.noise[0] - ts.noise[0].double())
    rmean, rvar = (t.cpu().numpy() for t in grid.evaluate_points_chunked(ref, q.double()))
    del ref
    torch.cuda.empty_cache()
    gap_mean, gap_var = float(np.abs(mean - rmean).max()), float(np.abs(var - rvar).max())
    gap32_mean = float(np.abs(mean32 - rmean).max())
    gap32_var = float(np.abs(var32 - rvar).max())
    finite = bool(np.isfinite(mean).all() and np.isfinite(var).all())
    say(f"  host spill: C {c}, panel {SPILL_PANEL}, W panels spilled {spilled}; "
        f"launches {counts}")
    say(json.dumps({
        "out_of_core": "host_spill", "fit_s": t1 - t0, "big_query_s": t2 - t1,
        "n_big_query": BIG_QUERY, "capacity": c, "panel": SPILL_PANEL,
        "device_budget_bytes": SPILL_BUDGET, "w_panels_spilled": spilled,
        "h2d_bytes": traffic.get("h2d_bytes", 0), "d2h_bytes": traffic.get("d2h_bytes", 0),
        "max_memory_allocated_bytes": peak, "peak_bound_bytes": SPILL_BUDGET + reserve,
        "gap_mean": gap_mean, "gap_var": gap_var, "jitter": jitter,
        "reference_jitter_float64": ref_jitter, "incore_float32_jitter": jitter32,
        "incore_float32_gap_mean": gap32_mean, "incore_float32_gap_var": gap32_var,
        "card": card_line(),
    }))
    if not finite:
        fail("NaN or inf in the host-spill posterior")
    if not spilled:
        fail("the 1 GB budget spilled no W panel")
    check("host spill: peak device memory against budget + reserve", peak,
          SPILL_BUDGET + reserve, err_name="bytes")
    check("host spill: query against in-core float64 fit_inference: mean", gap_mean,
          OOC_GRID_GAP)
    check("host spill: query against in-core float64 fit_inference: var", gap_var, OOC_GRID_GAP)
    require_launches(counts, ("gram_band", "panel_update") + OOC_KERNELS, "host spill")
    return counts


def surface_rmse(verts_world: np.ndarray) -> float:
    """RMSE of the surface's distance from the unit sphere (world frame)."""
    if not len(verts_world):
        return float("nan")
    return float(np.sqrt(np.mean((np.linalg.norm(verts_world, axis=1) - 1.0) ** 2)))


def grid_gap_checks(what: str, mean, var, in_mean, in_var) -> tuple[float, float]:
    gap_mean = float(np.abs(mean - in_mean).max())
    gap_var = float(np.abs(var - in_var).max())
    check(f"{what} 64^3 grid against phase 3's: mean", gap_mean, OOC_GRID_GAP)
    check(f"{what} 64^3 grid against phase 3's: var", gap_var, OOC_GRID_GAP)
    return gap_mean, gap_var


def factor_residuals(torch, a, panel_solve: str) -> tuple[float, float]:
    """max|L L^T - A| and max|W L - I| of the in-core factor and TRSM on
    Gram a through one panel_solve route."""
    from gpis_tpu_torch.linalg import cuda_chol

    l = cuda_chol.blocked_cholesky(a.clone(), 256, panel_solve=panel_solve)
    res_l = (l @ l.T - a).abs().max().item()
    w = cuda_chol.blocked_linv(l, 256, panel_solve=panel_solve)
    wl = w @ l
    del w
    wl.diagonal().sub_(1.0)
    res_w = wl.abs().max().item()
    del l, wl
    torch.cuda.empty_cache()
    return res_l, res_w


def phase_inv(torch, launches, incore, fit_s_default) -> dict:
    """Phase 3's value session with `panel_solve="inv"` (the module default
    set for the run, as GPIS_PANEL_SOLVE=inv sets it at import)."""
    from gpis_tpu_torch import ObjectModelSession
    from gpis_tpu_torch.gp import regression
    from gpis_tpu_torch.kernels import functions as kf
    from gpis_tpu_torch.kernels import gram as kg
    from gpis_tpu_torch.linalg import cuda_chol

    cfg, pts, in_mean, in_var = incore
    default = cuda_chol.PANEL_SOLVE
    torch.cuda.synchronize()
    launches.clear()
    cuda_chol.PANEL_SOLVE = "inv"
    try:
        sess = ObjectModelSession(cfg, device="cuda").start(pts)
        mean, var, _ = sess.evaluate_grid()
        verts, faces, vvar = sess.extract_surface()
        torch.cuda.synchronize()
    finally:
        cuda_chol.PANEL_SOLVE = default
    counts = dict(launches)
    fit_s, query_s = sess.stats["fit_s"], sess.stats["grid_s"]
    say(f"  inv route: capacity {sess.model.capacity}; launches {counts}")
    rmse = surface_rmse(verts)
    finite = bool(np.isfinite(mean).all() and np.isfinite(var).all() and np.isfinite(vvar).all())
    if not finite:
        fail("NaN or inf in the inv route's posterior")
    if not rmse < RMSE_GATE:
        fail(f"inv route surface RMSE {rmse} >= {RMSE_GATE}")
    gap_mean, gap_var = grid_gap_checks("inv route", mean, var, in_mean, in_var)
    require_launches(counts, ("cov", "panel_update", "row_update", "panel_scale", "row_scale",
                              "staged_quad"), "inv route")

    # Residuals on phase 3's Gram (the noise the session's ladder settled on).
    ts = sess.training
    params = kf.kernel_params(cfg.lengthscale, cfg.signal_variance)
    noise = sess.model.noise
    del sess
    torch.cuda.empty_cache()
    a = kg.gram(cfg.kernel, ts.x, params, noise=noise)
    res = {ps: factor_residuals(torch, a, ps) for ps in ("xla", "inv")}
    del a
    torch.cuda.empty_cache()
    say(f"  residuals on phase 3's Gram: {res}")
    for i, what in enumerate(("|L L^T - A|", "|W L - I|")):
        check(f"inv route {what} against 8 x the substitution route's + 2e-4", res["inv"][i],
              8.0 * res["xla"][i] + 2e-4)

    # fit_inference on the training set, both routes in turns.
    fits = []
    for ps in ("xla", "inv", "inv", "xla"):
        cuda_chol.PANEL_SOLVE = ps
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = regression.fit_inference(cfg.kernel, ts.x, ts.y, ts.noise, params,
                                             block=cfg.block, pad_noise=cfg.pad_noise)
            torch.cuda.synchronize()
            fits.append((ps, time.perf_counter() - t0))
            del model
        finally:
            cuda_chol.PANEL_SOLVE = default
    say(json.dumps({
        "panel_solve": "inv", "fit_s": fit_s, "fit_s_phase3_xla": fit_s_default,
        "query_s": query_s, "surface_rmse": rmse, "grid_gap_mean": gap_mean,
        "grid_gap_var": gap_var, "residual_llt_xla": res["xla"][0],
        "residual_llt_inv": res["inv"][0], "residual_wl_xla": res["xla"][1],
        "residual_wl_inv": res["inv"][1],
        "fit_inference_s_in_turns": [[ps, s] for ps, s in fits], "card": card_line(),
    }))
    return counts


def phase_sharded(torch, launches, incore) -> dict:
    """The row-sharded pipeline on a one-rank NCCL group at phase 3's
    training set: the JAX package's `bench/run_tpu.py --stages sharded1`."""
    import os
    import tempfile

    import torch.distributed as dist

    from gpis_tpu_torch.data import gpis
    from gpis_tpu_torch.gp import regression
    from gpis_tpu_torch.gp.sharded_model import fit_sharded
    from gpis_tpu_torch.kernels import functions as kf
    from gpis_tpu_torch.linalg import sharded
    from gpis_tpu_torch.surface import grid, marching

    cfg, pts, in_mean, in_var = incore
    store = tempfile.mkdtemp(prefix="gpis_nccl_")
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(store, 'store')}",
                            rank=0, world_size=1)
    try:
        # NCCL builds its communicator at the first collective: once a
        # process, so it is timed apart from the fit.
        t_init = time.perf_counter()
        dist.all_reduce(torch.zeros((1,), device="cuda"))
        torch.cuda.synchronize()
        nccl_init_s = time.perf_counter() - t_init
        ts = gpis.build_training_set(pts, cfg, device="cuda")
        params = kf.kernel_params(cfg.lengthscale, cfg.signal_variance)
        big = ts.frame.to_normalized(torch.as_tensor(big_query(torch, pts), device="cuda"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches.clear()
        t0 = time.perf_counter()
        model = fit_sharded(cfg.kernel, ts.x, ts.y, ts.noise, params, n_devices=1, block=256,
                            touch_capacity=cfg.touch_capacity, pad_noise=cfg.pad_noise)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        w_l = sharded.sharded_linv(model.l, model.mesh, block=256, use_kernel=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        w_gap = ((w_l - model.w).abs().max() / model.w.abs().max()).item()
        model.w = w_l
        mean, var, axis = (t.cpu().numpy() for t in grid.evaluate_grid(model, 64, 1.5))
        t3 = time.perf_counter()
        verts, faces = marching.marching_tetrahedra(mean, axis)
        verts_n = torch.as_tensor(verts.astype(np.float32), device="cuda")
        vvar = grid.evaluate_points_chunked(model, verts_n)[1].cpu().numpy()
        verts_w = ts.frame.to_world(verts_n).cpu().numpy()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        big_mean, big_var = (t.cpu().numpy() for t in regression.predict(model, big))
        t5 = time.perf_counter()
        counts = dict(launches)
        peak = torch.cuda.max_memory_allocated()
        say(f"  sharded P=1: capacity {model.capacity}, backend {model.mesh.backend}; "
            f"launches {counts}")
        # The trailing update with and without Kernel L, in turns (not counted).
        trsm = []
        for use_kernel in (False, True, True, False):
            torch.cuda.synchronize()
            t_a = time.perf_counter()
            w = sharded.sharded_linv(model.l, model.mesh, block=256, use_kernel=use_kernel)
            torch.cuda.synchronize()
            trsm.append(("kernel_L" if use_kernel else "addmm", time.perf_counter() - t_a))
            del w
        capacity = model.capacity
        del model, w_l
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    rmse = surface_rmse(verts_w)
    finite = bool(np.isfinite(mean).all() and np.isfinite(var).all() and np.isfinite(vvar).all()
                  and np.isfinite(big_mean).all() and np.isfinite(big_var).all())
    say(json.dumps({
        "sharded": "P=1 nccl", "nccl_init_s": nccl_init_s, "fit_s": t1 - t0,
        "linv_kernel_L_s": t2 - t1,
        "query_s": t3 - t2, "surface_s": t4 - t3, "big_query_s": t5 - t4,
        "n_big_query": BIG_QUERY, "surface_rmse": rmse, "capacity": capacity,
        "w_gap_rel": w_gap, "max_memory_allocated_bytes": peak,
        "sharded_linv_s_in_turns": [[k, s] for k, s in trsm], "card": card_line(),
    }))
    if not finite:
        fail("NaN or inf in the sharded posterior")
    if not rmse < RMSE_GATE:
        fail(f"sharded surface RMSE {rmse} >= {RMSE_GATE}")
    check("sharded W through Kernel L against the plain W (relative to max|W|)", w_gap,
          SHARDED_W_GAP)
    grid_gap_checks("sharded P=1", mean, var, in_mean, in_var)
    require_launches(counts, ("gram_band", "gemm_nt_masked", "band_trail", "cov", "quad_band"),
                     "sharded P=1")
    return counts


TOUCH_BATCH = 64  # contacts a session.update call: one tactile sweep
TOUCH_CAPACITY = 256  # phase 10's value sessions: n0 16,384, capacity 17,408
SURFACE_F_TOL = 1e-5  # |f| at every surface_points point
SURFACE_CONVERGED = 0.95  # the share of surface_points seeds that must converge
TOUCH_MEAN_TOL = 1e-3  # |mean - target| at a touched point
# The joint refit's float32 variance at the touched points against float64:
# 1.66e-4 read on an H100, about 3x under the gate; a refit that left the
# touches out reads its prior's gap, ~1.8e-2 (printed beside it each run).
REFIT_VAR_GAP = 5e-4
CAP_Z = 0.8  # phase 10's clouds leave out the cap z > 0.8 of their sphere; the touches go there


def capped_sphere(n: int, radius: float = 1.0, center=(0.0, 0.0, 0.0)) -> np.ndarray:
    """n Fibonacci points of a sphere at phase 3's spacing with its cap
    z > CAP_Z (in units of the radius) left out: the part of the object the
    camera did not see, where the fingers go.  The cap holds a tenth of a
    Fibonacci sphere's points, the first tenth of its order."""
    from gpis_tpu_torch.data.gpis import fibonacci_sphere

    total = round(n / (1.0 - (1.0 - CAP_Z) / 2.0))
    pts = fibonacci_sphere(total)
    pts = pts[pts[:, 2] <= CAP_Z][-n:]
    if len(pts) != n:
        fail(f"capped_sphere: {len(pts)} points below the cap, not {n}")
    return (np.asarray(center) + radius * pts).astype(np.float32)


def touch_batches(rng, n_batches: int, center, radius: float) -> list:
    """n_batches of TOUCH_BATCH contacts spread uniformly over the cap
    z > CAP_Z of a sphere (world frame)."""
    k = n_batches * TOUCH_BATCH
    z = rng.uniform(CAP_Z, 1.0, size=k)
    phi = rng.uniform(0.0, 2.0 * np.pi, size=k)
    s = np.sqrt(1.0 - z * z)
    d = np.stack([s * np.cos(phi), s * np.sin(phi), z], axis=1)
    pts = (np.asarray(center) + radius * d).astype(np.float32)
    return [pts[i * TOUCH_BATCH:(i + 1) * TOUCH_BATCH] for i in range(n_batches)]


def observed_touches(rng, center, radius: float) -> np.ndarray:
    """TOUCH_BATCH contacts spread uniformly over the observed part z <= CAP_Z
    of a sphere (world frame): the common case of touching again."""
    z = rng.uniform(-1.0, CAP_Z, size=TOUCH_BATCH)
    phi = rng.uniform(0.0, 2.0 * np.pi, size=TOUCH_BATCH)
    s = np.sqrt(1.0 - z * z)
    d = np.stack([s * np.cos(phi), s * np.sin(phi), z], axis=1)
    return (np.asarray(center) + radius * d).astype(np.float32)


def timed_updates(torch, update, batches) -> list:
    """Each batch's update and its host seconds (the update ends in a
    synchronize)."""
    times = []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        update(b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def touched_checks(what: str, var0, mean, var) -> dict:
    """The JAX tests' gate at every touched point: the variance fell and the
    mean (unless None) sits at the target (0, the surface)."""
    fell = bool(np.all(var < var0))
    rise = var - var0
    say(f"  {what}: at {len(var)} touched points variance fell everywhere: {fell} "
        f"(before max {float(var0.max()):.3e}, min {float(var0.min()):.3e}; after max "
        f"{float(var.max()):.3e}; {int((rise >= 0).sum())} rose, by at most "
        f"{float(rise.max()):.3e}, where it was {float(var0[np.argmax(rise)]):.3e})")
    if not fell:
        fail(f"{what}: the variance did not fall at every touched point")
    out = {"touched_var_max": float(var.max())}
    if mean is not None:
        out["touched_mean_gap"] = float(np.abs(mean).max())
        check(f"{what}: |mean - target| at the touched points", out["touched_mean_gap"],
              TOUCH_MEAN_TOL)
    return out


def small_update_parity() -> None:
    """Small float64 sessions on the card, updated with the same touches as
    the CPU path and held to it at 1e-6: value (C = 1,152, with W; then
    surface_points), joint (J = 2,176: two bordering batches, then the
    overflow refit) and out of core (C = 1,024, panel 256)."""
    from gpis_tpu_torch import ModelConfig, ObjectModelSession
    from gpis_tpu_torch.data.gpis import fibonacci_sphere

    small = ModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3, n_external=127,
                        n_internal=1, block=128, touch_capacity=128, dtype="float64")
    batches = touch_batches(np.random.default_rng(11), 3, (0.0, 0.0, 0.0), 1.0)
    for what, n, normals, out_of_core, n_batches in (
            ("value C=1152", 896, False, False, 2),
            ("joint J=2176 (border, border, refit)", 384, True, False, 3),
            ("out-of-core value C=1024", 896, False, True, 2)):
        pts = fibonacci_sphere(n)
        kw = {"normals": pts} if normals else {}
        sessions = [ObjectModelSession(small, device=d).start(pts, out_of_core=out_of_core, **kw)
                    for d in ("cuda", "cpu")]
        for s in sessions:
            for b in batches[:n_batches]:
                s.update(b.astype(np.float64))
        grids = [s.evaluate_grid(16, 1.5) for s in sessions]
        err = max(np.abs(a - b).max() for a, b in zip(grids[0][:2], grids[1][:2]))
        check(f"updated {what} float64, 16^3 grid, cuda vs cpu (mean and var)", err, 1e-6)
        if what.startswith("value"):
            (p_c, ok_c), (p_h, ok_h) = (s.surface_points(n=64) for s in sessions)
            if not np.array_equal(ok_c, ok_h):
                fail("surface_points converged masks differ between cuda and cpu")
            check("surface_points float64, 64 seeds, cuda vs cpu", float(np.abs(p_c - p_h).max()),
                  1e-6)


def value_float64(cfg, pts, batches, seen):
    """Phase 10's value session in float64 on the card: the variance at the
    observed touches `seen` after the fit, and before and after their own
    batch (which follows `batches`), with the mean after it."""
    import dataclasses

    from gpis_tpu_torch import ObjectModelSession

    sess = ObjectModelSession(dataclasses.replace(cfg, dtype="float64"), device="cuda")
    sess.start(pts.astype(np.float64))
    var_fit = sess.query(seen)[1]
    for b in batches:
        sess.update(b.astype(np.float64))
    var0 = sess.query(seen)[1]
    sess.update(seen.astype(np.float64))
    mean, var = sess.query(seen)
    return var_fit, var0, mean, var


def joint_refit_float64(cfg4, jpts, normals, batches, touched):
    """Phase 10's joint session in float64 on the card: the variance at the
    touched points before the updates and after the last batch's refit."""
    import dataclasses

    from gpis_tpu_torch import ObjectModelSession

    sess = ObjectModelSession(dataclasses.replace(cfg4, dtype="float64"), device="cuda")
    sess.start(jpts.astype(np.float64), normals=normals.astype(np.float64))
    var0 = sess.query(touched)[1]
    for b in batches:
        sess.update(b.astype(np.float64))
    if sess.model.n_touch != 0:
        fail("the float64 joint session did not take the refit path")
    return var0, sess.query(touched)[1]


def phase10(torch, launches, cfg3, cfg4) -> dict:
    """Tactile updates and surface projection at full width, through the
    entry points a user calls: phase 3's configuration with 256 touch slots
    (capacity 17,408), phase 4's joint session to its overflow refit,
    phases 5-6's out-of-core sessions and phase 9's one-rank sharded model.
    The clouds are phases 3-4's spheres at the same point counts with the
    cap z > CAP_Z left out, and the touches fall on that cap, but for one
    value batch on the observed part: where the cloud is dense a touch
    moves the float32 variance by less than its rounding (the touch noise
    is floored at 4 eps C k(0), ~8e-3 here).  The launches are counted over
    the float32 sessions only; the float64 runs that hold them follow."""
    import dataclasses
    import os
    import tempfile

    import torch.distributed as dist

    from gpis_tpu_torch import ObjectModelSession
    from gpis_tpu_torch.data import gpis
    from gpis_tpu_torch.gp import derivative as gpd
    from gpis_tpu_torch.gp import regression
    from gpis_tpu_torch.gp.sharded_model import fit_sharded
    from gpis_tpu_torch.kernels import functions as kf
    from gpis_tpu_torch.surface import grid, marching

    small_update_parity()
    cfg = dataclasses.replace(cfg3, touch_capacity=TOUCH_CAPACITY)
    pts = capped_sphere(16256)
    n_j, radius, center = JOINT_SPHERE
    jpts = capped_sphere(n_j, radius, center)
    normals = (jpts - np.asarray(center, np.float32)) / radius
    rng = np.random.default_rng(10)
    value_touch = touch_batches(rng, 4, (0.0, 0.0, 0.0), 1.0)
    seen = observed_touches(np.random.default_rng(12), (0.0, 0.0, 0.0), 1.0)
    big = big_query(torch, pts)
    out: dict = {"card": card_line()}
    torch.cuda.synchronize()
    launches.clear()

    # Value, in core: four batches into the 1,024 slots.
    t0 = time.perf_counter()
    sess = ObjectModelSession(cfg, device="cuda").start(pts)
    out["value_fit_s"] = time.perf_counter() - t0
    touched = np.concatenate(value_touch)
    _, var0 = sess.query(touched)
    var_fit_seen = sess.query(seen)[1]
    updates = timed_updates(torch, sess.update, value_touch[:2])
    grid2 = sess.evaluate_grid()[:2]  # the out-of-core and sharded runs' touches
    updates += timed_updates(torch, sess.update, value_touch[2:])
    mean_t, var_t = sess.query(touched)
    out["value"] = {"capacity": sess.model.capacity, "n0": sess.model.n0,
                    "n_touch": sess.model.n_touch, "update_s": updates,
                    **touched_checks("value in core", var0, mean_t, var_t)}
    big_mean, big_var, out["value"]["big_query_s"] = timed_query(torch, sess, big)
    mean, var, axis = sess.evaluate_grid()
    out["value"]["query_s"] = sess.stats["grid_s"]
    verts, _ = marching.marching_tetrahedra(mean, axis)
    verts_w = sess.frame.to_world(torch.as_tensor(verts, device="cuda")).cpu().numpy()
    out["value"]["surface_rmse"] = surface_rmse(verts_w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    surf, ok = sess.surface_points(n=256)
    out["value"]["surface_points_s"] = time.perf_counter() - t0
    f_surf = float(np.abs(sess.query(surf)[0]).max()) if len(surf) else float("nan")
    out["value"]["surface_points_converged"] = float(ok.mean())
    out["value"]["surface_points_max_abs_f"] = f_surf
    # One more batch on the observed part of the surface, where a float32
    # touch moves the variance by less than its rounding: held below, after
    # the counted run, to the quad's error against float64.
    var_seen0 = sess.query(seen)[1]
    out["value"]["observed_update_s"] = timed_updates(torch, sess.update, [seen])[0]
    mean_seen, var_seen = sess.query(seen)
    finite = [np.isfinite(a).all() for a in (mean, var, big_mean, big_var, mean_t, var_t, surf,
                                             mean_seen, var_seen)]
    del sess
    torch.cuda.empty_cache()

    # Out of core, value: phase 5's cloud and panel, two batches into the tail.
    sess = ObjectModelSession(cfg, device="cuda").start(pts, out_of_core=True)
    touched2 = np.concatenate(value_touch[:2])
    _, var0 = sess.query(touched2)
    updates = timed_updates(torch, sess.update, value_touch[:2])
    mean_t, var_t = sess.query(touched2)
    out["ooc_value"] = {"n_tail": sess.model.n_tail, "update_s": updates,
                        **touched_checks("out-of-core value", var0, mean_t, var_t)}
    big_mean, big_var, out["ooc_value"]["big_query_s"] = timed_query(torch, sess, big)
    mean, var, axis = sess.evaluate_grid()
    out["ooc_value"]["query_s"] = sess.stats["grid_s"]
    verts, _ = marching.marching_tetrahedra(mean, axis)
    verts_w = sess.frame.to_world(torch.as_tensor(verts, device="cuda")).cpu().numpy()
    out["ooc_value"]["surface_rmse"] = surface_rmse(verts_w)
    out["ooc_value"]["grid_gap"] = [float(np.abs(mean - grid2[0]).max()),
                                    float(np.abs(var - grid2[1]).max())]
    finite += [np.isfinite(a).all() for a in (mean, var, big_mean, big_var)]
    del sess
    torch.cuda.empty_cache()

    # Sharded, one NCCL rank: phase 9's fit with touch slots, two batches.
    store = tempfile.mkdtemp(prefix="gpis_nccl_")
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(store, 'store')}",
                            rank=0, world_size=1)
    try:
        ts = gpis.build_training_set(pts, cfg, device="cuda")
        params = kf.kernel_params(cfg.lengthscale, cfg.signal_variance)
        model = fit_sharded(cfg.kernel, ts.x, ts.y, ts.noise, params, n_devices=1, block=256,
                            touch_capacity=TOUCH_CAPACITY, pad_noise=cfg.pad_noise)
        q_t = ts.frame.to_normalized(torch.as_tensor(touched2, device="cuda"))
        var0 = regression.predict(model, q_t)[1].cpu().numpy()
        box = {"model": model}

        def sharded_update(b):
            q = ts.frame.to_normalized(torch.as_tensor(b, device="cuda"))
            box["model"] = box["model"].update(q, 0.0, cfg.noise_touch)

        updates = timed_updates(torch, sharded_update, value_touch[:2])
        model = box.pop("model")
        mean_t, var_t = (t.cpu().numpy() for t in regression.predict(model, q_t))
        out["sharded"] = {"capacity": model.capacity, "n_touch": model.n_touch,
                          "update_s": updates,
                          **touched_checks("sharded P=1", var0, mean_t, var_t)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, var, axis = (t.cpu().numpy() for t in grid.evaluate_grid(model, 64, 1.5))
        out["sharded"]["query_s"] = time.perf_counter() - t0
        verts, _ = marching.marching_tetrahedra(mean, axis)
        verts_w = ts.frame.to_world(torch.as_tensor(verts, device="cuda")).cpu().numpy()
        out["sharded"]["surface_rmse"] = surface_rmse(verts_w)
        out["sharded"]["grid_gap"] = [float(np.abs(mean - grid2[0]).max()),
                                      float(np.abs(var - grid2[1]).max())]
        finite += [np.isfinite(a).all() for a in (mean, var)]
        del model, box
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # Joint, in core: phase 4's session, bordering until a batch overflows.
    joint_touch = touch_batches(rng, 17, center, radius)
    t0 = time.perf_counter()
    sess = ObjectModelSession(cfg4, device="cuda").start(jpts, normals=normals)
    out["joint_fit_s"] = time.perf_counter() - t0
    slots = sess.model.touch_capacity
    if slots != 16 * TOUCH_BATCH:
        fail(f"phase 4's joint session has {slots} touch slots, not {16 * TOUCH_BATCH}")
    touched = np.concatenate(joint_touch)
    _, var0 = sess.query(touched)
    j_size = sess.model.chol.shape[0]
    updates = timed_updates(torch, sess.update, joint_touch[:2])
    gridj2 = sess.evaluate_grid()[:2]
    updates += timed_updates(torch, sess.update, joint_touch[2:16])
    if sess.model.n_touch != slots:
        fail(f"the joint session bordered {sess.model.n_touch} touches, not {slots}")
    bordered = np.concatenate(joint_touch[:16])
    out["joint"] = touched_checks("joint in core (16 batches bordered)", var0[:len(bordered)],
                                  *sess.query(bordered))
    refit = timed_updates(torch, sess.update, joint_touch[16:])
    if sess.model.n_touch != 0:
        fail("the overflowing joint batch did not take the refit path")
    mean_t, var_t = sess.query(touched)
    rise = var_t - var0
    out["joint"].update({
        "joint_size": j_size, "joint_size_after_refit": sess.model.chol.shape[0],
        "border_update_s": updates, "refit_update_s": refit,
        "refit_jitter": float(sess.model.noise_f[0]) - cfg4.noise_surface,
        "refit_touched_mean_gap": float(np.abs(mean_t).max()),
        "refit_touched_var_rose": int((rise >= 0).sum()), "refit_touched_var_max_rise":
        float(rise.max())})
    check("joint in core (after the refit): |mean - target| at the touched points",
          out["joint"]["refit_touched_mean_gap"], TOUCH_MEAN_TOL)
    mean, var, axis = sess.evaluate_grid()
    out["joint"]["query_s"] = sess.stats["grid_s"]
    verts, _ = marching.marching_tetrahedra(mean, axis)
    c_n = sess.frame.to_normalized(torch.as_tensor(np.asarray(center, np.float32),
                                                   device="cuda"))
    sel = torch.as_tensor(verts[np.linspace(0, len(verts) - 1, 256).astype(int)],
                          dtype=sess.dtype, device="cuda")
    grad = gpd.predict_gradient(sess.model, sel)
    radial = sel - c_n
    out["joint"]["min_normal_cos"] = (torch.sum(grad * radial, dim=1)
                                      / (grad.norm(dim=1) * radial.norm(dim=1))).min().item()
    rad = np.linalg.norm(verts - c_n.cpu().numpy(), axis=1) - radius / float(sess.frame.scale)
    out["joint"]["surface_rmse"] = float(np.sqrt(np.mean(rad**2))) if len(verts) else float("nan")
    finite += [np.isfinite(a).all() for a in (mean, var, mean_t, var_t)]
    finite.append(torch.isfinite(grad).all().item())
    del sess, grad, sel
    torch.cuda.empty_cache()
    var0_joint, var_refit = var0, var_t

    # Out of core, joint: phase 6's session, two batches into the tail.
    sess = ObjectModelSession(cfg4, device="cuda").start(jpts, normals=normals, out_of_core=True)
    touched2 = np.concatenate(joint_touch[:2])
    _, var0 = sess.query(touched2)
    updates = timed_updates(torch, sess.update, joint_touch[:2])
    mean_t, var_t = sess.query(touched2)
    out["ooc_joint"] = {"n_tail": sess.model.n_tail, "update_s": updates,
                        **touched_checks("out-of-core joint", var0, mean_t, var_t)}
    big_mean, big_var, out["ooc_joint"]["big_query_s"] = timed_query(torch, sess, big_query(
        torch, jpts))
    mean, var, axis = sess.evaluate_grid()
    out["ooc_joint"]["query_s"] = sess.stats["grid_s"]
    out["ooc_joint"]["grid_gap"] = [float(np.abs(mean - gridj2[0]).max()),
                                    float(np.abs(var - gridj2[1]).max())]
    finite += [np.isfinite(a).all() for a in (mean, var, big_mean, big_var)]
    del sess
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    counts = dict(launches)

    # Float64 on the card, after the counted run.  The observed batch: the
    # fall, and the float32 rise held to the float32 quad's error there
    # (after the fit, against float64).
    var_fit64, var0_64, mean_64, var_64 = value_float64(cfg, pts, value_touch, seen)
    touched_checks("value in core float64, observed part", var0_64, mean_64, var_64)
    out["value"]["observed"] = {
        "quad_err_float64": float(np.abs(var_fit_seen - var_fit64).max()),
        "var_max_rise": float((var_seen - var_seen0).max()),
        "touched_mean_gap": float(np.abs(mean_seen).max())}
    # The joint refit folds the touches in with the config's 1e-6 noise,
    # unfloored (as in JAX), and the float32 quad through W = L^{-1} of that
    # system errs by ~1e-4 (W's error grows with 1 / sqrt(noise)), more than
    # a touch beside the cloud lowers the variance.  So the fall is held in
    # float64 on the card, and the float32 variance to the float64 one.
    var0_64, var_64 = joint_refit_float64(cfg4, jpts, normals, joint_touch, touched)
    touched_checks("joint in core float64 (after the refit)", var0_64, None, var_64)
    out["joint"]["refit_var_gap_float64"] = float(np.abs(var_refit - var_64).max())
    out["joint"]["refit_var_gap_touches_left_out"] = float(np.abs(var0_joint - var_64).max())

    say(f"  launches in the tactile-update run: {counts}")
    say(json.dumps({"tactile_updates": out}))
    if not all(bool(f) for f in finite):
        fail("NaN or inf in an updated posterior")
    for what in ("value", "ooc_value", "sharded", "joint"):
        if not out[what]["surface_rmse"] < RMSE_GATE:
            fail(f"{what} surface RMSE after updates {out[what]['surface_rmse']} >= {RMSE_GATE}")
    if not out["joint"]["min_normal_cos"] > COS_GATE:
        fail(f"joint min cos(normal, radial) after updates {out['joint']['min_normal_cos']}")
    for what, ref in (("ooc_value", "in-core value"), ("sharded", "in-core value"),
                      ("ooc_joint", "in-core joint")):
        gap_mean, gap_var = out[what]["grid_gap"]
        check(f"{what} 64^3 grid against the {ref} grid after the same touches: mean",
              gap_mean, OOC_GRID_GAP)
        check(f"{what} 64^3 grid against the {ref} grid after the same touches: var",
              gap_var, OOC_GRID_GAP)
    seen_out = out["value"]["observed"]
    check("value in core, observed part: |mean - target| at the touched points",
          seen_out["touched_mean_gap"], TOUCH_MEAN_TOL)
    check("value in core, observed part: float32 variance rise against the quad's error",
          seen_out["var_max_rise"], seen_out["quad_err_float64"], err_name="max_rise")
    check("joint float32 variance at the touched points after the refit against float64 "
          f"(a refit without the touches reads {out['joint']['refit_var_gap_touches_left_out']:.3e})",
          out["joint"]["refit_var_gap_float64"], REFIT_VAR_GAP)
    check("surface_points: max |f| at the converged points", f_surf, SURFACE_F_TOL)
    conv = out["value"]["surface_points_converged"]
    say(f"  surface_points: {conv:.4f} of 256 seeds converged (gate >= {SURFACE_CONVERGED})")
    if not conv >= SURFACE_CONVERGED:
        fail(f"surface_points converged {conv} < {SURFACE_CONVERGED}")
    require_launches(counts, ("cov", "joint_cov", "staged_quad", "fused_quad", "quad_band",
                              "panel_update", "row_update"), "tactile-update")
    return counts


# ---------------------------------------------------------------- phase 11

CFG3_N, CFG3_C = 4000, 4096  # config 3's bar: points, capacity (Kernels A and B in float64)
CFG3_LS, CFG3_LS0, CFG3_NOISE = 0.5, 2.0, 1e-2  # the truth, the start 4x off, the noise
CFG3_STEPS = 150
CFG3_LS_TOL = 0.10  # the lengthscale within 10 % of the truth
FD_REL = 1e-4  # the gradient against a central finite difference (BASELINE.md config 3)
FD_STEP = 1e-5
CPU_REL = 1e-6  # the card's float64 gradient against the CPU twins'
HYPEROPT_STEPS = {"value": 10, "joint": 5, "stream": 2, "ooc_joint": 1, "distributed": 2}


def mll_and_grad(torch, xp, yp, noisep, n_real: int, theta, chol_impl=None):
    """`gp.hyperopt.optimize`'s objective (the MLL, signal variance 1) and
    its gradient in theta = (log lengthscale, log noise scale)."""
    from gpis_tpu_torch.gp import regression as gpr

    t = torch.tensor(theta, dtype=xp.dtype, device=xp.device, requires_grad=True)
    real = torch.arange(xp.shape[0], device=xp.device) < n_real
    mll = gpr.log_marginal_likelihood(
        "rbf", xp, yp, torch.where(real, noisep * torch.exp(t[1]), noisep),
        {"lengthscale": torch.exp(t[0]), "signal_variance": 1.0}, chol_impl=chol_impl)
    (g,) = torch.autograd.grad(mll, t)
    return float(mll.detach()), g.cpu().numpy().astype(np.float64)


def rel_err(got, want) -> float:
    """max |got - want| over max |want|: the norm-wise relative error."""
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def config3_bar(torch, launches) -> dict:
    """BASELINE.md's config-3 bar on the card in float64: y drawn from an RBF
    GP of lengthscale 0.5 on 4,000 points (capacity 4,096, so the MLL's Gram
    is Kernel A and its factor Kernel B), `optimize` from lengthscale 2.0;
    the start's gradient against a central finite difference and against
    the CPU twins."""
    from gpis_tpu_torch.gp import hyperopt as ho
    from gpis_tpu_torch.gp import regression as gpr
    from gpis_tpu_torch.kernels import gram as kg

    rng = np.random.default_rng(11)
    x = torch.tensor(rng.uniform(-1.0, 1.0, size=(CFG3_N, 3)), device="cuda")
    k = kg.gram_reference("rbf", x, {"lengthscale": CFG3_LS, "signal_variance": 1.0},
                          noise=CFG3_NOISE)
    y = torch.linalg.cholesky(k) @ torch.tensor(rng.normal(size=CFG3_N), device="cuda")
    del k
    xp, yp, noisep = gpr._pad_training(x, y, CFG3_NOISE, CFG3_C, 1e10)
    torch.cuda.synchronize()
    launches.clear()
    t0 = time.perf_counter()
    res = ho.optimize("rbf", xp, yp, noisep, {"lengthscale": CFG3_LS0, "signal_variance": 1.0},
                      n_real=CFG3_N, steps=CFG3_STEPS)
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t0
    counts = dict(launches)
    ls = res.params["lengthscale"]
    within = [abs(v - CFG3_LS) / CFG3_LS <= CFG3_LS_TOL for v in res.lengthscale_history]
    steps_to_bar = next((i for i in range(len(within)) if all(within[i:])), None)
    theta0 = [np.log(CFG3_LS0), 0.0]
    mll0, g = mll_and_grad(torch, xp, yp, noisep, CFG3_N, theta0)
    fd = []
    for i in range(2):
        up, dn = list(theta0), list(theta0)
        up[i] += FD_STEP
        dn[i] -= FD_STEP
        fd.append((mll_and_grad(torch, xp, yp, noisep, CFG3_N, up)[0]
                   - mll_and_grad(torch, xp, yp, noisep, CFG3_N, dn)[0]) / (2 * FD_STEP))
    _, g_cpu = mll_and_grad(torch, xp.cpu(), yp.cpu(), noisep.cpu(), CFG3_N, theta0)
    out = {"config3": "rbf ls 0.5 from 2.0, float64", "n": CFG3_N, "capacity": CFG3_C,
           "steps": CFG3_STEPS, "lengthscale": ls, "noise_scale": res.noise_scale,
           "steps_to_bar": steps_to_bar, "optimize_s": opt_s, "step_s": opt_s / CFG3_STEPS,
           "mll_start": mll0, "mll_best": res.mll, "grad_start": g.tolist(), "grad_fd": fd,
           "grad_cpu": g_cpu.tolist(), "launches": counts, "card": card_line()}
    say(json.dumps(out))
    check("config 3: lengthscale from 2.0 against the truth 0.5 (relative)",
          abs(ls - CFG3_LS) / CFG3_LS, CFG3_LS_TOL, err_name="rel_err")
    check("config 3: gradient at the start against a central difference (norm-wise)",
          rel_err(g, fd), FD_REL, err_name="rel_err")
    check("config 3: the card's float64 gradient against the CPU twins' (norm-wise)",
          rel_err(g, g_cpu), CPU_REL, err_name="rel_err")
    require_launches(counts, ("cov", "panel_update"), "config-3 bar")
    return counts


def objective_split(torch, xp, yp, noisep) -> dict:
    """One float32 objective step (value and gradient at the start) timed
    whole (CUDA events), split into Kernel A's primal, Kernel B's factor,
    the solves' forward and backward, the Cholesky pullback and the Gram
    pullback, and beside it the same objective through the library's
    factor and its own autograd."""
    from gpis_tpu_torch.gp import regression as gpr
    from gpis_tpu_torch.kernels import gram as kg
    from gpis_tpu_torch.linalg import cholesky as lin

    c = xp.shape[0]
    theta0 = [np.log(0.4), 0.0]
    ms = {"step": time_ms(torch, lambda: mll_and_grad(torch, xp, yp, noisep, c, theta0), 2),
          "library_step": time_ms(torch, lambda: mll_and_grad(
              torch, xp, yp, noisep, c, theta0, chol_impl=gpr._library_chol), 2)}
    ls = torch.tensor(0.4, device="cuda", requires_grad=True)
    noise = noisep.clone().requires_grad_(True)
    params = {"lengthscale": ls, "signal_variance": 1.0}
    ms["gram_primal_A"] = time_ms(torch, lambda: kg.gram_ad("rbf", xp, params, noise), 2)
    k0 = kg.gram_ad("rbf", xp, params, noise)
    kbuf = torch.empty_like(k0)
    with torch.no_grad():
        ms["factor_B"] = time_ms(torch, lambda: lin.blocked_cholesky_ad(kbuf.copy_(k0), 256), 2)
        ms["copy_into_factor"] = time_ms(torch, lambda: kbuf.copy_(k0), 2)
    a = k0.detach().clone().requires_grad_(True)
    l = lin.blocked_cholesky_ad(a * 1.0, 256)
    l_leaf = l.detach().requires_grad_(True)

    def rest():
        alpha = lin.cho_solve(l_leaf, yp)
        mll = -0.5 * torch.dot(yp, alpha) - torch.sum(torch.log(torch.diagonal(l_leaf)))
        return torch.autograd.grad(mll, l_leaf)[0]

    ms["solves_fwd_bwd"] = time_ms(torch, rest, 2)
    lbar = rest()
    ms["cholesky_pullback"] = time_ms(
        torch, lambda: torch.autograd.grad(l, a, lbar, retain_graph=True), 2)
    kbar = lbar + lbar.T
    ms["gram_pullback"] = time_ms(
        torch, lambda: torch.autograd.grad(k0, (ls, noise), kbar, retain_graph=True), 2)
    return ms


def value_hyperopt(torch, launches, incore) -> tuple[dict, dict]:
    """(b) Phase 3's value session, float32, C = 16,384: optimize, refit, the
    64^3 grid and the surface; then the start's dense gradient in float32
    and float64 (for (d)) and the objective step's split."""
    from gpis_tpu_torch import ObjectModelSession
    from gpis_tpu_torch.gp import regression as gpr

    cfg, pts, _, _ = incore
    torch.cuda.synchronize()
    launches.clear()
    sess = ObjectModelSession(cfg, device="cuda").start(pts)
    t0 = time.perf_counter()
    res = sess.optimize_hyperparameters(steps=HYPEROPT_STEPS["value"])
    opt_s = time.perf_counter() - t0
    mean, var, axis = sess.evaluate_grid()
    verts, _, vvar = sess.extract_surface()
    torch.cuda.synchronize()
    counts = dict(launches)
    hist = np.asarray(res.history)
    rmse = surface_rmse(verts)
    ts = sess.training
    c = sess.model.capacity
    del sess
    torch.cuda.empty_cache()
    xp, yp, noisep = gpr._pad_training(ts.x, ts.y, ts.noise, c, cfg.pad_noise)
    theta0 = [np.log(cfg.lengthscale), 0.0]
    g32 = mll_and_grad(torch, xp, yp, noisep, c, theta0)[1]
    g64 = mll_and_grad(torch, xp.double(), yp.double(), noisep.double(), c, theta0)[1]
    split = objective_split(torch, xp, yp, noisep)
    nan_steps = [i for i, h in enumerate(hist) if not np.isfinite(h)]
    out = {"hyperopt": "value session, float32", "capacity": c, "steps": len(hist),
           "optimize_s": opt_s, "history": hist.tolist(), "params": res.params,
           "noise_scale": res.noise_scale, "surface_rmse": rmse, "grad_start_f32": g32.tolist(),
           "grad_start_f64": g64.tolist(), "step_ms": split, "launches": counts,
           "card": card_line()}
    say(json.dumps(out))
    if nan_steps:
        say(f"  finding: the float32 objective met a NaN factor at steps {nan_steps}")
    finite = bool(np.isfinite(mean).all() and np.isfinite(var).all() and np.isfinite(vvar).all())
    if nan_steps or not finite:
        fail("NaN in the value session's hyperopt history or its refit's posterior")
    if not res.mll > hist[0]:
        fail(f"the best MLL {res.mll} is not above the start's {hist[0]}")
    if not rmse < RMSE_GATE:
        fail(f"surface RMSE after the value hyperopt {rmse} >= {RMSE_GATE}")
    require_launches(counts, ("cov", "panel_update"), "value hyperopt")
    return counts, {"g32": g32, "g64": g64}


def joint_hyperopt(torch, launches, incore) -> dict:
    """(c) Phase 4's joint session, J = 21,504: optimize, refit, the grid,
    the surface and its normals."""
    from gpis_tpu_torch import ObjectModelSession
    from gpis_tpu_torch.gp import derivative as gpd

    cfg, pts, normals, _, _ = incore
    n, radius, center = JOINT_SPHERE
    torch.cuda.synchronize()
    launches.clear()
    sess = ObjectModelSession(cfg, device="cuda").start(pts, normals=normals)
    t0 = time.perf_counter()
    res = sess.optimize_hyperparameters(steps=HYPEROPT_STEPS["joint"])
    opt_s = time.perf_counter() - t0
    mean, var, _ = sess.evaluate_grid()
    verts, _, vvar = sess.extract_surface(world_frame=False)
    c_n = sess.frame.to_normalized(torch.as_tensor(np.asarray(center, np.float32),
                                                   device="cuda"))
    sel = torch.as_tensor(verts[np.linspace(0, len(verts) - 1, 256).astype(int)],
                          dtype=sess.dtype, device="cuda")
    grad = gpd.predict_gradient(sess.model, sel)
    torch.cuda.synchronize()
    counts = dict(launches)
    radial = sel - c_n
    min_cos = (torch.sum(grad * radial, dim=1) / (grad.norm(dim=1) * radial.norm(dim=1))).min()
    rad = np.linalg.norm(verts - c_n.cpu().numpy(), axis=1) - radius / float(sess.frame.scale)
    rmse = float(np.sqrt(np.mean(rad**2))) if len(verts) else float("nan")
    hist = np.asarray(res.history)
    say(json.dumps({"hyperopt": "joint session, float32", "joint_size": sess.model.chol.shape[0],
                    "steps": len(hist), "optimize_s": opt_s, "history": hist.tolist(),
                    "params": res.params, "surface_rmse": rmse,
                    "min_normal_cos": float(min_cos), "launches": counts, "card": card_line()}))
    if not (np.isfinite(hist).all() and np.isfinite(mean).all() and np.isfinite(vvar).all()):
        fail("NaN in the joint session's hyperopt history or its refit's posterior")
    if not rmse < RMSE_GATE:
        fail(f"joint surface RMSE after the hyperopt {rmse} >= {RMSE_GATE}")
    if not float(min_cos) > COS_GATE:
        fail(f"min cos(normal, radial) after the joint hyperopt {float(min_cos)} <= {COS_GATE}")
    require_launches(counts, ("joint_cov", "panel_update"), "joint hyperopt")
    return counts


def small_stream_parity(torch) -> None:
    """A small float64 stream objective (C = 1,024, panel 256) on the card
    against the CPU path at 1e-6."""
    from gpis_tpu_torch.data.gpis import fibonacci_sphere
    from gpis_tpu_torch.gp import ooc_hyperopt as oho

    x = fibonacci_sphere(1000)
    y = np.random.default_rng(5).normal(size=1000) * 0.3
    got = []
    for dev in ("cuda", "cpu"):
        mll, g = oho.ooc_mll_and_grad("rbf", torch.tensor(x, device=dev),
                                      torch.tensor(y, device=dev), 1e-3,
                                      {"lengthscale": 0.4, "signal_variance": 1.0}, panel=256,
                                      noise_scale=1.3)
        got.append([float(mll)] + [float(g[k]) for k in ("log_ls", "log_noise_scale",
                                                          "log_sv")])
    check("stream objective float64, C=1024, cuda vs cpu (MLL and gradient, relative)",
          max(abs(a - b) / abs(b) for a, b in zip(*got)), CPU_REL, err_name="rel_err")


def refit_checks(torch, what, sess, params, noise, joint=None) -> tuple[tuple, float]:
    """A refit's 64^3 grid against the in-core pipeline's (fit_inference, or
    the joint fit and W) on the same training set at the refit's
    hyperparameters and noise, and its surface's RMSE against the sphere
    the cloud was drawn on (phase 3's unit sphere, or phase 4's with
    `joint`).  Returns ((mean gap, var gap), RMSE)."""
    from gpis_tpu_torch.gp import derivative as gpd
    from gpis_tpu_torch.gp import regression as gpr
    from gpis_tpu_torch.surface import grid, marching

    mean, var, axis = sess.evaluate_grid()
    verts, _ = marching.marching_tetrahedra(mean, axis)
    if joint is None:  # phase 3's unit sphere, in the world frame
        rmse = surface_rmse(sess.frame.to_world(torch.as_tensor(verts, device="cuda"))
                            .cpu().numpy())
    else:  # phase 4's sphere, in the normalized frame, as phase 4 measures it
        _, radius, center = JOINT_SPHERE
        c_n = sess.frame.to_normalized(torch.as_tensor(np.asarray(center, np.float32),
                                                       device="cuda")).cpu().numpy()
        rad = np.linalg.norm(verts - c_n, axis=1) - radius / float(sess.frame.scale)
        rmse = float(np.sqrt(np.mean(rad**2))) if len(verts) else float("nan")
    cfg, ts = sess.config, sess.training
    if joint is None:
        model = gpr.fit_inference(cfg.kernel, ts.x, ts.y, noise, params, block=cfg.block,
                                  pad_noise=cfg.pad_noise)
    else:
        nrm, noise_g = joint
        model = gpd.with_linv_joint(gpd.fit_with_normals(
            cfg.kernel, ts.x, ts.y, nrm, noise, noise_g, params, block=cfg.block,
            pad_noise=cfg.pad_noise))
    in_mean, in_var, _ = (t.cpu().numpy() for t in grid.evaluate_grid(
        model, cfg.grid_resolution, cfg.grid_extent))
    finite = bool(np.isfinite(mean).all() and np.isfinite(var).all())
    if not finite:
        fail(f"NaN in the {what} refit's grid")
    gaps = float(np.abs(mean - in_mean).max()), float(np.abs(var - in_var).max())
    check(f"{what} refit 64^3 grid against the in-core fit at its optimum: mean", gaps[0],
          OOC_GRID_GAP)
    check(f"{what} refit 64^3 grid against the in-core fit at its optimum: var", gaps[1],
          OOC_GRID_GAP)
    if not rmse < RMSE_GATE:
        fail(f"{what} refit surface RMSE {rmse} >= {RMSE_GATE}")
    return gaps, rmse


def stream_hyperopt(torch, launches, incore, dense) -> dict:
    """(d) Phase 5's out-of-core value session, method="stream": one
    objective step timed and its gradient held to (b)'s dense one, then two
    optimizer steps, the refit and its grid."""
    from gpis_tpu_torch import ObjectModelSession
    from gpis_tpu_torch.gp import ooc_hyperopt as oho

    small_stream_parity(torch)
    cfg, pts, _, _ = incore
    torch.cuda.synchronize()
    launches.clear()
    sess = ObjectModelSession(cfg, device="cuda").start(pts, out_of_core=True)
    ts, m = sess.training, sess.model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mll, g = oho.ooc_mll_and_grad(cfg.kernel, ts.x, ts.y, ts.noise, m.params, panel=m.panel,
                                  pad_noise=cfg.pad_noise)
    g = np.array([float(g["log_ls"]), float(g["log_noise_scale"])])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = sess.optimize_hyperparameters(method="stream", steps=HYPEROPT_STEPS["stream"])
    opt_s = time.perf_counter() - t0
    counts = dict(launches)
    gaps, rmse = refit_checks(torch, "out-of-core stream", sess, res.params,
                              ts.noise * res.noise_scale)
    # Float32's reach on this gradient: how far the dense float32 one lies
    # from float64, doubled (the stream trace comes from an explicit W, the
    # dense one from solves), plus 1e-4 of its size.
    reach = np.abs(dense["g32"] - dense["g64"])
    tol = 2.0 * reach + 1e-4 * np.abs(dense["g64"]).max()
    say(json.dumps({"hyperopt": "out-of-core value session, stream", "panel": m.panel,
                    "stream_step_s": step_s, "optimize_s": opt_s, "history": res.history,
                    "params": res.params, "grad_start_stream_f32": g.tolist(),
                    "grad_start_dense_f32": dense["g32"].tolist(),
                    "grad_start_dense_f64": dense["g64"].tolist(), "grad_tol": tol.tolist(),
                    "grid_gap": gaps, "surface_rmse": rmse, "launches": counts,
                    "card": card_line()}))
    for i, name in enumerate(("log lengthscale", "log noise scale")):
        check(f"stream gradient ({name}) against the dense float32 one (tol 2 x the dense "
              "float32's distance to float64 + 1e-4 x max|g|)", abs(g[i] - dense["g32"][i]),
              tol[i], err_name="abs_err")
    if not np.isfinite(res.history).all():
        fail("NaN in the stream hyperopt history")
    require_launches(counts, ("gram_band", "gemm_nt_masked", "gemm_nn_acc_masked",
                              "stripe_write", "panel_update"), "stream hyperopt")
    return counts


def ooc_joint_and_sharded_hyperopt(torch, launches, incore_value, incore_joint) -> list:
    """(e) Phase 6's out-of-core joint session, one stream step, and phase
    9's one-rank NCCL sharded model, method="distributed" (a one-rank mesh
    session keeps the single-card path, so the model is put in a session),
    each refit's grid held to the in-core pipeline's at its optimum."""
    import os
    import tempfile

    import torch.distributed as dist

    from gpis_tpu_torch import ObjectModelSession
    from gpis_tpu_torch.data import gpis
    from gpis_tpu_torch.gp.sharded_model import fit_sharded
    from gpis_tpu_torch.kernels import functions as kf

    cfg4, jpts, normals, _, _ = incore_joint
    torch.cuda.synchronize()
    launches.clear()
    sess = ObjectModelSession(cfg4, device="cuda").start(jpts, normals=normals,
                                                         out_of_core=True)
    m = sess.model
    t0 = time.perf_counter()
    res = sess.optimize_hyperparameters(method="stream", steps=HYPEROPT_STEPS["ooc_joint"])
    opt_s = time.perf_counter() - t0
    runs = [dict(launches)]
    n = m.n_real
    gaps, rmse = refit_checks(torch, "out-of-core joint stream", sess, res.params,
                              m.noise[:n] * res.noise_scale,
                              joint=(m.normals[:n], m.noise_g[:n]))
    say(json.dumps({"hyperopt": "out-of-core joint session, stream", "panel": m.panel,
                    "optimize_s": opt_s, "history": res.history, "params": res.params,
                    "grid_gap": gaps, "surface_rmse": rmse, "launches": runs[0],
                    "card": card_line()}))
    if not np.isfinite(res.history).all():
        fail("NaN in the out-of-core joint hyperopt history")
    require_launches(runs[0], ("joint_cov", "gemm_nt_masked", "gemm_nn_acc_masked",
                               "stripe_write"), "out-of-core joint hyperopt")
    del sess, m
    torch.cuda.empty_cache()

    cfg = incore_value[0]
    store = tempfile.mkdtemp(prefix="gpis_nccl_")
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(store, 'store')}",
                            rank=0, world_size=1)
    try:
        dist.all_reduce(torch.zeros((1,), device="cuda"))
        ts = gpis.build_training_set(incore_value[1], cfg, device="cuda")
        sess = ObjectModelSession(cfg, device="cuda")
        sess.training, sess.frame = ts, ts.frame
        torch.cuda.synchronize()
        launches.clear()
        sess.model = fit_sharded(cfg.kernel, ts.x, ts.y, ts.noise,
                                 kf.kernel_params(cfg.lengthscale, cfg.signal_variance),
                                 n_devices=1, block=256, touch_capacity=cfg.touch_capacity,
                                 pad_noise=cfg.pad_noise)
        noise = sess.model.noise[:sess.model.n_real]
        t0 = time.perf_counter()
        res = sess.optimize_hyperparameters(method="distributed",
                                            steps=HYPEROPT_STEPS["distributed"])
        torch.cuda.synchronize()
        opt_s = time.perf_counter() - t0
        runs.append(dict(launches))
        gaps, rmse = refit_checks(torch, "sharded P=1 distributed", sess, res.params,
                                  noise * res.noise_scale)
        del sess
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    say(json.dumps({"hyperopt": "sharded P=1 nccl, distributed", "optimize_s": opt_s,
                    "history": res.history, "params": res.params, "grid_gap": gaps,
                    "surface_rmse": rmse, "launches": runs[1], "card": card_line()}))
    if not np.isfinite(res.history).all():
        fail("NaN in the distributed hyperopt history")
    require_launches(runs[1], ("gram_band", "gemm_nt_masked"), "distributed hyperopt")
    return runs


def phase11(torch, launches, incore_value, incore_joint) -> list:
    """Config 3, marginal-likelihood hyperparameter optimization, through the
    entry points a user calls; the launches of each sub-phase's run."""
    t0 = time.perf_counter()
    runs = [config3_bar(torch, launches)]
    torch.cuda.empty_cache()
    counts, dense = value_hyperopt(torch, launches, incore_value)
    runs.append(counts)
    torch.cuda.empty_cache()
    runs.append(joint_hyperopt(torch, launches, incore_joint))
    torch.cuda.empty_cache()
    runs.append(stream_hyperopt(torch, launches, incore_value, dense))
    torch.cuda.empty_cache()
    runs += ooc_joint_and_sharded_hyperopt(torch, launches, incore_value, incore_joint)
    say(f"  phase 11: {time.perf_counter() - t0:.1f} s")
    return runs


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    say("phase 0: card")
    card = card_line()
    say(card)
    try:
        from gpis_tpu_torch import _build
    except ImportError as e:
        fail(f"gpis_tpu_torch is not importable from here ({e})")

    say("phase 1: build")
    lib_path, build_s, log = _build.build()
    say(f"  built {lib_path} in {build_s:.1f} s")
    function = "?"
    for line in log.splitlines():
        if "Function properties for" in line:
            function = line.split("Function properties for")[-1].strip()
        elif "spill" in line and not ("0 bytes spill stores" in line
                                      and "0 bytes spill loads" in line):
            say(f"  ptxas: {function}: {line.strip()}")
    _build.library()

    say("phase 2: kernels against their plain twins")
    results: dict = {}
    phase2(torch, results)

    # Launches: each main-path run's counts, set to 0 just before it and
    # read just after.
    runs = []
    say("phase 3: the value slice through ObjectModelSession")
    counts, incore_value, fit_s_value = phase3(torch, _build.LAUNCHES)
    runs.append(counts)

    say("phase 4: the joint (surface-normal) slice through ObjectModelSession")
    counts, incore_joint = phase4(torch, _build.LAUNCHES)
    runs.append(counts)
    torch.cuda.empty_cache()

    say("phase 5: the out-of-core value slice through ObjectModelSession")
    runs.append(ooc_session_phase(torch, _build.LAUNCHES, incore_value, normals=False))
    torch.cuda.empty_cache()

    say("phase 6: the out-of-core joint slice through ObjectModelSession")
    runs.append(ooc_session_phase(torch, _build.LAUNCHES, incore_joint, normals=True))
    torch.cuda.empty_cache()

    say("phase 7: the out-of-core host spill")
    runs.append(phase7(torch, _build.LAUNCHES))
    torch.cuda.empty_cache()

    say('phase 8: the panel_solve="inv" option through ObjectModelSession')
    runs.append(phase_inv(torch, _build.LAUNCHES, incore_value, fit_s_value))
    torch.cuda.empty_cache()

    say("phase 9: the row-sharded pipeline on a one-rank NCCL group")
    runs.append(phase_sharded(torch, _build.LAUNCHES, incore_value))
    torch.cuda.empty_cache()

    say("phase 10: tactile updates and surface projection through ObjectModelSession")
    runs.append(phase10(torch, _build.LAUNCHES, incore_value[0], incore_joint[0]))
    torch.cuda.empty_cache()

    say("phase 11: marginal-likelihood hyperparameter optimization (config 3)")
    runs += phase11(torch, _build.LAUNCHES, incore_value, incore_joint)

    if "jax" in sys.modules:
        fail("jax was imported")
    jax_pkg = [m for m in sys.modules if m == "gpis_tpu" or m.startswith("gpis_tpu.")]
    if jax_pkg:
        fail(f"the JAX package was imported: {jax_pkg}")
    sources = {
        "cov": ("gpis_tpu_torch/csrc/cov.cu", "gpis_tpu/kernels/pallas_gram.py:197"),
        "panel_update": ("gpis_tpu_torch/csrc/tc_nn.cuh", "gpis_tpu/linalg/pallas_chol.py:180"),
        "row_update": ("gpis_tpu_torch/csrc/tc_nn.cuh", "gpis_tpu/linalg/pallas_chol.py:569"),
        "staged_quad": ("gpis_tpu_torch/csrc/query.cu", "gpis_tpu/kernels/pallas_query.py:319"),
        "joint_cov": ("gpis_tpu_torch/csrc/joint.cu", "gpis_tpu/kernels/pallas_joint.py:215"),
        "fused_quad": ("gpis_tpu_torch/csrc/fused_query.cu",
                       "gpis_tpu/kernels/pallas_query.py:404, "
                       "gpis_tpu/kernels/pallas_joint.py:367"),
        "gram_band": ("gpis_tpu_torch/csrc/cov.cu", "gpis_tpu/kernels/pallas_gram.py:173"),
        "gemm_nt_masked": ("gpis_tpu_torch/csrc/tc_nn.cuh", "gpis_tpu/linalg/pallas_chol.py:307"),
        "gemm_nn_acc_masked": ("gpis_tpu_torch/csrc/tc_nn.cuh",
                               "gpis_tpu/linalg/pallas_chol.py:380"),
        "stripe_write": ("gpis_tpu_torch/csrc/chol.cu", "gpis_tpu/linalg/pallas_chol.py:429"),
        "quad_band": ("gpis_tpu_torch/csrc/fused_query.cu",
                      "gpis_tpu/kernels/pallas_query.py:241, "
                      "gpis_tpu/kernels/pallas_joint.py:500"),
        "panel_scale": ("gpis_tpu_torch/csrc/tc_nn.cuh", "gpis_tpu/linalg/pallas_chol.py:461"),
        "row_scale": ("gpis_tpu_torch/csrc/tc_nn.cuh", "gpis_tpu/linalg/pallas_chol.py:488"),
        "band_trail": ("gpis_tpu_torch/csrc/chol.cu", "gpis_tpu/linalg/pallas_chol.py:241"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(run.get(name, 0) for run in runs), **results[name]}
        for name, (src, rep) in sources.items()
    ]
    say(f"total {time.perf_counter() - t_start:.1f} s; {card}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
