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
   twin's time (CUDA events).  The quads of Kernels D and F are held per
   query against the twin run in float64.  Plus the variance-quad regime
   the JAX package's `_QSPLIT` note measured (C = 1,024, noise 1e-3) held
   against a float64 plain run, and the staged route (A or E, then D)
   timed against the on-the-fly one (F) at one shape: the card's
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

Phase 2 also holds the out-of-core kernels (G, H, I, and A and F in band
mode) to their twins at phase 7's shapes, J and K at the in-core factor's
(C = 16,384, B = 256) and L at the sharded TRSM's.  Every kernel's line carries its
bound: the larger of its operations over the card's FP32 rate
(67 TFLOP/s) and its bytes over its memory rate (3.35 TB/s), counted from
the shapes and data of the timed call, and the time of the one PyTorch call
that computes the same function, where there is one.

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


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations over
    the FP32 rate and the bytes over the memory rate, and which binds."""
    t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def check(name: str, err: float, tol: float, ms: float | None = None,
          plain_ms: float | None = None, err_name: str = "max_abs_err") -> None:
    timing = "" if ms is None else f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
    verdict = "ok" if err <= tol else "FAILED"
    say(f"  {name}: {err_name} {err:.3e} <= tol {tol:.3e} {verdict}{timing}")
    if not err <= tol:
        fail(f"{name} disagrees with its plain twin")


def factor_and_query_kernels(torch, gen, kq, bw: int, results: dict | None) -> None:
    """Kernels B, C and D against their twins at capacity C = kq.shape[1];
    timed, and recorded in `results`, when `results` is given."""
    from gpis_tpu_torch.kernels import cuda_query
    from gpis_tpu_torch.linalg import cuda_chol

    dev = kq.device
    m, c = kq.shape

    def timed(fn, reps):
        return None if results is None else time_ms(torch, fn, reps)

    # B: panel update at the middle of the factorization.  Inputs scaled
    # so the products are O(1); tol = 1e-4 x the magnitude sum |a||b| of
    # the worst output (FP32 accumulation over j0 terms, two sum orders).
    j0 = c // 2
    mat = torch.randn((c, c), generator=gen, device=dev) / j0**0.5
    got = cuda_chol.panel_update(mat.clone(), j0, bw)
    want = cuda_chol.panel_update_reference(mat.clone(), j0, bw)
    err = (got - want).abs().max().item()  # whole matrix: outside the panel both are `mat`
    scale = (mat[j0:, :j0].abs() @ mat[j0:j0 + bw, :j0].abs().T).max().item()
    del got, want
    work = mat.clone()
    ms = timed(lambda: cuda_chol.panel_update(work, j0, bw), 10)
    plain = timed(lambda: cuda_chol.panel_update_reference(work, j0, bw), 10)
    check(f"panel_update C={c} j0={j0} B={bw}", err, 1e-4 * scale, ms, plain)
    if results is not None:
        lib = timed(lambda: torch.addmm(work[j0:, j0:j0 + bw], work[j0:, :j0],
                                        work[j0:j0 + bw, :j0].T, alpha=-1), 10)
        results["panel_update"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
            **bound(2 * (c - j0) * bw * j0, 4 * ((c - j0) * j0 + bw * j0 + 2 * (c - j0) * bw)))
    del work

    # C: row update, W lower-triangular with rows < j0 finished.
    w = torch.tril(mat)
    l_row = torch.randn((bw, c), generator=gen, device=dev)
    got = cuda_chol.row_update(w, l_row, j0)
    want = cuda_chol.row_update_reference(w, l_row, j0)
    err = (got - want).abs().max().item()
    scale = (l_row[:, :j0].abs() @ w[:j0, :j0].abs()).max().item()
    del got, want
    ms = timed(lambda: cuda_chol.row_update(w, l_row, j0), 10)
    plain = timed(lambda: cuda_chol.row_update_reference(w, l_row, j0), 10)
    check(f"row_update C={c} j0={j0} B={bw}", err, 1e-4 * scale, ms, plain)
    if results is not None:
        # W is lower-triangular: the product needs j0^2 / 2 of its entries.
        lib = timed(lambda: torch.matmul(l_row[:, :j0], w[:j0, :j0]), 10)
        results["row_update"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                                     **bound(bw * j0 * j0, 4 * (bw * j0 + j0 * j0 / 2 + bw * c)))
    del mat, l_row, w

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
        results["staged_quad"] = dict(max_abs_err=max(err_mean, err_quad), ms=ms,
                                      plain_ms=plain, library_ms=lib,
                                      **bound(m * c * c + 4 * m * c,
                                              4 * (m * c + c * c / 2 + c + 2 * m)))


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


def joint_cov_kernel(torch, gen, q, results: dict) -> dict:
    """Kernel E against its twin: three covariances with coincident points
    in Gram mode (noise) and cross mode (none); then rbf at the joint
    slice's shapes, timed."""
    from gpis_tpu_torch.data.gpis import fibonacci_sphere
    from gpis_tpu_torch.kernels import cuda_joint

    dev = q.device
    x = torch.as_tensor(fibonacci_sphere(1024), dtype=torch.float32, device=dev)
    x[512:576] = x[:64]  # distinct indices, coincident points
    meta = cuda_joint.joint_meta(x, torch.zeros((256, 3), device=dev))
    noise = torch.rand((meta[0].shape[0],), generator=gen, device=dev) * 9e-3 + 1e-3
    qmeta = cuda_joint.value_meta(torch.cat([x[:64], q[:1984]]))  # 64 queries on data points
    worst = 0.0
    for name, ls in (("rbf", 0.4), ("thin_plate", 2.5), ("inverse_multiquadric", 0.4)):
        p = {"lengthscale": ls, "signal_variance": 1.0}
        for mode, rows, nz in (("gram+noise", meta, noise), ("cross", qmeta, None)):
            want = cuda_joint.joint_rows_reference(name, rows, meta, p, noise_col=nz)
            err = (cuda_joint.joint_rows(name, rows, meta, p, noise_col=nz) - want).abs().max()
            tol = 1e-5 * max(1.0, want.abs().max().item())
            check(f"joint_cov {name} {mode} {rows[0].shape[0]}x{meta[0].shape[0]} "
                  f"(tol 1e-5 x max|K|)", err.item(), tol)
            worst = max(worst, err.item())
            del want
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
    # About 45 operations and three exps an element of the Gram.
    results["joint_cov"] = dict(max_abs_err=max(worst, err, err_x), ms=ms, plain_ms=plain,
                                library_ms=None, **bound(48 * j * j, 4 * (j * j + 8 * j)))
    m = q.shape[0]
    return dict(ms=ms_x, plain_ms=plain_x, **bound(48 * m * j, 4 * (m * j + 8 * j + 7 * m)))


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
    # The triangular product (m n^2), and kq generated once for the quad and
    # once for the mean (about 12 operations an element for a value column,
    # 30 for a joint one).
    m = q.shape[0]
    gen_ops = 2 * (12 if kind == "value" else 30) + 2
    return dict(max_abs_err=max(err_mean, err_quad), ms=ms, plain_ms=plain, staged_ms=staged_ms,
                **bound(m * n * n + gen_ops * m * n, 4 * (n * n / 2 + cols.numel() + n + 5 * m)))


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
    # The band's nonzeros (row row0 + i has row0 + i + 1), and kq generated
    # once per (query, column): about 12 operations (value) or 30 (joint).
    m = q.shape[0]
    nnz = rows * row0 + rows * (rows + 1) // 2
    gen_ops = 12 if kind == "value" else 30
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
                **bound(2 * m * nnz + 2 * m * rows + gen_ops * m * (row0 + rows),
                        4 * (nnz + cols.numel() + 4 * m)))


def ooc_kernels(torch, gen, results: dict) -> None:
    """The out-of-core kernels against their twins at phase 7's shapes
    (panel 4,096, sweep 2, so a band of R = 8,192 rows, C = 32,768), and the
    joint band quad at phase 6's (J = 20,480, panel 1,024)."""
    from gpis_tpu_torch.data.gpis import fibonacci_sphere
    from gpis_tpu_torch.kernels import cuda_gram, cuda_joint
    from gpis_tpu_torch.linalg import cuda_chol

    dev = gen.device
    r, p, c = 2 * SPILL_PANEL, SPILL_PANEL, 32768
    kmax = c - p
    cur = torch.randn((r, c), generator=gen, device=dev) / kmax**0.5
    lk = torch.randn((p, c), generator=gen, device=dev) / kmax**0.5

    # G at k0 0 (a copy of S), 4,096 and 28,672 (the last k-step).  tol: 1e-4 x
    # the magnitude sum |a||b| of the worst output, as for Kernel B.
    worst = 0.0
    for k0 in (0, p, kmax):
        s = cur[:, k0:k0 + p]
        got = cuda_chol.gemm_nt_masked(cur, lk, s, k0)
        want = cuda_chol.gemm_nt_masked_reference(cur, lk, s, k0)
        err = (got - want).abs().max().item()
        scale = (cur[:, :k0].abs() @ lk[:, :k0].abs().T).max().item() if k0 else 0.0
        del got, want
        ms = time_ms(torch, lambda: cuda_chol.gemm_nt_masked(cur, lk, s, k0), 3)
        plain = time_ms(torch, lambda: cuda_chol.gemm_nt_masked_reference(cur, lk, s, k0), 3)
        check(f"gemm_nt_masked R={r} P={p} C={c} k0={k0}", err, 1e-4 * scale, ms, plain)
        worst = max(worst, err)
    lib = time_ms(torch, lambda: torch.addmm(s, cur[:, :k0], lk[:, :k0].T, alpha=-1), 3)
    results["gemm_nt_masked"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain, library_ms=lib,
                                     **bound(2 * r * p * k0, 4 * (r * k0 + p * k0 + 2 * r * p)))

    # H at w 4,096 (k = 0) and 32,768 (the widest); A a strided column slice.
    # tol: 1e-4 x the product's magnitude sum |a||b|, as for B and G, plus
    # four float32 ulps of the accumulator the product lands on.
    u0 = torch.randn((r, c), generator=gen, device=dev)
    u0_ulps = 4 * torch.finfo(torch.float32).eps * u0.abs().max().item()
    a = cur[:, kmax - p:kmax]
    worst = 0.0
    for w in (p, c):
        got = cuda_chol.gemm_nn_acc_masked(u0.clone(), a, lk, w)
        want = cuda_chol.gemm_nn_acc_masked_reference(u0.clone(), a, lk, w)
        err = (got - want).abs().max().item()
        scale = (a.abs() @ lk[:, :w].abs()).max().item()
        untouched = torch.equal(got[:, w:], u0[:, w:])
        del got, want
        work = u0.clone()
        ms = time_ms(torch, lambda: cuda_chol.gemm_nn_acc_masked(work, a, lk, w), 3)
        plain = time_ms(torch, lambda: cuda_chol.gemm_nn_acc_masked_reference(work, a, lk, w), 3)
        del work
        check(f"gemm_nn_acc_masked R={r} K={p} C={c} w={w}", err, 1e-4 * scale + u0_ulps, ms,
              plain)
        if not untouched:
            fail(f"gemm_nn_acc_masked wrote columns >= w={w}")
        worst = max(worst, err)
    lib = time_ms(torch, lambda: torch.addmm(u0[:, :w], a, lk[:, :w]), 3)
    results["gemm_nn_acc_masked"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain, library_ms=lib,
                                         **bound(2 * r * p * w, 4 * (r * p + p * w + 2 * r * w)))
    del u0

    # I: an (R, P) stripe into the (R, C) band at column 16,384; exact.
    dst = torch.zeros((r, c), device=dev)
    blk = torch.randn((r, p), generator=gen, device=dev)
    c0 = c // 2
    got = cuda_chol.stripe_write(dst.clone(), blk, c0)
    err = (got - cuda_chol.stripe_write_reference(dst.clone(), blk, c0)).abs().max().item()
    del got
    ms = time_ms(torch, lambda: cuda_chol.stripe_write(dst, blk, c0), 10)
    plain = time_ms(torch, lambda: cuda_chol.stripe_write_reference(dst, blk, c0), 10)
    check(f"stripe_write ({r}, {p}) into ({r}, {c}) at {c0} (exact)", err, 0.0, ms, plain)
    lib = time_ms(torch, lambda: dst[:, c0:c0 + p].copy_(blk), 10)
    results["stripe_write"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                                   **bound(0, 4 * 2 * r * p))
    del dst, blk, cur, lk

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


def lower_inv(torch, gen, b: int):
    """A B x B V = Ljj^{-1} as the inv option forms it: the inverse of the
    Cholesky factor of a well-conditioned SPD block."""
    g = torch.randn((b, b), generator=gen, device=gen.device)
    ld = torch.linalg.cholesky(g @ g.T / b + torch.eye(b, device=gen.device))
    eye = torch.eye(b, device=gen.device)
    return torch.linalg.solve_triangular(ld, eye, upper=False).contiguous()


def inv_and_trail_kernels(torch, gen, results: dict) -> None:
    """J and K at the in-core factor's shapes (C = 16,384, B = 256), each at
    its largest call: J's panel below the first diagonal block (R = 16,128,
    a strided view of the C x C matrix), K's last row solve (N = 16,384);
    L at the sharded TRSM's (P = 1: R = C = 16,384, B = 256, j0 = 8,192).
    tol: 1e-4 x the magnitude sum |a||b| of the worst output, as for B, and
    for L (in place, as H) plus 4 float32 ulps of max|S|."""
    from gpis_tpu_torch.linalg import cuda_chol

    dev = gen.device
    c, b = 16384, 256
    v = lower_inv(torch, gen, b)
    a = torch.randn((c, c), generator=gen, device=dev)
    acc = a[b:, :b]  # the panel of j0 = 0: rows j1.., columns [0, B), leading dimension C
    r = acc.shape[0]
    got = cuda_chol.panel_scale(acc, v)
    err = (got - cuda_chol.panel_scale_reference(acc, v)).abs().max().item()
    scale = (acc.abs() @ v.abs().T).max().item()
    del got
    ms = time_ms(torch, lambda: cuda_chol.panel_scale(acc, v), 20)
    plain = time_ms(torch, lambda: cuda_chol.panel_scale_reference(acc, v), 20)
    check(f"panel_scale R={r} B={b} (a strided view, ld {c})", err, 1e-4 * scale, ms, plain)
    lib = time_ms(torch, lambda: torch.matmul(acc, v.T), 20)
    # V is lower-triangular: out[:, c] sums c + 1 products.
    results["panel_scale"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                                  **bound(r * b * (b + 1), 4 * (2 * r * b + b * (b + 1) / 2)))
    del a, acc

    rhs = torch.randn((b, c), generator=gen, device=dev)
    got = cuda_chol.row_scale(v, rhs)
    err = (got - cuda_chol.row_scale_reference(v, rhs)).abs().max().item()
    scale = (v.abs() @ rhs.abs()).max().item()
    del got
    ms = time_ms(torch, lambda: cuda_chol.row_scale(v, rhs), 20)
    plain = time_ms(torch, lambda: cuda_chol.row_scale_reference(v, rhs), 20)
    check(f"row_scale B={b} N={c}", err, 1e-4 * scale, ms, plain)
    lib = time_ms(torch, lambda: torch.matmul(v, rhs), 20)
    results["row_scale"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                                **bound(c * b * (b + 1), 4 * (2 * b * c + b * (b + 1) / 2)))
    del rhs

    j0, row0 = c // 2, 0
    s0 = torch.randn((c, c), generator=gen, device=dev)
    l_band = torch.randn((c, c), generator=gen, device=dev) / b**0.5
    l_col = l_band[:, j0:j0 + b]  # column panel j of the band, leading dimension C
    wj = torch.randn((b, c), generator=gen, device=dev)
    wj[:, j0 + b:] = 0.0  # a lower-triangular W row panel
    got = cuda_chol.band_trail(s0.clone(), l_col, wj, j0, row0)
    want = cuda_chol.band_trail_reference(s0.clone(), l_col, wj, j0, row0)
    err = (got - want).abs().max().item()
    r_b, w = j0 + b - row0, j0 + b  # the live rows and columns
    untouched = torch.equal(got[:r_b], s0[:r_b]) and torch.equal(got[:, w:], s0[:, w:])
    del got, want
    scale = (l_col[r_b:].abs() @ wj[:, :w].abs()).max().item()
    tol = 1e-4 * scale + 4 * torch.finfo(torch.float32).eps * s0.abs().max().item()
    work = s0.clone()
    ms = time_ms(torch, lambda: cuda_chol.band_trail(work, l_col, wj, j0, row0), 10)
    plain = time_ms(torch, lambda: cuda_chol.band_trail_reference(work, l_col, wj, j0, row0), 10)
    check(f"band_trail R={c} C={c} B={b} j0={j0} row0={row0}", err, tol, ms, plain)
    if not untouched:
        fail("band_trail wrote outside its live rows and columns")
    lib = time_ms(torch, lambda: torch.addmm(s0[r_b:, :w], l_col[r_b:], wj[:, :w], alpha=-1), 10)
    rows = c - r_b
    results["band_trail"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                                 **bound(2 * rows * b * w, 4 * (2 * rows * w + rows * b + b * w)))
    del s0, l_band, l_col, wj, work


def phase2(torch, results: dict) -> None:
    from gpis_tpu_torch.data.gpis import fibonacci_sphere
    from gpis_tpu_torch.kernels import cuda_gram, cuda_joint, cuda_query
    from gpis_tpu_torch.kernels import gram as kg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    c, m, bw = 16384, 8192, 256
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

    # B, C and D at the blocked factorization's smallest capacity (4,096),
    # then timed at the slice's 16,384; D on a real 8,192-query kq chunk.
    factor_and_query_kernels(torch, gen, kq[:, :4096].contiguous(), bw, None)
    factor_and_query_kernels(torch, gen, kq, bw, results)
    del kq

    # D in the regime of the `_QSPLIT` note (C = 1024, noise 1e-3, where a
    # single-pass bf16 quad measured ~1e-2 absolute): float32 kernel against
    # a float64 plain run of the same GP.  Tol 2e-3 absolute, 5x below that.
    rng = np.random.default_rng(20260818)
    x64 = torch.as_tensor(rng.normal(size=(1024, 3)), device=dev)
    q64 = torch.as_tensor(rng.normal(size=(m, 3)), device=dev)
    y64 = torch.as_tensor(rng.normal(size=1024) * 0.2, device=dev)
    p = {"lengthscale": 0.8, "signal_variance": 1.0}
    k = cuda_gram.cov_reference("rbf", x64, x64, p, noise=torch.full_like(y64, 1e-3), sym=True)
    l64 = torch.linalg.cholesky(k)
    w64 = torch.linalg.solve_triangular(l64, torch.eye(1024, dtype=k.dtype, device=dev),
                                        upper=False)
    alpha64 = torch.cholesky_solve(y64[:, None], l64)[:, 0]
    kq64 = cuda_gram.cov_reference("rbf", q64, x64, p)
    mean_r, quad_r = cuda_query.staged_quad_reference(kq64, w64, alpha64)
    mean, quad = cuda_query.staged_quad(*(t.float().contiguous() for t in (kq64, w64, alpha64)))
    err_q = (quad.double() - quad_r).abs().max().item()
    err_m = (mean.double() - mean_r).abs().max().item()
    check("staged_quad quad C=1024 noise=1e-3 f32 vs f64", err_q, 2e-3)
    check("staged_quad mean C=1024 noise=1e-3 f32 vs f64 (tol 1e-4 x sum|kq||alpha|)",
          err_m, 1e-4 * (kq64.abs() @ alpha64.abs()).max().item())
    del x64, q64, k, l64, w64, kq64

    # E, then F with both generators at the slices' shapes.
    instances["joint_cov_cross"] = joint_cov_kernel(torch, gen, q, results)
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
                                 bound_ms=joint["bound_ms"], bound_by=joint["bound_by"])
    instances["fused_quad_value"] = {k: value[k] for k in ("ms", "plain_ms", "bound_ms",
                                                           "bound_by")}
    say(json.dumps({"instances": instances, "card": card_line()}))
    torch.cuda.empty_cache()
    ooc_kernels(torch, gen, results)
    torch.cuda.empty_cache()
    inv_and_trail_kernels(torch, gen, results)
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

    if "jax" in sys.modules:
        fail("jax was imported")
    jax_pkg = [m for m in sys.modules if m == "gpis_tpu" or m.startswith("gpis_tpu.")]
    if jax_pkg:
        fail(f"the JAX package was imported: {jax_pkg}")
    sources = {
        "cov": ("gpis_tpu_torch/csrc/cov.cu", "gpis_tpu/kernels/pallas_gram.py:197"),
        "panel_update": ("gpis_tpu_torch/csrc/chol.cu", "gpis_tpu/linalg/pallas_chol.py:180"),
        "row_update": ("gpis_tpu_torch/csrc/chol.cu", "gpis_tpu/linalg/pallas_chol.py:569"),
        "staged_quad": ("gpis_tpu_torch/csrc/query.cu", "gpis_tpu/kernels/pallas_query.py:319"),
        "joint_cov": ("gpis_tpu_torch/csrc/joint.cu", "gpis_tpu/kernels/pallas_joint.py:215"),
        "fused_quad": ("gpis_tpu_torch/csrc/fused_query.cu",
                       "gpis_tpu/kernels/pallas_query.py:404, "
                       "gpis_tpu/kernels/pallas_joint.py:367"),
        "gram_band": ("gpis_tpu_torch/csrc/cov.cu", "gpis_tpu/kernels/pallas_gram.py:173"),
        "gemm_nt_masked": ("gpis_tpu_torch/csrc/chol.cu", "gpis_tpu/linalg/pallas_chol.py:307"),
        "gemm_nn_acc_masked": ("gpis_tpu_torch/csrc/chol.cu",
                               "gpis_tpu/linalg/pallas_chol.py:380"),
        "stripe_write": ("gpis_tpu_torch/csrc/chol.cu", "gpis_tpu/linalg/pallas_chol.py:429"),
        "quad_band": ("gpis_tpu_torch/csrc/fused_query.cu",
                      "gpis_tpu/kernels/pallas_query.py:241, "
                      "gpis_tpu/kernels/pallas_joint.py:500"),
        "panel_scale": ("gpis_tpu_torch/csrc/chol.cu", "gpis_tpu/linalg/pallas_chol.py:461"),
        "row_scale": ("gpis_tpu_torch/csrc/chol.cu", "gpis_tpu/linalg/pallas_chol.py:488"),
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
