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
   twin's time (CUDA events).  Kernel A in float32 and float64, its four
   covariances in cross, Gram and band mode at ragged shapes, its pinned
   diagonal bit for bit (`cov_kernel_checks`), timed also at the
   committee's cross and the planner's M = 1 and M = 256 against C = 17,408
   (`cov_small_shapes`); A's line keeps the main path's Gram error as its
   max_abs_err and those checks' worst error over max(1, max|K|), per
   dtype, as cov_checks_rel.  The quads of Kernels D and F (the split-TF32
   tensor-core tile with the QUAD epilogue, F's kq generated in the tile)
   are held per query against the twin run in float64, at ragged shapes,
   twice bit for bit, and to the bias gate on nonnegative W and kq
   (`quad_kernel_checks`); float32 D's
   bits against a recorded sha256 at ragged shapes up to C = 20,480, every
   call twice (`tc_quad_bits`), and float32 F's, value and joint, in its
   four modes (`tc_fused_quad_bits`).  Plus the
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
   float64 session on the card must be refused (the card runs float32;
   float64 runs on the CPU).
4. The joint (surface-normal) slice: start(points, normals=...) on a
   4,992-point sphere (J = 21,504), the 64^3 grid, extract_surface, a
   65,536-point query and predict_gradient at 256 surface points.  Gates:
   surface RMSE < 0.02, min cos(normal, radial) > 0.99, no NaN, every
   kernel of the path launched by this run.
5. The out-of-core value slice: start(points, out_of_core=True) on phase
   3's cloud (C = 16,384, panel 1,024), the 64^3 grid, extract_surface and
   a 65,536-point query.  Gates: surface RMSE < 0.02, no NaN, the grid
   within 1e-2 of phase 3's in-core grid, every kernel of the path
   launched.
6. The out-of-core joint slice: the same on phase 4's cloud with normals
   (J = 20,480, panel 1,024), against phase 4's grid.
7. The host spill: ooc_fit on a 32,640-point sphere's training set
   (C = 32,768, panel 4,096) in a tiered store held to a 1 GB device budget,
   then a 65,536-point query.  Gates: spilled W panels, peak device memory
   under the budget plus the fit's own reserve, and the answer within 1e-2
   of a float64 plain PyTorch fit of the same set on the card (library
   Cholesky and triangular solve, `plain_posterior64`; in float32 the
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
   float64 runs follow the counted run, on the CPU); surface RMSE
   < 0.02 and no NaN; each out-of-core and the sharded grid within 1e-2 of
   the in-core grid after the same touches; surface_points within 1e-5 of
   f = 0 with >= 95 % of seeds converged; A, E, D, F, F band, B and C
   launched.
11. Marginal-likelihood hyperparameter optimization (config 3) through the
   entry points a user calls.  (a) BASELINE.md's config-3 bar: y drawn
   from an RBF GP of lengthscale 0.5 on 4,000 points (capacity 4,096, so
   the MLL's Gram is Kernel A under `gram_ad` and its factor Kernel B
   under `blocked_cholesky_ad`), `optimize` in float32 from 2.0 (4x off)
   for 150 Adam steps; gates: the lengthscale within 10 % of 0.5; the
   start's gradient in float64 (Kernel A, the library's factor) within
   1e-4 (norm-wise) of a central difference and within 1e-6 of the CPU
   twins', and the float32 one within 1e-3 of it.  (b) Phase 3's value session (float32,
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
   plus 1e-4 x max|g|, two steps and the refit.  (e) Phase 6's out-of-core joint
   session, one stream step, and phase 9's one-rank NCCL sharded model,
   method="distributed", two steps.  Each refit's grid in (d) and (e)
   within 1e-2 of the in-core pipeline's at the refit's hyperparameters,
   and every refit's surface RMSE < 0.02.
   Launches: A and B in (a) and (b), E and B in (c), A band, G, H, I and B
   in (d), E, G, H and I in (e)'s out-of-core run, A band and G in its
   sharded one.
12. The exploration loop and its service.  (a) Phase 10's value
   configuration (capacity 17,408) on its cap-less sphere behind
   `make_server(session, port=0)` in a thread, driven by a urllib client:
   /health, /start, /done (false: the cap is unseen), then four rounds of
   /next_best_path and an /update of 64 contacts along the path, moved
   radially onto the true sphere; then a 65,536-point /query, /stats,
   /mesh?resolution=32 and one malformed /query (a 400).  Gates: every
   other answer a 200; the first target in the cap (its direction's z >
   0.7); reached_threshold as the target's variance says; no empty path
   (each call's projection attempts and failures printed); after each
   round the variance fell at every contact in the cap, and at the contacts
   on the observed part it fell on a float64 replay (on the CPU) and rose in float32 by
   at most the quad's error there; the cap's maximum variance fell over the
   rounds; extract_surface(64) RMSE < 0.02, no NaN.  The crash: /save, the
   node and its session dropped, a new node /loads the file: its 65,536-
   point query equals the saved one to the bit, and after one pending
   batch replayed there and on an uninterrupted copy they agree within
   1e-6; save and load seconds and the file's bytes printed.  (b) Phase
   10's joint (J = 21,504), out-of-core value and one-rank NCCL sharded
   models: one next_best_path and one is_done each, timed; the target in
   the cap, no NaN; the joint and sharded checkpoints restored to the bit;
   the out-of-core checkpoint (its W panels under path + ".w/") too.
   Launches of (a) and (b):
   A, B, C, D, E, F, A band and F band.  (c) A checkpoint saved without
   its factor (C = 4,096) refit on the card (Kernels A, B, C) within 1e-6
   of the saved model.  (d) Kernel D at the planner's M = 1, 32, 256
   and 2,048 (C = 17,408) held per query to its float64 twin (1e-4), twice
   bit for bit, and timed beside the library's W kq^T and its bound.
13. The local-expert committee (`gp/experts.py`) at the JAX package's
   committee scale, through ObjectModelSession.  (a) bench/experts_scale.py's
   defaults: a 100,000-point sphere, rbf, lengthscale 1.0, noise 1e-4, 64
   touch slots, float32, start(experts=16, expert_gate=8): E 16 x B 7,168,
   W alone (the 4e9-byte rule drops L); the 64^3 grid (256 gated pairs of
   A then D), extract_surface and a 65,536-point query; fit_s, query_s,
   peak memory and W's bytes.  Gates: RMSE < 0.01 (that script's);
   no NaN; every variance in [the committee floor, k0] (the floor: the
   gated experts all clamped at eps max(16, 0.5 B) k0; a combine cannot go
   below it); A, B, C and D launched.  (b) The same committee ungated at
   4,096 surface points: the gate-8 mean within 5e-2 (the JAX tests' bar).
   (c) The sphere with its cap z > 0.8 left out (phase 10's), the same
   fit, four batches of 64 contacts into the cap: at every touched point
   the variance fell (or sat at the committee floor already), |mean| <=
   1e-3, and each routed expert's n_touch rose.  (d) One PoE objective step
   timed, then optimize_hyperparameters(method="poe", steps=3) with its
   refit replaying the 256 touches: the best MLL above the start's, the
   refit's RMSE < 0.01.  (e) save, load, and the restored session's
   65,536-point query equal to the bit; /start with experts through
   make_server answering 200, and /update's summed n_touch.  (f)
   BENCH_EXPERTS_JOINT.json's shape: a 32,768-point sphere with normals, E
   16, gate 16 (C 2,304, J 10,240), the 64^3 grid, extract_surface and the
   normals at 256 surface points: RMSE < 0.01, min cos(normal, radial) >
   0.99, E launched.  Launches are counted over (a)-(f).  After the count,
   expert 0 of (a) and of (f) is fit again split by CUDA events (Gram,
   factor, W, the Newton step), and its refined W must lie within 8 ulps
   of max|W| of its float32 factor's exact inverse (float64), which the raw
   W misses by 30-36 and the step with a float32 residual by ~60
   (scripts/torch_committee_newton.py): the step exists to remove that
   error.  (g) One gated pair of (a) and of (f), the cross (A or E) against its
   twin and D per query against float64 (1e-4), timed beside the twin and
   the library's W kq^T.  ~66 s.
14. The command line, `gpis_tpu_torch.cli.main.main` in this process and
   once `python -m gpis_tpu_torch.cli.main query` as a new one.  Phase 10's
   cap-less sphere (16,256 points, 256 touch slots, C 17,408) written as a
   binary PLY (`data.io.save_ply`, read back through the C++ extractor),
   the configuration from a --config JSON: fit --profile (a Chrome trace
   left in its directory), mesh --resolution 64 --html, query at 4,096
   points, explore --json, update with 64 contacts in the cap, hyperopt
   --steps 5, explore-viz; phase 4's cloud fit --normals; phase 13's
   100,000 points fit --experts 16 --expert-gate 8; phase 7's cloud
   (C 32,768) fit --out-of-core (W under path + ".w/"), then mesh
   (48^3) and query.  Gates: every verb exits 0; the mesh PLY's surface
   RMSE < 0.02 (both meshes), no NaN; each checkpoint (value, joint,
   committee, out of core) loaded by a fresh session answers at 4,096
   points as the session that saved it, to the bit, and the query verb's
   lines (and the new process's) are that answer formatted; after update
   the variance fell at every contact; hyperopt's history has no NaN and
   its best MLL is above the start's; A, B, C, D or F, E, G, H and I
   launched inside the verbs (the launches of the checks are left out).
   Each verb's seconds, and the checkpoints' bytes with their save and
   load seconds, printed beside the card.
15. The sharded joint fit (`gp/sharded_joint.py`) on a one-rank NCCL
   group (phase 9's set-up, the communicator warmed and timed apart):
   phase 4's cloud and configuration, float32, J = 4 x 5,120 + 256 touch
   slots = 20,736, block 256, its model in a session (a one-rank mesh
   session keeps the single-card path, as phase 11's sharded run does):
   the 64^3 grid, extract_surface, the normals at 256 surface points, one
   update of 64 contacts at 1.3 x the radius, three method="distributed"
   hyperopt steps with their refit (the touches replayed), save and load.
   Gates: the grid within 1e-4 of phase 4's in-core joint grid (float32,
   two factor orders), RMSE < 0.02, min cos(normal, radial) > 0.99, no
   NaN, at every contact the variance fell and the mean moved toward its
   target, the best MLL above the start's, the restored query equal to the
   bit; E (in band mode), G, L and F band (joint columns) launched.  Fit,
   grid, update, hyperopt, save and load seconds, peak memory and the E,
   F band and L launches printed.
16. The two-phase out-of-core fit on phase 7's problem (C 32,768, panel
   4,096, the 1 GB budget: panels 4-7 of L and of W on disk).  (a)
   `ooc_factor_phase` in a fresh `python` process, `ooc_solve_phase(
   stop_after=4)` in a second and the resumed solve phase in a third (its
   TRSM starting at panel 4, after W panels 0-3 and with L panels 0-3
   gone), then the 65,536-point query, within 1e-5 of phase 7's
   in-process fit (the same kernels in the same order).  (b) On the same
   factor (its L panels hard-linked), `ooc_solve_phase(fused_query=...,
   keep_w=False)`: the TRSM-fused query within 1e-4 of (a)'s post-hoc
   query and the last sweep's W panels not written.  (c) `l_codec=
   "int16"` with `defer_alpha`: `ooc_residual_check` passes on the clean
   fit and refuses each fit whose L codes were halved on disk: in a
   sampled block's own rows, in a 256-row block of the panel farthest from
   the sampled rows, and in all of that panel (alpha carries the damage to
   the sampled rows).  (d) `w_dtype=
   float16` on (a)'s factor: the mean within 1e-4 of (a)'s (alpha never
   reads W), the variance's gap to (a)'s within 0.2 (root mean square) and
   0.7 (99th percentile), from the JAX package's float32 readings on the
   CPU, and an update refused.  (e) One split stream-objective step
   (`ooc_factor_phase(defer_alpha=True)`, `ooc_mll_and_grad_solve_phase`)
   on phase 3's training set (panel 1,024) within 1e-4 (MLL, relative)
   and each gradient component within 1e-3 of itself in the one-call
   `ooc_mll_and_grad`.  Each process's seconds, the bytes on disk and the
   residuals printed; a failed process fails the run.  Launches: the
   processes' (each prints its own), (b)'s and (e)'s.
17. The headline bench: `python -m gpis_tpu_torch.cli.main bench` in a
   fresh process (`gpis_tpu_torch/cli/bench.py`, the root bench.py's
   in-core path): a 16,256-point sphere, rbf, lengthscale 0.4, noise 1e-3,
   C 16,384, float32; an untimed warm-up round with its noise ladder, then
   one timed fit (Gram, in-place factor, in-place W, alpha = W^T (W y))
   and one timed 64^3 grid in 32 chunks of 8,192, saved with `--save-grid`.
   Its stdout JSON line is printed with the card's line and the grid's
   gaps to a float64 plain PyTorch fit of the same inputs at 8,192 grid
   points (`bench_reference`).  Gates: the process exits 0 with one stdout
   line; ok true; surface RMSE < 1.2e-3; n_train 16,384 and n_query
   262,144; value = fit_s + query_s to rounding; no recorded BENCH_* key;
   the process's peak memory at most one C x C matrix and one chunk's kq
   plus 0.5 GB (2.11 GB); the mean's and the variance's gaps within
   BENCH_MEAN_GAP and BENCH_VAR_GAP; A, B, C and D launched (its stderr's
   launches line, both rounds).

Kernel E is held to its twin in float32 (1e-5 x max|K|) and float64 (1e-10)
for the three covariances with coincident points, at an aligned and a
ragged layout (J % 4 == 3), as value rows and as an off-tile band with
noise, and on general metadata, over NaN-filled outputs, twice bit for bit
(`joint_kernel_checks`); then timed at the Gram, the cross and phase 6's
band (the band by the card's time, behind a spin kernel).
Phase 2 also holds the out-of-core kernels (I, and A and F in band mode)
to their twins at phase 7's shapes, I bit for bit also at its scalar edges
(heads and tails, odd pitches, float64, 70,000 rows).  B, C, G, H, J, K and
L, one split-TF32 tensor-core kernel that takes float32 only (C, H, K and
L its NN layout, B, G and J its NT layout), are held to their twins run in float64
at 2e-6 x sum|a||b| of the worst output (B, G, H and L plus 4 ulps of
max|S| or max|U|), and to a bias gate on nonnegative operands, |mean (out
- twin) / sum|a||b|| <= 2e-8, for B and G with a = b (sums of squares on
the diagonal); L also leaves S bit-identical outside its live block.  C's and
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
# Phase 15's one-rank sharded joint grid against phase 4's in-core joint
# grid: float32, the same covariance, two factor orders (read 9.6e-6).
SHARDED_JOINT_GRID_GAP = 1e-4
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
# sha256 of float32 D's (mean, quad) at fixed inputs (`tc_quad_digest`),
# recorded on an H100 with the lockstep body D had before its warp-specialised
# one.  D's plan keeps every tile whole, so its bits do not depend on the
# multiprocessor count.
TC_QUAD_SHA256 = "4cc23065ac532e3d8be0161d543ea905f2cb8fa762276414dacc90b0ec21c0c8"
TC_QUAD_MS = (1, 127, 129, 1000, 8192)
TC_QUAD_CS = (1000, 1152, 20480)
# sha256 of float32 F's outputs at fixed inputs (`tc_fused_quad_digest`):
# fused_quad's (mean, quad) and quad_band's quad, value and joint, recorded
# on an H100 with the lockstep body F had before it joined D's
# warp-specialised one.  Its plan keeps every tile whole, as D's.
TC_FUSED_QUAD_SHA256 = "3a68b3df6e6225ecc95bc68502b445863527b564296dd2d70923f4a35154fe27"
TC_FUSED_BANDS = ((300, 0), (300, 700), (300, 28672))  # (R, row0)
TC_FUSED_BAND_MS = (129, 8192)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    from gpis_tpu_torch.utils.provenance import card_line as line

    try:
        return line()
    except RuntimeError as e:
        fail(str(e))


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
    1/sqrt(i+1), so every row tile of W carries a share of each query's
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


def tc_quad_digest(torch) -> tuple[str, list]:
    """sha256 over float32 D's (mean, quad) at M in TC_QUAD_MS queries
    against C in TC_QUAD_CS (kq ragged at its row and k edges: M and C off
    the 128 tile and C = 1,000 off the 32-deep chunk), on `fixed_matrix`
    inputs with W lower-triangular; each call made twice.  Returns the digest
    and the shapes whose second call gave other bits than the first."""
    import hashlib

    from gpis_tpu_torch.kernels import cuda_query

    dev = torch.device("cuda")
    h, unstable = hashlib.sha256(), []
    for c in TC_QUAD_CS:
        w = fixed_matrix(torch, c, c, 8, dev).tril_()
        alpha = fixed_matrix(torch, 1, c, 9, dev)[0]
        kq = fixed_matrix(torch, max(TC_QUAD_MS), c, 10, dev)
        for m in TC_QUAD_MS:
            mean, quad = cuda_query.staged_quad(kq[:m], w, alpha)
            again = cuda_query.staged_quad(kq[:m], w, alpha)
            if not (torch.equal(mean, again[0]) and torch.equal(quad, again[1])):
                unstable.append((m, c))
            h.update(mean.cpu().numpy().tobytes())
            h.update(quad.cpu().numpy().tobytes())
        del w, alpha, kq
    torch.cuda.empty_cache()
    return h.hexdigest(), unstable


def tc_quad_bits(torch) -> None:
    """D's warp-specialised body must give the lockstep body's bits: its
    digest against the recorded one (TC_QUAD_SHA256), every call twice."""
    digest, unstable = tc_quad_digest(torch)
    same = digest == TC_QUAD_SHA256
    say(f"  D sha256 {digest} {'ok' if same else 'FAILED'} (recorded: {TC_QUAD_SHA256})")
    if unstable:
        fail(f"float32 D gave other bits on a second call at (M, C) {unstable}")
    if not same:
        fail("float32 D no longer gives its recorded bits")


def fused_columns(torch, kind: str, c: int, dev):
    """F's column metadata of `c` columns on fixed inputs: value columns
    x (c, 3) in [-1, 1)^3, or the packed joint columns of c // 4 such
    points (their value rows, then a gradient row an axis)."""
    from gpis_tpu_torch.kernels import cuda_joint

    if kind == "value":
        return fixed_matrix(torch, c, 3, 11, dev) * 2.0
    x = fixed_matrix(torch, c // 4, 3, 12, dev) * 2.0
    return cuda_joint.pack_meta(cuda_joint.joint_meta(x))


def tc_fused_quad_digest(torch) -> tuple[str, list]:
    """sha256 over float32 F's outputs on `fixed_matrix` inputs (queries in
    [-1, 1)^3, rbf at lengthscale 0.4), value and joint: fused_quad's (mean,
    quad) at M in TC_QUAD_MS against C in TC_QUAD_CS (J for the joint
    generator), W lower-triangular; quad_band's quad at M in
    TC_FUSED_BAND_MS for each (R, row0) of TC_FUSED_BANDS (R off the 128
    tile, row0 on the chunk and off it), each band of width row0 + R, lower
    triangular from row0 on.  Each call made twice.  Returns the digest and
    the shapes whose second call gave other bits than the first."""
    import hashlib

    from gpis_tpu_torch.kernels import cuda_query

    dev = torch.device("cuda")
    p = {"lengthscale": 0.4, "signal_variance": 1.0}
    q = fixed_matrix(torch, max(TC_QUAD_MS), 3, 13, dev) * 2.0
    h, unstable = hashlib.sha256(), []

    def digest(what, run):
        first, again = run(), run()
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            unstable.append(what)
        for out in first:
            h.update(out.cpu().numpy().tobytes())

    for kind in ("value", "joint"):
        for c in TC_QUAD_CS:
            cols = fused_columns(torch, kind, c, dev)
            w = fixed_matrix(torch, c, c, 8, dev).tril_()
            alpha = fixed_matrix(torch, 1, c, 9, dev)[0]
            for m in TC_QUAD_MS:
                digest((kind, m, c), lambda: cuda_query.fused_quad(kind, "rbf", q[:m], cols, p,
                                                                   alpha, w))
            del w, alpha
        for r, row0 in TC_FUSED_BANDS:
            cols = fused_columns(torch, kind, row0 + r, dev)
            band = fixed_matrix(torch, r, row0 + r, 14, dev).tril_(row0)
            for m in TC_FUSED_BAND_MS:
                digest((kind, "band", m, r, row0), lambda: (cuda_query.quad_band(
                    kind, "rbf", q[:m], cols, p, band, row0),))
            del band
    torch.cuda.empty_cache()
    return h.hexdigest(), unstable


def tc_fused_quad_bits(torch) -> None:
    """F in D's warp-specialised body must give its lockstep body's bits:
    its digest against the recorded one (TC_FUSED_QUAD_SHA256), every call
    twice."""
    digest, unstable = tc_fused_quad_digest(torch)
    same = digest == TC_FUSED_QUAD_SHA256
    say(f"  F sha256 {digest} {'ok' if same else 'FAILED'} (recorded: {TC_FUSED_QUAD_SHA256})")
    if unstable:
        fail(f"float32 F gave other bits on a second call at {unstable}")
    if not same:
        fail("float32 F no longer gives its recorded bits")


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
    block (a = b = the band, k0 24,576)."""
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
    nonnegative lower-triangular V) at the deepest step of each."""
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
    operands.  Then L timed beside its float32 twin and `addmm`: the card's
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
    for bit."""
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

    # F's four modes and D at ragged shapes, float32 against float64 twins;
    # each call twice, bit for bit.
    jcols = cuda_joint.pack_meta(cuda_joint.joint_meta(
        torch.as_tensor(fibonacci_sphere(250), dtype=torch.float32, device=dev)))  # J = 1,000
    vcols = x[:1000].contiguous()
    for kind, cols in (("value", vcols), ("joint", jcols)):
        n = cols.shape[0]
        for m in (129, 1000):
            qm = q[:m]
            w = quad_test_w(torch, n, gen)
            alpha = torch.randn((n,), generator=gen, device=dev)
            kq64 = cuda_query.generated_kq(kind, "rbf", qm.double(), cols.double(), p)
            mean_r, quad_r = cuda_query.staged_quad_reference(kq64, w.double(), alpha.double())
            runs = {"fused_quad": lambda: cuda_query.fused_quad(kind, "rbf", qm, cols, p, alpha,
                                                                w)}
            if kind == "value":
                kq = kq64.float()
                runs["staged_quad"] = lambda: cuda_query.staged_quad(kq, w, alpha)
            for name, run in runs.items():
                (mean, quad), again = run(), run()
                shape = f"float32 {kind} M={m} {'C' if kind == 'value' else 'J'}={n}"
                check(f"{name} {shape} quad, per query", quad_rel_err(torch, quad, quad_r),
                      QUAD_REL_TOL, err_name="max_rel_err")
                check(f"{name} {shape} mean", (mean.double() - mean_r).abs().max().item(),
                      QUAD_REL_TOL * (kq64.abs() @ alpha.double().abs()).max().item())
                check(f"{name} {shape} run twice", float(not (
                    torch.equal(mean, again[0]) and torch.equal(quad, again[1]))), 0.0,
                    err_name="bits differ")
        for rows, row0 in ((300, 0), (300, 700), (128, 256)):
            qm = q[:1000]
            w = band_test_w(torch, rows, row0, row0 + rows, gen)
            quad = cuda_query.quad_band(kind, "rbf", qm, cols, p, w, row0)
            quad_r = cuda_query.quad_band_reference(kind, "rbf", qm.double(), cols.double(), p,
                                                    w.double(), row0)
            shape = f"float32 {kind} M=1000 R={rows} row0={row0}"
            check(f"quad_band {shape}, per query", quad_rel_err(torch, quad, quad_r),
                  QUAD_REL_TOL, err_name="max_rel_err")
            check(f"quad_band {shape} run twice", float(not torch.equal(
                quad, cuda_query.quad_band(kind, "rbf", qm, cols, p, w, row0))), 0.0,
                err_name="bits differ")


COV_LENGTHSCALE = {"rbf": 0.8, "laplace": 0.8, "inverse_multiquadric": 0.8, "thin_plate": 2.5}


def cov_kernel_checks(torch, gen, results: dict) -> None:
    """Kernel A against its twin at its edges, in float32 and float64, for
    the four covariances: the cross of m in {1, 130, 8,192} query rows
    against n in {17, 131, 16,383, 16,384} columns (n % 4 != 0 takes the
    scalar stores; 17, 131 and 16,383 end mid-tile), the Gram with noise at
    each n, and each band of m < n rows at row0 = (n - m) - (n - m) // 3
    (off every tile: the diagonal enters tiles mid-tile) with noise.  The
    columns are n points of the Fibonacci sphere with 8 of them repeated at
    other indices (coincident points off the diagonal), the queries
    uniform in [-1.5, 1.5]^3.  Every output is allocated over NaN (a missed
    element shows), a second call must repeat the first bit for bit, and
    where the diagonal is pinned (Gram and band) it must equal the twin's
    bit for bit (k(0) + noise[i], the same two roundings).  Tolerance:
    1e-5 x max(1, max|K|) in float32, 1e-12 x max(1, max|K|) in float64
    (only the rounding of r2 and k differs)."""
    from gpis_tpu_torch.data.gpis import fibonacci_sphere
    from gpis_tpu_torch.kernels import cuda_gram

    dev = gen.device
    worst = {"float32": 0.0, "float64": 0.0}  # err / max(1, max|K|)
    for dt in (torch.float32, torch.float64):
        q = torch.rand((8192, 3), generator=gen, device=dev, dtype=dt) * 3.0 - 1.5
        for n in (17, 131, 16383, 16384):
            x = torch.as_tensor(fibonacci_sphere(n), dtype=dt, device=dev)
            x[n // 2:n // 2 + 8] = x[:8]  # distinct indices, coincident points
            noise = torch.rand((n,), generator=gen, device=dev, dtype=dt) * 9e-3 + 1e-3
            cases = [(f"cross {m}x{n}", q[:m], None, False, None) for m in (1, 130, 8192)]
            cases.append((f"gram {n}x{n}+noise", x, noise, True, None))
            for m in (1, 130, 8192):
                if m < n:
                    row0 = (n - m) - (n - m) // 3
                    cases.append((f"band {m}x{n} at row0 {row0}+noise", x[row0:row0 + m],
                                  noise[row0:row0 + m], True, row0))
            for name, ls in COV_LENGTHSCALE.items():
                p = {"lengthscale": ls, "signal_variance": 1.1}
                for mode, a, nz, sym, row0 in cases:
                    want = cuda_gram.cov_reference(name, a, x, p, noise=nz, sym=sym,
                                                   row0=row0 or 0)
                    poisoned_empty(torch, want.shape, dev, dt)
                    got = cuda_gram.cov(name, a, x, p, noise=nz, sym=sym, row0=row0)
                    poisoned_empty(torch, want.shape, dev, dt)
                    again = cuda_gram.cov(name, a, x, p, noise=nz, sym=sym, row0=row0)
                    err = (got - want).abs().max().item()
                    scale = max(1.0, want.abs().max().item())
                    tol = (1e-5 if dt == torch.float32 else 1e-12) * scale
                    what = f"cov {name} {mode} {str(dt)[6:]}"
                    if not err <= tol:
                        check(f"{what} (tol {tol / scale:.0e} x max(1, max|K|))", err, tol)
                    if not torch.equal(got, again):
                        check(f"{what} run twice", 1.0, 0.0, err_name="bits differ")
                    r0 = row0 or 0
                    diag = (slice(None), slice(r0, r0 + a.shape[0]))
                    if sym and not torch.equal(got[diag].diagonal(), want[diag].diagonal()):
                        check(f"{what} pinned diagonal against the twin's", 1.0, 0.0,
                              err_name="bits differ")
                    worst[str(dt)[6:]] = max(worst[str(dt)[6:]], err / scale)
                    del want, got, again
            say(f"  cov {str(dt)[6:]} n={n}: {len(cases)} shapes x {len(COV_LENGTHSCALE)} "
                f"covariances within tol, diagonals bit-equal, repeated bit for bit")
        del q, x, noise
    say(f"  cov_kernel_checks: worst err / max(1, max|K|) {worst['float32']:.3e} in float32, "
        f"{worst['float64']:.3e} in float64")
    results["cov_checks_rel"] = worst


def cov_small_shapes(torch, q, params) -> dict:
    """Kernel A timed (the card's time, behind a spin) at the committee's
    cross (8,192 queries against an expert's 7,168 points) and the
    planner's chart predict (M = 1) and padded round (M = 256) against
    C = 17,408 points, each held to the twin at 1e-5."""
    from gpis_tpu_torch.data.gpis import fibonacci_sphere
    from gpis_tpu_torch.kernels import cuda_gram

    out = {}
    for key, m, c in (("cov_committee", 8192, 7168), ("cov_m1", 1, 17408),
                      ("cov_m256", 256, 17408)):
        x = torch.as_tensor(fibonacci_sphere(c), dtype=torch.float32, device=q.device)
        a = q[:m]
        err = (cuda_gram.cov("rbf", a, x, params)
               - cuda_gram.cov_reference("rbf", a, x, params)).abs().max().item()
        ms = device_ms(torch, lambda: cuda_gram.cov("rbf", a, x, params), 20)
        plain = device_ms(torch, lambda: cuda_gram.cov_reference("rbf", a, x, params), 5)
        check(f"cov cross M={m} C={c}", err, 1e-5, ms, plain)
        out[key] = dict(ms=ms, plain_ms=plain, **bound(10 * m * c, 4 * (m * c + 3 * m + 3 * c)))
    return out


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

    # A: covariance tile, at its edges (`cov_kernel_checks`), then timed at
    # the slices' shapes.  Values are <= k(0) + noise ~ 1; the two sides
    # differ only by the rounding of r2 and exp (a few ulp): tol 1e-5.
    cov_kernel_checks(torch, gen, results)
    got = kg.gram("rbf", x, params, noise)
    want = cuda_gram.cov_reference("rbf", x, x, params, noise=noise, sym=True)
    err = (got - want).abs().max().item()
    del got, want
    ms = time_ms(torch, lambda: kg.gram("rbf", x, params, noise), 5)
    plain = time_ms(torch, lambda: cuda_gram.cov_reference("rbf", x, x, params, noise=noise,
                                                           sym=True), 3)
    check(f"cov gram C={c}", err, 1e-5, ms, plain)
    # About ten operations (and one exp) an element; one store an element.
    results["cov"] = dict(max_abs_err=err, cov_checks_rel=results["cov_checks_rel"], ms=ms,
                          plain_ms=plain, library_ms=None,
                          **bound(10 * c * c, 4 * (c * c + 7 * c)))
    kq = kg.cross_cov("rbf", q, x, params)
    err_x = (kq - cuda_gram.cov_reference("rbf", q, x, params)).abs().max().item()
    ms_x = time_ms(torch, lambda: kg.cross_cov("rbf", q, x, params), 5)
    plain_x = time_ms(torch, lambda: cuda_gram.cov_reference("rbf", q, x, params), 3)
    check(f"cov cross M={m} C={c}", err_x, 1e-5, ms_x, plain_x)
    instances = {"cov_cross": dict(ms=ms_x, plain_ms=plain_x,
                                   **bound(10 * m * c, 4 * (m * c + 3 * m + 3 * c)))}
    instances.update(cov_small_shapes(torch, q, params))

    # D, F and F band checked at their edges (`quad_kernel_checks`: C = 4,096
    # on a real kq, the `_QSPLIT` regime, the bias gate), then D timed at the
    # slice's 16,384 on a real 8,192-query kq chunk.
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
    tc_quad_bits(torch)
    tc_fused_quad_bits(torch)
    nt_kernel_checks(torch, gen, results)
    nt_kernel_times(torch, gen, results)
    inv_and_trail_kernels(torch, gen, results)
    inv_kernel_times(torch, gen, results)
    torch.cuda.empty_cache()


def phase3(torch, launches) -> dict:
    from gpis_tpu_torch import ModelConfig, ObjectModelSession
    from gpis_tpu_torch.data.gpis import fibonacci_sphere

    # The card runs float32 (its tensor-core kernels take nothing else): a
    # float64 session there is refused; float64 runs on the CPU.
    try:
        ObjectModelSession(ModelConfig(dtype="float64"), device="cuda")
    except ValueError:
        pass
    else:
        fail("a float64 session on the card was not refused")

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


def ooc_session_phase(torch, launches, incore, normals: bool) -> dict:
    """The out-of-core slice through ObjectModelSession.start(out_of_core=True)
    on an in-core phase's cloud, held to that phase's grid."""
    from gpis_tpu_torch import ObjectModelSession

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
    rmean, rvar = plain_posterior64(torch, cfg.kernel, ts.x, ts.y, ts.noise, params, q)
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
        "incore_float32_jitter": jitter32,
        "incore_float32_gap_mean": gap32_mean, "incore_float32_gap_var": gap32_var,
        "card": card_line(),
    }))
    if not finite:
        fail("NaN or inf in the host-spill posterior")
    if not spilled:
        fail("the 1 GB budget spilled no W panel")
    check("host spill: peak device memory against budget + reserve", peak,
          SPILL_BUDGET + reserve, err_name="bytes")
    check("host spill: query against a float64 plain fit: mean", gap_mean, OOC_GRID_GAP)
    check("host spill: query against a float64 plain fit: var", gap_var, OOC_GRID_GAP)
    require_launches(counts, ("gram_band", "panel_update") + OOC_KERNELS, "host spill")
    spill = {"x": ts.x.cpu().numpy(), "y": ts.y.cpu().numpy(), "noise": ts.noise.cpu().numpy(),
             "q": q.cpu().numpy(), "mean": mean, "var": var, "cfg": cfg, "params": params}
    return counts, spill


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


def value_float64(cfg, pts, batches, seen):
    """Phase 10's value session in float64 on the CPU: the variance at the
    observed touches `seen` after the fit, and before and after their own
    batch (which follows `batches`), with the mean after it."""
    import dataclasses

    from gpis_tpu_torch import ObjectModelSession

    sess = ObjectModelSession(dataclasses.replace(cfg, dtype="float64"), device="cpu")
    sess.start(pts.astype(np.float64))
    var_fit = sess.query(seen)[1]
    for b in batches:
        sess.update(b.astype(np.float64))
    var0 = sess.query(seen)[1]
    sess.update(seen.astype(np.float64))
    mean, var = sess.query(seen)
    return var_fit, var0, mean, var


def joint_refit_float64(cfg4, jpts, normals, batches, touched):
    """Phase 10's joint session in float64 on the CPU: the variance at the
    touched points before the updates and after the last batch's refit."""
    import dataclasses

    from gpis_tpu_torch import ObjectModelSession

    sess = ObjectModelSession(dataclasses.replace(cfg4, dtype="float64"), device="cpu")
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
    the float32 sessions only; the float64 runs that hold them follow, on
    the CPU."""
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

    # Float64 on the CPU, after the counted run.  The observed batch: the
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
    # float64 on the CPU, and the float32 variance to the float64 one.
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

CFG3_N, CFG3_C = 4000, 4096  # config 3's bar: points, capacity (Kernels A and B)
CFG3_LS, CFG3_LS0, CFG3_NOISE = 0.5, 2.0, 1e-2  # the truth, the start 4x off, the noise
CFG3_STEPS = 150
CFG3_LS_TOL = 0.10  # the lengthscale within 10 % of the truth
FD_REL = 1e-4  # the gradient against a central finite difference (BASELINE.md config 3)
FD_STEP = 1e-5
CPU_REL = 1e-6  # the card's float64 gradient against the CPU twins'
F32_GRAD_REL = 1e-3  # the card's float32 gradient against its float64 one (norm-wise)
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
    """BASELINE.md's config-3 bar on the card: y drawn from an RBF GP of
    lengthscale 0.5 on 4,000 points (capacity 4,096, so the MLL's Gram is
    Kernel A and its factor Kernel B under `blocked_cholesky_ad`),
    `optimize` in float32 from lengthscale 2.0.  The start's gradient in
    float64 (Kernel A, the library's factor) against a central finite
    difference and against the CPU twins', and the float32 one against
    it."""
    from gpis_tpu_torch.gp import hyperopt as ho
    from gpis_tpu_torch.gp import regression as gpr
    from gpis_tpu_torch.kernels import gram as kg

    rng = np.random.default_rng(11)
    x = torch.tensor(rng.uniform(-1.0, 1.0, size=(CFG3_N, 3)), device="cuda")
    k = kg.gram_reference("rbf", x, {"lengthscale": CFG3_LS, "signal_variance": 1.0},
                          noise=CFG3_NOISE)
    y = torch.linalg.cholesky(k) @ torch.tensor(rng.normal(size=CFG3_N), device="cuda")
    del k
    xp, yp, noisep = gpr.pad_training(x, y, CFG3_NOISE, CFG3_C, 1e10)
    xp32, yp32, noisep32 = xp.float(), yp.float(), noisep.float()
    torch.cuda.synchronize()
    launches.clear()
    t0 = time.perf_counter()
    res = ho.optimize("rbf", xp32, yp32, noisep32,
                      {"lengthscale": CFG3_LS0, "signal_variance": 1.0}, n_real=CFG3_N,
                      steps=CFG3_STEPS)
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t0
    counts = dict(launches)
    ls = res.params["lengthscale"]
    within = [abs(v - CFG3_LS) / CFG3_LS <= CFG3_LS_TOL for v in res.lengthscale_history]
    steps_to_bar = next((i for i in range(len(within)) if all(within[i:])), None)
    theta0 = [np.log(CFG3_LS0), 0.0]
    lib = gpr._library_chol
    mll0, g = mll_and_grad(torch, xp, yp, noisep, CFG3_N, theta0, chol_impl=lib)
    fd = []
    for i in range(2):
        up, dn = list(theta0), list(theta0)
        up[i] += FD_STEP
        dn[i] -= FD_STEP
        fd.append((mll_and_grad(torch, xp, yp, noisep, CFG3_N, up, chol_impl=lib)[0]
                   - mll_and_grad(torch, xp, yp, noisep, CFG3_N, dn, chol_impl=lib)[0])
                  / (2 * FD_STEP))
    _, g_cpu = mll_and_grad(torch, xp.cpu(), yp.cpu(), noisep.cpu(), CFG3_N, theta0)
    _, g32 = mll_and_grad(torch, xp32, yp32, noisep32, CFG3_N, theta0)
    out = {"config3": "rbf ls 0.5 from 2.0, float32", "n": CFG3_N, "capacity": CFG3_C,
           "steps": CFG3_STEPS, "lengthscale": ls, "noise_scale": res.noise_scale,
           "steps_to_bar": steps_to_bar, "optimize_s": opt_s, "step_s": opt_s / CFG3_STEPS,
           "mll_start": mll0, "mll_best": res.mll, "grad_start": g.tolist(), "grad_fd": fd,
           "grad_cpu": g_cpu.tolist(), "grad_start_f32": g32.tolist(), "launches": counts,
           "card": card_line()}
    say(json.dumps(out))
    check("config 3: lengthscale from 2.0 against the truth 0.5 (relative)",
          abs(ls - CFG3_LS) / CFG3_LS, CFG3_LS_TOL, err_name="rel_err")
    check("config 3: float64 gradient at the start against a central difference (norm-wise)",
          rel_err(g, fd), FD_REL, err_name="rel_err")
    check("config 3: the card's float64 gradient against the CPU twins' (norm-wise)",
          rel_err(g, g_cpu), CPU_REL, err_name="rel_err")
    check("config 3: the card's float32 gradient against its float64 one (norm-wise)",
          rel_err(g32, g), F32_GRAD_REL, err_name="rel_err")
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
    xp, yp, noisep = gpr.pad_training(ts.x, ts.y, ts.noise, c, cfg.pad_noise)
    theta0 = [np.log(cfg.lengthscale), 0.0]
    g32 = mll_and_grad(torch, xp, yp, noisep, c, theta0)[1]
    g64 = mll_and_grad(torch, xp.double(), yp.double(), noisep.double(), c, theta0,
                       chol_impl=gpr._library_chol)[1]
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


# ---------------------------------------------------------------- phase 12

EXPLORE_ROUNDS = 4  # explore-and-touch rounds through the service
CAP_TARGET_Z = 0.7  # the first path's target: its direction from the centre has z above this
REPLAY_TOL = 1e-6  # the restored session against the uninterrupted one after a replayed batch
PLANNER_M = (1, 32, 256, 2048)  # D at the planner's M: a chart, a disc, is_done, a frontier


class PlannerCounts:
    """While open, counts what the planner does: each candidate-predict
    round, each projection attempt and each one that did not converge (it
    wraps `explore.planner._predict_var` and `explore.atlas
    .project_and_chart`, which only count, and restores them on exit)."""

    def __init__(self):
        self.rounds = self.attempts = self.failed = 0

    def __enter__(self):
        from gpis_tpu_torch.explore import atlas, planner

        self._saved = (planner._predict_var, atlas.project_and_chart)
        predict_var, project_and_chart = self._saved

        def counted_predict(model, points):
            self.rounds += 1
            return predict_var(model, points)

        def counted_project(*args, **kw):
            self.attempts += 1
            chart = project_and_chart(*args, **kw)
            self.failed += chart is None
            return chart

        planner._predict_var = counted_predict
        atlas.project_and_chart = counted_project
        return self

    def __exit__(self, *exc):
        from gpis_tpu_torch.explore import atlas, planner

        planner._predict_var, atlas.project_and_chart = self._saved

    def take(self) -> dict:
        out = {"predicts": self.rounds, "attempts": self.attempts, "failed": self.failed}
        self.rounds = self.attempts = self.failed = 0
        return out


class Client:
    """A urllib client of one service: each call's status is gated (200
    unless `expect` says otherwise) and its seconds are kept by route."""

    def __init__(self, port: int):
        self.base = f"http://127.0.0.1:{port}"
        self.seconds: dict = {}

    def __call__(self, path: str, payload=None, expect: int = 200):
        import urllib.error
        import urllib.request

        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(self.base + path, data,
                                     {"Content-Type": "application/json"})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                code, body = r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            code, body = e.code, json.loads(e.read())
        self.seconds.setdefault(path.split("?")[0], []).append(time.perf_counter() - t0)
        if code != expect:
            fail(f"the service answered {path} with {code}, not {expect}: {str(body)[:300]}")
        return body


def serve_in_thread(session):
    """make_server(session, port=0) on 127.0.0.1, served from a thread;
    returns (server, thread, client)."""
    import threading

    from gpis_tpu_torch.api.service import make_server

    srv = make_server(session, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread, Client(srv.server_address[1])


def stop_server(srv, thread) -> None:
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)
    if thread.is_alive():
        fail("the service thread did not stop")


def path_contacts(path_world, center, radius: float, k: int = TOUCH_BATCH):
    """A finger tracing a path: k contacts evenly spaced along its polyline
    (its one pose, if it has one), moved radially onto the true sphere.
    Returns (contacts (k, 3) float32, their unit directions from the
    centre)."""
    p = np.asarray(path_world, np.float64)
    if len(p) > 1:
        s = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(p, axis=0), axis=1))])
        t = np.linspace(0.0, s[-1], k)
        p = np.stack([np.interp(t, s, p[:, i]) for i in range(3)], axis=1)
    d = p - np.asarray(center, np.float64)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (np.asarray(center) + radius * d).astype(np.float32), d


def direction_z(point, center) -> float:
    d = np.asarray(point, np.float64) - np.asarray(center, np.float64)
    return float(d[2] / np.linalg.norm(d))


def profile_call(torch, fn) -> dict:
    """One call of fn under torch.profiler: its wall seconds there, the card's
    busy time (the kernels' own time) and the number of kernels.  A profiler
    that records no device time reports "not measured"."""
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    except Exception as e:  # noqa: BLE001 -- a measurement, not a gate
        return {"busy_share": "not measured", "error": f"{type(e).__name__}: {e}"}
    if not busy_us:
        return {"busy_share": "not measured", "profiled_wall_s": wall}
    return {"profiled_wall_s": wall, "device_busy_s": busy_us * 1e-6,
            "busy_share": busy_us * 1e-6 / wall, "device_kernels": len(kernels)}


def float64_replay(cfg, pts, rounds, observed):
    """Phase 12's service session in float64 on the CPU, touched with the
    same contacts: at each round's observed contacts (`observed[r]`, a
    mask), the variance before and after the round's update."""
    import dataclasses

    from gpis_tpu_torch import ObjectModelSession

    sess = ObjectModelSession(dataclasses.replace(cfg, dtype="float64"), device="cpu")
    sess.start(pts.astype(np.float64))
    out = []
    for contacts, seen in zip(rounds, observed):
        c64 = contacts.astype(np.float64)
        var0 = sess.query(c64[seen])[1]
        sess.update(c64)
        out.append((var0, sess.query(c64[seen])[1]))
    return out


def service_run(torch, launches, cfg, ecfg, pts, out: dict) -> dict:
    """Phase 12 (a): the value session behind the HTTP service at full width
    (C = 17,408), EXPLORE_ROUNDS explore-and-touch rounds, the closing
    queries, then the crash: /save, the node and its session dropped, a new
    node /load-ing the file, a pending batch replayed there and on an
    uninterrupted copy."""
    import copy
    import gc
    import os
    import tempfile

    from gpis_tpu_torch import ObjectModelSession

    center, radius = np.zeros(3), 1.0
    big = big_query(torch, pts)
    cap_probe = capped_probes()
    sess = ObjectModelSession(cfg, ecfg, device="cuda")
    srv, thread, call = serve_in_thread(sess)
    res: dict = {"card": card_line()}
    if call("/health") != {"ok": True, "fitted": False}:
        fail("/health before /start")
    res["start"] = call("/start", {"points": pts.tolist()})
    res["done_before"] = call("/done")["done"]
    if res["done_before"]:
        fail("/done answered true with the cap unseen")
    cap_var0 = float(sess.query(cap_probe)[1].max())
    rounds, calls, falls, observed = [], [], [], []
    with PlannerCounts() as counts:
        for r in range(EXPLORE_ROUNDS):
            before = dict(launches)
            got = call("/next_best_path")
            n_calls = {k: launches.get(k, 0) - before.get(k, 0) for k in ("cov", "staged_quad",
                                                                          "fused_quad")}
            path = np.asarray(got["path"])
            target_z = direction_z(path[-1], center) if len(path) else float("nan")
            reached = got["target_variance"] >= ecfg.variance_threshold
            calls.append({"s": call.seconds["/next_best_path"][-1], "poses": len(path),
                          "target_variance": got["target_variance"], "target_z": target_z,
                          "reached_threshold": got["reached_threshold"], "launches": n_calls,
                          **counts.take()})
            say(f"  round {r + 1}: next_best_path {calls[-1]} ({res['card']})")
            if not len(path) or not np.isfinite(path).all():
                fail(f"round {r + 1}: the path is empty or not finite")
            if got["reached_threshold"] != reached:
                fail(f"round {r + 1}: reached_threshold {got['reached_threshold']} but the "
                     f"target's variance {got['target_variance']} against the threshold "
                     f"{ecfg.variance_threshold} says {reached}")
            if r == 0 and not target_z > CAP_TARGET_Z:
                fail(f"the first path's target is not in the cap (direction z {target_z})")
            contacts, dirs = path_contacts(path, center, radius)
            in_cap = dirs[:, 2] > CAP_Z
            var0 = sess.query(contacts)[1]
            call("/update", {"points": contacts.tolist()})
            var1 = sess.query(contacts)[1]
            rounds.append(contacts)
            observed.append(~in_cap)
            falls.append((var0[~in_cap], var1[~in_cap]))
            if in_cap.any():
                touched_checks(f"round {r + 1}, {int(in_cap.sum())} contacts in the cap",
                               var0[in_cap], None, var1[in_cap])
        # Where the card's time goes in one call (a direct one: the same
        # planner without the HTTP round trip), and the service's overhead.
        t0 = time.perf_counter()
        direct = sess.next_best_path()
        direct_s = time.perf_counter() - t0
        res["direct_next_best_path"] = {"s": direct_s, **counts.take()}
        res["profile_next_best_path"] = profile_call(torch, sess.next_best_path)
        res["profile_next_best_path"].update(counts.take())
        t0 = time.perf_counter()
        sess.is_done()
        res["direct_is_done_s"] = time.perf_counter() - t0
    call("/next_best_path")
    res["http_next_best_path_s"] = call.seconds["/next_best_path"][-1]
    res["direct_poses"] = len(direct.path)
    cap_var1 = float(sess.query(cap_probe)[1].max())
    res["cap_probe_var_max"] = [cap_var0, cap_var1]
    if not cap_var1 < cap_var0:
        fail(f"the cap's maximum variance did not fall over the rounds ({cap_var0} -> {cap_var1})")
    res["done_after"] = call("/done")["done"]

    # The closing queries: 65,536 points, the stats, a mesh, a malformed body.
    big_list = big.tolist()
    saved = call("/query", {"points": big_list})
    t0 = time.perf_counter()
    direct_q = sess.query(big)
    res["query_65536_s"] = {"http": call.seconds["/query"][-1],
                            "direct": time.perf_counter() - t0}
    if not (np.array_equal(saved["mean"], direct_q[0]) and np.array_equal(saved["var"],
                                                                         direct_q[1])):
        fail("/query and the direct query differ")
    res["stats"] = call("/stats")
    mesh = call("/mesh?resolution=32")
    res["mesh_32"] = {"verts": len(mesh["verts"]), "faces": len(mesh["faces"]),
                      "s": call.seconds["/mesh"][-1]}
    err = call("/query", {"wrong_key": 1}, expect=400)
    if "error" not in err:
        fail("the malformed /query's 400 carries no error")
    verts, _, vvar = sess.extract_surface(64)
    res["surface_rmse_64"] = surface_rmse(verts)
    finite = [np.isfinite(saved["mean"]).all(), np.isfinite(saved["var"]).all(),
              np.isfinite(verts).all(), np.isfinite(vvar).all()]

    # The crash: save, then the node and its session go; an uninterrupted
    # copy stays for the replay.
    ck_dir = tempfile.mkdtemp(prefix="gpis_ckpt_")
    path = os.path.join(ck_dir, "session.npz")
    call("/save", {"path": path})
    res["save_s"] = call.seconds["/save"][-1]
    res["checkpoint_bytes"] = os.path.getsize(path) + os.path.getsize(path + ".frame.npz")
    uninterrupted = copy.deepcopy(sess)
    stop_server(srv, thread)
    del srv, thread, sess
    gc.collect()
    torch.cuda.empty_cache()
    sess2 = ObjectModelSession(cfg, ecfg, device="cuda")
    srv, thread, call2 = serve_in_thread(sess2)
    loaded = call2("/load", {"path": path})
    res["load_s"] = call2.seconds["/load"][-1]
    res["load_answer"] = loaded
    restored = call2("/query", {"points": big_list})
    same = saved["mean"] == restored["mean"] and saved["var"] == restored["var"]
    check("restored session's 65,536-point query against the saved session's (bits differ)",
          float(not same), 0.0, err_name="bits differ")
    pending = touch_batches(np.random.default_rng(13), 1, center, radius)[0]
    call2("/update", {"points": pending.tolist()})
    uninterrupted.update(pending)
    replayed = call2("/query", {"points": big_list})
    want = uninterrupted.query(big)
    gap = max(float(np.abs(np.asarray(replayed["mean"]) - want[0]).max()),
              float(np.abs(np.asarray(replayed["var"]) - want[1]).max()))
    check("after the replayed batch, restored against uninterrupted (mean and var)", gap,
          REPLAY_TOL)
    res["seconds_by_route"] = {k: v for k, v in call.seconds.items()}
    res["seconds_by_route_after_load"] = call2.seconds
    res["next_best_path_calls"] = calls
    stop_server(srv, thread)
    model = sess2.model
    del srv, thread, sess2, uninterrupted
    # The deflate the JAX package's writer would add, timed on every eighth
    # row of W (half of W is its zero upper triangle, as in the file; the
    # port writes uncompressed).
    import io

    part = model.linv[::8].cpu().numpy()
    for name, writer in (("savez", np.savez), ("savez_compressed", np.savez_compressed)):
        buf = io.BytesIO()
        t0 = time.perf_counter()
        writer(buf, w=part)
        res[f"{name}_MB_per_s_on_W_rows"] = part.nbytes / 1e6 / (time.perf_counter() - t0)
        res[f"{name}_bytes_ratio"] = buf.getbuffer().nbytes / part.nbytes
    res["finite"] = bool(all(finite))

    # The float64 replay of the rounds, after the counted run (see phase12).
    out["service"] = res
    out["_float64"] = (rounds, observed, falls)
    out["_model"] = model
    return res


def capped_probes() -> np.ndarray:
    """Probes of the unseen cap, on the true unit sphere (world frame)."""
    from gpis_tpu_torch.data.gpis import fibonacci_sphere

    p = fibonacci_sphere(2048)
    return p[p[:, 2] > CAP_Z].astype(np.float32)


def explore_kind(torch, what, next_best_path, is_done, frame_center) -> dict:
    """One next_best_path and one is_done, timed; gates: the target in the
    cap (its direction from `frame_center`, the sphere's centre in the
    path's frame), the path not empty, no NaN."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = next_best_path()
    nbp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    done = is_done()
    done_s = time.perf_counter() - t0
    path = np.asarray(res.path)
    if not len(path):
        fail(f"{what}: empty path")
    target_z = direction_z(path[-1], frame_center)
    out = {"next_best_path_s": nbp_s, "is_done_s": done_s, "done": done, "charts":
           len(res.charts), "poses": len(path), "target_variance": res.target_variance,
           "target_z": target_z, "reached_threshold": res.reached_threshold}
    say(f"  {what}: {out} ({card_line()})")
    if not (np.isfinite(path).all() and np.isfinite(res.normals).all()
            and np.isfinite(res.target_variance)):
        fail(f"{what}: NaN in the path")
    if not target_z > CAP_TARGET_Z:
        fail(f"{what}: the target is not in the cap (direction z {target_z})")
    return out


def same_bits(torch, what: str, a, b) -> None:
    same = all(torch.equal(x, y) if torch.is_tensor(x) else np.array_equal(x, y)
               for x, y in zip(a, b))
    check(f"{what}: restored query against the saved model's (bits differ)", float(not same),
          0.0, err_name="bits differ")


def other_kinds(torch, cfg, cfg4, ecfg, pts, jpts, normals, out: dict) -> None:
    """Phase 12 (b): the joint, out-of-core and one-rank sharded models on
    phase 10's cap-less clouds: one next_best_path and one is_done each; the
    joint, out-of-core and sharded checkpoints round trip to the bit."""
    import os
    import tempfile

    import torch.distributed as dist

    from gpis_tpu_torch import ObjectModelSession
    from gpis_tpu_torch.data import gpis
    from gpis_tpu_torch.explore import planner
    from gpis_tpu_torch.gp import regression
    from gpis_tpu_torch.gp.sharded_model import fit_sharded
    from gpis_tpu_torch.kernels import functions as kf
    from gpis_tpu_torch.surface import projection
    from gpis_tpu_torch.utils import checkpoint as ckpt

    ck_dir = tempfile.mkdtemp(prefix="gpis_ckpt_")
    _, radius, center = JOINT_SPHERE
    sess = ObjectModelSession(cfg4, ecfg, device="cuda").start(jpts, normals=normals)
    out["joint"] = explore_kind(torch, "joint J=21504", sess.next_best_path, sess.is_done,
                                center)
    out["joint"]["joint_size"] = sess.model.chol.shape[0]
    q = big_query(torch, jpts)[:8192]
    saved = sess.query(q)
    path = os.path.join(ck_dir, "joint.npz")
    t0 = time.perf_counter()
    sess.save(path)
    out["joint"]["save_s"] = time.perf_counter() - t0
    del sess
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    restored = ObjectModelSession.load(path, cfg4, device="cuda")
    out["joint"]["load_s"] = time.perf_counter() - t0
    same_bits(torch, "joint checkpoint", restored.query(q), saved)
    del restored
    torch.cuda.empty_cache()

    sess = ObjectModelSession(cfg, ecfg, device="cuda").start(pts, out_of_core=True)
    out["ooc_value"] = explore_kind(torch, "out-of-core value C=16384", sess.next_best_path,
                                    sess.is_done, np.zeros(3))
    q = big_query(torch, pts)[:8192]
    saved = sess.query(q)
    path = os.path.join(ck_dir, "ooc.npz")
    t0 = time.perf_counter()
    sess.save(path)
    out["ooc_value"]["save_s"] = time.perf_counter() - t0
    del sess
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    restored = ObjectModelSession.load(path, cfg, device="cuda")
    out["ooc_value"]["load_s"] = time.perf_counter() - t0
    same_bits(torch, "out-of-core checkpoint", restored.query(q), saved)
    del restored
    torch.cuda.empty_cache()

    store = tempfile.mkdtemp(prefix="gpis_nccl_")
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(store, 'store')}",
                            rank=0, world_size=1)
    try:
        ts = gpis.build_training_set(pts, cfg, device="cuda")
        params = kf.kernel_params(cfg.lengthscale, cfg.signal_variance)
        model = fit_sharded(cfg.kernel, ts.x, ts.y, ts.noise, params, n_devices=1, block=256,
                            touch_capacity=TOUCH_CAPACITY, pad_noise=cfg.pad_noise)
        probes = torch.as_tensor(gpis.fibonacci_sphere(256, 1.0).astype(np.float32),
                                 device="cuda")
        c_n = ts.frame.to_normalized(torch.zeros(3, device="cuda")).cpu().numpy()
        out["sharded"] = explore_kind(
            torch, "sharded P=1 nccl", lambda: planner.next_best_path(model, ecfg),
            lambda: planner.is_done(model, ecfg, projection.project_points(model, probes)[0]),
            c_n)
        qn = ts.frame.to_normalized(torch.as_tensor(big_query(torch, pts)[:8192], device="cuda"))
        saved = regression.predict(model, qn)
        path = os.path.join(ck_dir, "sharded.npz")
        t0 = time.perf_counter()
        ckpt.save_model(path, model)
        out["sharded"]["save_s"] = time.perf_counter() - t0
        del model
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        loaded = ckpt.load_model(path, device="cuda")
        out["sharded"]["load_s"] = time.perf_counter() - t0
        same_bits(torch, "sharded checkpoint", regression.predict(loaded, qn), saved)
        del loaded
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def random_capped_cloud(n: int, seed: int) -> np.ndarray:
    """n random points of the unit sphere below the cap (no symmetry for an
    argmax to tie on)."""
    d = np.random.default_rng(seed).normal(size=(4 * n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return d[d[:, 2] <= CAP_Z][:n]


def checkpoint_refit() -> None:
    """Phase 12 (c): a value checkpoint (C = 4,096) saved without its
    factor, loaded on the card (Kernels A, B and C refit it), against the
    saved model."""
    import os
    import tempfile

    from gpis_tpu_torch import ModelConfig, ObjectModelSession
    from gpis_tpu_torch.utils import checkpoint as ckpt

    cfg = ModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3, n_external=127,
                      n_internal=1, block=128, touch_capacity=0)
    sess = ObjectModelSession(cfg, device="cuda").start(random_capped_cloud(3968, 15))
    if sess.model.capacity != 4096 or sess.model.linv is not sess.model.chol:
        fail(f"the checkpoint session is not a C=4096 fit_inference model "
             f"(capacity {sess.model.capacity})")
    path = os.path.join(tempfile.mkdtemp(prefix="gpis_ckpt_"), "nofactor.npz")
    ckpt.save_model(path, sess.model, factor=False)
    q = random_capped_cloud(512, 16) * 1.1
    want = sess.query(q)
    sess.model = ckpt.load_model(path, device="cuda")
    got = sess.query(q)
    check("factor=False checkpoint, C=4096, refit on the card, against the saved model "
          "(mean and var)", max(float(np.abs(a - b).max()) for a, b in zip(got, want)), 1e-6)


def planner_quad(torch, model, out: dict) -> None:
    """Phase 12 (d): Kernel D at the planner's query counts on the C = 17,408
    model's training points: held per query to its float64 twin (the gate
    of quad_kernel_checks, on a random lower W), twice bit for bit, and
    timed beside the library's W kq^T and its bound."""
    from gpis_tpu_torch.kernels import cuda_query
    from gpis_tpu_torch.kernels import gram as kg

    gen = torch.Generator(device="cuda").manual_seed(12)
    c = model.capacity
    w = quad_test_w(torch, c, gen)
    alpha = torch.randn((c,), generator=gen, device="cuda")
    rows = {}
    for m in PLANNER_M:
        q = torch.nn.functional.normalize(torch.randn((m, 3), generator=gen, device="cuda"),
                                          dim=1).mul_(1.05)
        kq = kg.cross_cov(model.kernel, q, model.x, model.params)
        (mean, quad), again = cuda_query.staged_quad(kq, w, alpha), \
            cuda_query.staged_quad(kq, w, alpha)
        mean_r, quad_r = cuda_query.staged_quad_reference(kq.double(), w.double(),
                                                          alpha.double())
        check(f"staged_quad M={m} C={c}, per query (planner shape)",
              quad_rel_err(torch, quad, quad_r), QUAD_REL_TOL, err_name="max_rel_err")
        check(f"staged_quad M={m} C={c} mean (tol 1e-4 x sum|kq||alpha|)",
              (mean.double() - mean_r).abs().max().item(),
              1e-4 * (kq.abs() @ alpha.abs()).max().item())
        check(f"staged_quad M={m} C={c} run twice", float(not (
            torch.equal(mean, again[0]) and torch.equal(quad, again[1]))), 0.0,
            err_name="bits differ")
        reps = 20 if m <= 256 else 5
        rows[m] = {"ms": time_ms(torch, lambda: cuda_query.staged_quad(kq, w, alpha), reps),
                   "matmul_ms": time_ms(torch, lambda: torch.matmul(w, kq.T), reps),
                   **bound(m * c * c + 4 * m * c, 4 * (m * c + c * c / 2 + c + 2 * m),
                           SPLIT_TF32_FLOPS)}
        del kq, mean_r, quad_r
    out["staged_quad_at_planner_m"] = {"C": c, **rows}
    say(json.dumps({"staged_quad_at_planner_m": out["staged_quad_at_planner_m"],
                    "card": card_line()}))


def phase12(torch, launches, cfg3, cfg4) -> dict:
    """The exploration loop and its service on the card: (a) the value
    session behind make_server at full width, four explore-and-touch rounds
    and a crash recovery; (b) the joint, out-of-core and sharded models'
    next_best_path and is_done, and their checkpoints; launches counted
    over (a) and (b); then (c) float64 parity with the CPU path and (d)
    Kernel D at the planner's query counts."""
    import dataclasses

    from gpis_tpu_torch.config import ExploreConfig

    t_start = time.perf_counter()
    cfg = dataclasses.replace(cfg3, touch_capacity=TOUCH_CAPACITY)
    ecfg = ExploreConfig()
    pts = capped_sphere(16256)
    n_j, radius, center = JOINT_SPHERE
    jpts = capped_sphere(n_j, radius, center)
    normals = (jpts - np.asarray(center, np.float32)) / radius
    out: dict = {"card": card_line()}
    torch.cuda.synchronize()
    launches.clear()
    service_run(torch, launches, cfg, ecfg, pts, out)
    torch.cuda.empty_cache()
    other_kinds(torch, cfg, cfg4, ecfg, pts, jpts, normals, out)
    torch.cuda.synchronize()
    counts = dict(launches)

    # After the counted run: the observed contacts' float64 fall, and the
    # float32 rise held to the quad's error there.
    rounds, observed, falls = out.pop("_float64")
    replay = float64_replay(cfg, pts, rounds, observed)
    out["observed"] = []
    for r, ((v0, v1), (v0_64, v1_64)) in enumerate(zip(falls, replay)):
        if not len(v0):
            continue
        touched_checks(f"round {r + 1} float64, {len(v0)} observed contacts", v0_64, None, v1_64)
        quad_err = float(np.abs(v0 - v0_64).max())
        rise = float((v1 - v0).max())
        out["observed"].append({"round": r + 1, "n": len(v0), "quad_err_float64": quad_err,
                                "var_max_rise": rise})
        check(f"round {r + 1}, observed contacts: float32 variance rise against the quad's error",
              rise, quad_err, err_name="max_rise")
    checkpoint_refit()
    planner_quad(torch, out.pop("_model"), out)
    out["phase_s"] = time.perf_counter() - t_start
    say(f"  launches in the exploration run: {counts}")
    say(json.dumps({"exploration": out}, default=str))
    service = out["service"]
    if not service["finite"]:
        fail("NaN or inf in the service's answers")
    if not service["surface_rmse_64"] < RMSE_GATE:
        fail(f"surface RMSE after the rounds {service['surface_rmse_64']} >= {RMSE_GATE}")
    require_launches(counts, ("cov", "panel_update", "row_update", "staged_quad", "joint_cov",
                              "fused_quad", "gram_band", "quad_band"), "exploration")
    return counts


# ---------------------------------------------------------------- phase 13

COMMITTEE_N = 100_000  # bench/experts_scale.py's default cloud
COMMITTEE_E, COMMITTEE_GATE = 16, 8  # its E and BENCH_EXPERTS.json's gate: B = 7,168
COMMITTEE_RMSE = 0.01  # bench/experts_scale.py's gate
GATE_GAP = 5e-2  # gated against ungated mean: tests/test_experts.py's bar
JOINT_COMMITTEE_N = 32768  # BENCH_EXPERTS_JOINT.json: E 16, gate 16, C 2,304 (J 10,240)
COMMITTEE_CHUNK = 8192  # a grid chunk: the gated (chunk, expert) pairs' M


def committee_config(**kw):
    """bench/experts_scale.py's configuration: rbf, lengthscale 1.0, surface
    noise 1e-4, 64 touch slots, the 64^3 grid over +-1.5."""
    from gpis_tpu_torch import ModelConfig

    return ModelConfig(**{"kernel": "rbf", "lengthscale": 1.0, "noise_surface": 1e-4,
                          "touch_capacity": 64, "grid_resolution": 64, "grid_extent": 1.5, **kw})


def expert_floor(model) -> float:
    """An expert variance's lower clamp in float32, eps max(16, scale B) k0
    (`experts._beta_weights`): the quad noise the committee tolerates."""
    from gpis_tpu_torch.gp import experts as ex

    k0 = model.params["signal_variance"]
    return k0 * F32_EPS * max(16.0, ex._FLOOR_SCALE * model.capacity)


def committee_w_checks(torch, gen, results: dict) -> None:
    """`expert_split`'s W checks on a two-expert committee of B = 7,168 (a 12,800-point
    sphere at phase 13's configuration), standalone for the mutation
    script."""
    from gpis_tpu_torch.data.gpis import fibonacci_sphere
    from gpis_tpu_torch.data import gpis
    from gpis_tpu_torch.gp import experts as ex

    cfg = committee_config()
    ts = gpis.build_training_set(fibonacci_sphere(12800).astype(np.float32), cfg, device="cuda")
    model = ex.fit_experts(cfg.kernel, ts.x, ts.y, ts.noise,
                           {"lengthscale": cfg.lengthscale,
                            "signal_variance": cfg.signal_variance}, n_experts=2,
                           n_shared_tail=ts.n_internal + ts.n_external,
                           touch_capacity=cfg.touch_capacity)
    results["committee_w"] = expert_split(torch, model, f"two experts B={model.capacity}")


def committee_floor(model, g: int) -> float:
    """The least variance a combine of g experts can give: each expert's
    variance clamped at the quad-noise floor eps max(16, scale B) k0 and
    weighted by rBCM's beta there (the precision sum is largest when every
    gated expert sits at the floor)."""
    import math

    from gpis_tpu_torch.gp import experts as ex

    k0 = model.params["signal_variance"]
    f = expert_floor(model)
    beta = 0.5 * math.log(k0 / f) if model.beta == "rbcm" else 1.0
    return 1.0 / (g * beta / f + (1.0 - g * beta) / k0)


def variance_bounds(what: str, model, g: int, *variances) -> dict:
    """Every committee variance in [committee_floor, k0], finite, with
    float32's rounding of the combine beside each end (64 ulps below the
    floor, where every gated expert sits near the surface; 4 above k0)."""
    k0 = model.params["signal_variance"]
    lo = committee_floor(model, g) * (1.0 - 64 * F32_EPS)
    v = np.concatenate([np.ravel(x) for x in variances])
    out = {"var_min": float(v.min()), "var_max": float(v.max()), "floor": lo, "k0": k0}
    say(f"  {what}: {v.size} variances in [{out['var_min']:.3e}, {out['var_max']:.6e}], "
        f"gate [{lo:.3e}, {k0}]")
    if not (np.isfinite(v).all() and v.min() >= lo and v.max() <= k0 * (1.0 + 4 * F32_EPS)):
        fail(f"{what}: a committee variance outside [{lo:.3e}, {k0}] or not finite")
    return out


def expert_split(torch, model, what: str) -> dict:
    """One expert's fit again, step by step by CUDA events: the Gram
    (Kernel A or E), the factor (Kernel B), the raw W (Kernel C) and the
    Newton step; the refined W against the fit's (the same inputs: 0
    expected, printed).  Then the W checks: the fit's W exactly
    lower-triangular (Kernel D plans the lower triangle only), and the
    refined W within 8 ulps (of max|W|) of the exact inverse of the float32
    factor, formed in float64: the step exists to remove the explicit
    inverse's error, and a step that does not (a float32 or TF32 residual)
    leaves W dozens of ulps off.  Printed beside it: the raw W's error, and
    the variance quad's error at a grid chunk (Kernel A or E, then D)
    against float64 (the Gram factored by the library in float64, on the
    same kq) for the refined and raw W and a float32 triangular solve, with
    the expert floor that clamps the variances."""
    from gpis_tpu_torch.gp import experts as ex
    from gpis_tpu_torch.kernels import cuda_query
    from gpis_tpu_torch.kernels import derivative as kd
    from gpis_tpu_torch.kernels import gram as kg
    from gpis_tpu_torch.linalg import cholesky as lin
    from gpis_tpu_torch.surface import grid as grid_mod

    j = model.linv.shape[-1]

    def gram(dt):
        x, noise = model.x[0].to(dt), model.noise[0].to(dt)
        if model.joint:
            return kd.joint_gram(model.kernel, x, model.params, noise_f=noise,
                                 noise_g=model.noise_g[0].to(dt), touch_x=model.touch_x[0].to(dt),
                                 touch_noise=model.touch_noise[0].to(dt))
        return kg.gram(model.kernel, x, model.params, noise=noise)

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    torch.cuda.synchronize()
    ev[0].record()
    k = gram(torch.float32)
    ev[1].record()
    l = lin.cholesky(k)
    ev[2].record()
    w = lin.blocked_linv(l, 512 if j % 512 == 0 else j)
    ev[3].record()
    refined = torch.empty_like(w)
    ex._newton_w(l, w, refined)
    ev[4].record()
    torch.cuda.synchronize()
    out = {name: ev[i].elapsed_time(ev[i + 1])
           for i, name in enumerate(("gram_ms", "factor_ms", "w_ms", "newton_ms"))}
    out["w_gap_to_fit"] = (refined - model.linv[0]).abs().max().item()
    if not torch.equal(model.linv[0], torch.tril(model.linv[0])):
        fail(f"{what}: expert 0's W has nonzeros above its diagonal")

    q = grid_mod.make_grid(64, 1.5, device="cuda")[0][:COMMITTEE_CHUNK].contiguous()
    kq = ex._expert_cross(model, 0, q)
    alpha = model.alpha[0]
    raw = torch.tril(w)
    quads = {"refined": cuda_query.staged_quad(kq, refined, alpha)[1],
             "raw": cuda_query.staged_quad(kq, raw, alpha)[1],
             "solve": torch.sum(torch.linalg.solve_triangular(l, kq.T, upper=False) ** 2, dim=0)}
    inv64 = torch.linalg.solve_triangular(l.double(), torch.eye(j, dtype=torch.float64,
                                                                device=l.device), upper=False)
    wmax = inv64.abs().max().item()
    for name, mat in (("refined", refined), ("raw", raw)):
        out[f"w_ulps_{name}"] = (mat.double() - inv64).abs().max().item() / (wmax * F32_EPS)
    del k, l, w, raw, refined, inv64
    l64, info = torch.linalg.cholesky_ex(gram(torch.float64))
    quad64 = torch.sum(torch.linalg.solve_triangular(l64, kq.double().T, upper=False) ** 2, dim=0)
    del l64, kq
    for name, quad in quads.items():
        out[f"quad_err_{name}"] = (quad.double() - quad64).abs().max().item()
    out["expert_floor"] = expert_floor(model)
    out["float64_factor_info"] = int(info)
    say(f"  {what}: one expert's fit split, W's error in ulps of max|W| and the quad's "
        f"against float64 at {COMMITTEE_CHUNK} grid points: {out}")
    check(f"{what}: expert 0's refined W against the float32 factor's exact inverse "
          "(ulps of max|W|)", out["w_ulps_refined"], 8.0, err_name="max_ulps")
    return out


def committee_value(torch, cfg, out: dict):
    """(a) The value committee at full width through the session, and (b)
    the same committee ungated at 4,096 surface points."""
    from gpis_tpu_torch import ObjectModelSession
    from gpis_tpu_torch.data.gpis import fibonacci_sphere
    from gpis_tpu_torch.gp import experts as ex

    pts = fibonacci_sphere(COMMITTEE_N).astype(np.float32)
    big = big_query(torch, pts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sess = ObjectModelSession(cfg, device="cuda").start(pts, experts=COMMITTEE_E,
                                                        expert_gate=COMMITTEE_GATE)
    m = sess.model
    mean, var, _ = sess.evaluate_grid()
    verts, faces, vvar = sess.extract_surface()
    big_mean, big_var, big_s = timed_query(torch, sess, big)
    torch.cuda.synchronize()
    res = {"fit_s": sess.stats["fit_s"], "query_s": sess.stats["grid_s"], "big_query_s": big_s,
           "n": COMMITTEE_N, "experts": m.n_experts, "capacity": m.capacity, "n0": m.n0,
           "gate": m.gate, "retained_chol": m.chol is not None,
           "w_stack_bytes": m.linv.numel() * m.linv.element_size(),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "surface_rmse": surface_rmse(verts), "n_verts": len(verts)}
    finite = bool(np.isfinite(mean).all() and np.isfinite(big_mean).all()
                  and np.isfinite(verts).all())
    res.update(variance_bounds("(a) grid, vertices and the big query", m, COMMITTEE_GATE, var,
                               vvar, big_var))
    say(f"  (a) E {m.n_experts} x B {m.capacity} (n0 {m.n0}), W alone: "
        f"{res['w_stack_bytes']} bytes; fit {res['fit_s']:.3f} s, 64^3 grid "
        f"{res['query_s']:.3f} s, {BIG_QUERY} points {big_s:.3f} s, RMSE "
        f"{res['surface_rmse']:.3e}")
    if not finite:
        fail("(a) NaN or inf in the committee's posterior")
    if not res["surface_rmse"] < COMMITTEE_RMSE:
        fail(f"(a) surface RMSE {res['surface_rmse']} >= {COMMITTEE_RMSE}")

    # (b) Ungated (every expert) against gate 8 at 4,096 surface points.
    q = sess.frame.to_normalized(torch.as_tensor(fibonacci_sphere(4096).astype(np.float32),
                                                 device="cuda"))
    times = {}
    for g in (COMMITTEE_GATE, COMMITTEE_E):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        times[g] = ex.predict(m, q, gate=g)
        torch.cuda.synchronize()
        times[g] = (times[g], time.perf_counter() - t0)
    gap = (times[COMMITTEE_GATE][0][0] - times[COMMITTEE_E][0][0]).abs().max().item()
    res["gated_vs_ungated"] = {"mean_gap": gap, "gated_s": times[COMMITTEE_GATE][1],
                               "ungated_s": times[COMMITTEE_E][1]}
    check(f"(b) gate {COMMITTEE_GATE} against ungated mean at 4,096 surface points", gap,
          GATE_GAP)
    out["value"] = res
    return sess


def committee_touches(torch, cfg, out: dict):
    """(c) Four batches of contacts into the unseen cap of a capped 100k
    committee; (d) its PoE hyperopt and the refit replaying them."""
    from gpis_tpu_torch import ObjectModelSession

    pts = capped_sphere(COMMITTEE_N)
    sess = ObjectModelSession(cfg, device="cuda").start(pts, experts=COMMITTEE_E,
                                                        expert_gate=COMMITTEE_GATE)
    res = {"fit_s": sess.stats["fit_s"], "capacity": sess.model.capacity, "batches": []}
    batches = touch_batches(np.random.default_rng(13), 4, (0.0, 0.0, 0.0), 1.0)
    for i, b in enumerate(batches):
        var0 = sess.query(b)[1]
        before = sess.model.n_touch.copy()
        cent = sess.model.centroids.cpu().numpy()
        bn = sess.frame.to_normalized(torch.as_tensor(b, device="cuda")).cpu().numpy()
        route = np.unique(((bn[:, None, :] - cent[None]) ** 2).sum(-1).argmin(1))
        (dt,) = timed_updates(torch, sess.update, [b])
        mean, var = sess.query(b)
        after = sess.model.n_touch
        # A point an earlier batch's contacts already brought to the
        # committee floor (every gated expert clamped) cannot fall further.
        at_floor = var0 <= committee_floor(sess.model, COMMITTEE_GATE) * (1.0 + 64 * F32_EPS)
        entry = {"update_s": dt, "experts": route.tolist(), "at_floor": int(at_floor.sum()),
                 **touched_checks(f"(c) batch {i + 1}, {int((~at_floor).sum())} points above "
                                  "the committee floor", var0[~at_floor], mean[~at_floor],
                                  var[~at_floor])}
        if not (var[at_floor] <= var0[at_floor]).all():
            fail(f"(c) batch {i + 1}: a variance at the committee floor rose")
        if not ((after[route] > before[route]).all()
                and after.sum() == before.sum() + len(b)):
            fail(f"(c) batch {i + 1}: n_touch {before.tolist()} -> {after.tolist()} "
                 f"does not rise at the routed experts {route.tolist()}")
        res["batches"].append(entry)
    res["n_touch"] = sess.model.n_touch.tolist()

    # (d) One objective step alone (every expert's factor and backward),
    # then the session's PoE hyperopt and the refit replaying the batches.
    from gpis_tpu_torch.gp import experts as ex

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex.optimize_experts(sess.model, steps=1)
    torch.cuda.synchronize()
    res["poe_step_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hyp = sess.optimize_hyperparameters(method="poe", steps=3)
    res["optimize_s"] = time.perf_counter() - t0
    verts, _, vvar = sess.extract_surface()
    res.update(poe_history=hyp.history, poe_mll=hyp.mll, poe_params=hyp.params,
               poe_noise_scale=hyp.noise_scale, refit_rmse=surface_rmse(verts),
               refit_n_touch=int(sess.model.n_touch.sum()),
               refit_grid_s=sess.stats["grid_s"])
    say(f"  (d) PoE: one objective step (a factor and a backward of every expert) "
        f"{res['poe_step_s']:.3f} s; optimize_hyperparameters(steps=3) with the refit and "
        f"the replay {res['optimize_s']:.3f} s; MLL {hyp.history[0]:.2f} -> {hyp.mll:.2f}, "
        f"{hyp.params}; refit RMSE {res['refit_rmse']:.3e} with {res['refit_n_touch']} "
        "touches replayed")
    variance_bounds("(d) the refit's vertices", sess.model, COMMITTEE_GATE, vvar)
    if not hyp.mll > hyp.history[0]:
        fail(f"(d) the PoE optimum {hyp.mll} is not above the start's {hyp.history[0]}")
    if res["refit_n_touch"] != 4 * TOUCH_BATCH:
        fail(f"(d) the refit holds {res['refit_n_touch']} touches, not {4 * TOUCH_BATCH}")
    if not res["refit_rmse"] < COMMITTEE_RMSE:
        fail(f"(d) the refit's surface RMSE {res['refit_rmse']} >= {COMMITTEE_RMSE}")
    out["touches"] = res
    return sess, pts


def committee_checkpoint_and_service(torch, cfg, sess, pts, out: dict) -> None:
    """(e) save, load and a 65,536-point query on the restored session, to
    the bit; then /start with experts through make_server."""
    import os
    import shutil
    import tempfile

    from gpis_tpu_torch import ObjectModelSession
    from gpis_tpu_torch.data.gpis import fibonacci_sphere

    big = big_query(torch, pts)
    want = sess.query(big)
    ck_dir = tempfile.mkdtemp(prefix="gpis_committee_")
    try:
        path = os.path.join(ck_dir, "committee.npz")
        t0 = time.perf_counter()
        sess.save(path)
        res = {"save_s": time.perf_counter() - t0,
               "checkpoint_bytes": os.path.getsize(path) + os.path.getsize(path + ".frame.npz")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = ObjectModelSession.load(path, cfg, device="cuda")
        torch.cuda.synchronize()
        res["load_s"] = time.perf_counter() - t0
        got = restored.query(big)
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    same = all(np.array_equal(a, b) for a, b in zip(got, want))
    say(f"  (e) checkpoint {res['checkpoint_bytes']} bytes, save {res['save_s']:.3f} s, load "
        f"{res['load_s']:.3f} s; the restored {BIG_QUERY}-point query equal to the bit: {same}")
    if not same:
        fail("(e) the restored committee does not answer as the saved one")
    del restored

    node = ObjectModelSession(cfg, device="cuda")
    srv, thread, call = serve_in_thread(node)
    try:
        sphere = fibonacci_sphere(16256)
        started = call("/start", {"points": sphere.tolist(), "experts": 4, "expert_gate": 2})
        answer = call("/query", {"points": (sphere[:8] * 1.1).tolist()})
        touched = call("/update", {"points": [[0.0, 0.0, 1.0]]})
    finally:
        stop_server(srv, thread)
    res["service"] = {"start": started, "start_s": call.seconds["/start"][0],
                      "update": touched}
    say(f"  (e) /start with experts: {started} in {res['service']['start_s']:.3f} s; "
        f"/update {touched}")
    if not (np.isfinite(answer["mean"]).all() and np.isfinite(answer["var"]).all()):
        fail("(e) the service's committee answered NaN")
    if touched != {"ok": True, "n_touch": 1}:
        fail(f"(e) /update answered {touched}")
    out["checkpoint"] = res


def committee_joint(torch, cfg, out: dict):
    """(f) The joint committee at BENCH_EXPERTS_JOINT.json's shape."""
    from gpis_tpu_torch import ObjectModelSession
    from gpis_tpu_torch.data.gpis import fibonacci_sphere
    from gpis_tpu_torch.surface import projection

    pts = fibonacci_sphere(JOINT_COMMITTEE_N).astype(np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sess = ObjectModelSession(cfg, device="cuda").start(pts, normals=pts,
                                                        experts=COMMITTEE_E,
                                                        expert_gate=COMMITTEE_E)
    m = sess.model
    mean, var, _ = sess.evaluate_grid()
    verts, _, vvar = sess.extract_surface()
    surf = sess.frame.to_normalized(torch.as_tensor(fibonacci_sphere(256).astype(np.float32),
                                                    device="cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nrm = projection.surface_normals(m, surf)
    torch.cuda.synchronize()
    normals_s = time.perf_counter() - t0
    radial = surf - sess.frame.to_normalized(torch.zeros((1, 3), device="cuda"))
    cos = torch.sum(nrm * radial, dim=1) / torch.linalg.vector_norm(radial, dim=1)
    res = {"fit_s": sess.stats["fit_s"], "query_s": sess.stats["grid_s"], "normals_s": normals_s,
           "n": JOINT_COMMITTEE_N, "experts": m.n_experts, "c": m.n0,
           "j": m.linv.shape[-1], "w_stack_bytes": m.linv.numel() * m.linv.element_size(),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "surface_rmse": surface_rmse(verts), "min_cos": cos.min().item()}
    res.update(variance_bounds("(f) grid and vertices", m, COMMITTEE_E, var, vvar))
    say(f"  (f) joint E {m.n_experts} x J {res['j']} (C {m.n0}): fit {res['fit_s']:.3f} s, "
        f"64^3 grid {res['query_s']:.3f} s, RMSE {res['surface_rmse']:.3e}, normals at 256 "
        f"points {normals_s:.3f} s, min cos {res['min_cos']:.6f}")
    if not (np.isfinite(mean).all() and np.isfinite(verts).all()):
        fail("(f) NaN or inf in the joint committee's posterior")
    if not res["surface_rmse"] < COMMITTEE_RMSE:
        fail(f"(f) surface RMSE {res['surface_rmse']} >= {COMMITTEE_RMSE}")
    if not res["min_cos"] > COS_GATE:
        fail(f"(f) min cos(normal, radial) {res['min_cos']} <= {COS_GATE}")
    out["joint"] = res
    return sess


def committee_pair_kernels(torch, value_model, joint_model, out: dict) -> None:
    """(g) One gated (chunk, expert) pair of (a) and of (f): the cross
    (Kernel A, or E with the joint columns and touch slots) against its
    twin, and Kernel D per query against its float64 twin (1e-4), each
    timed beside its twin and the library's W kq^T."""
    from gpis_tpu_torch.gp import experts as ex
    from gpis_tpu_torch.kernels import cuda_gram, cuda_joint, cuda_query
    from gpis_tpu_torch.surface import grid as grid_mod

    q = grid_mod.make_grid(64, 1.5, device="cuda")[0][:COMMITTEE_CHUNK].contiguous()
    for what, model in (("value", value_model), ("joint", joint_model)):
        w, alpha = model.linv[0], model.alpha[0]
        j = w.shape[0]
        if model.joint:
            cols = cuda_joint.joint_meta(model.x[0], model.touch_x[0])
            qmeta = cuda_joint.value_meta(q)
            cross = lambda: cuda_joint.joint_rows(model.kernel, qmeta, cols,  # noqa: E731
                                                  model.params)
            twin = lambda: cuda_joint.joint_rows_reference(  # noqa: E731
                model.kernel, qmeta, cols, model.params)
            name = "joint_cov"
        else:
            cross = lambda: cuda_gram.cov(model.kernel, q, model.x[0],  # noqa: E731
                                          model.params)
            twin = lambda: cuda_gram.cov_reference(model.kernel, q, model.x[0],  # noqa: E731
                                                   model.params)
            name = "cov"
        kq = cross()
        want = twin()
        err_x = (kq - want).abs().max().item()
        tol_x = 1e-5 * max(1.0, want.abs().max().item())
        del want
        ms_x = time_ms(torch, cross, 5)
        plain_x = time_ms(torch, twin, 1)
        check(f"(g) {what} pair: {name} M={COMMITTEE_CHUNK} x {j}", err_x, tol_x, ms_x, plain_x)
        mean, quad = cuda_query.staged_quad(kq, w, alpha)
        mean_r, quad_r = cuda_query.staged_quad_reference(kq.double(), w.double(),
                                                          alpha.double())
        rel = quad_rel_err(torch, quad, quad_r)
        err_mean = (mean.double() - mean_r).abs().max().item()
        tol_mean = 1e-4 * (kq.abs() @ alpha.abs()).max().item()
        del mean_r, quad_r
        ms = time_ms(torch, lambda: cuda_query.staged_quad(kq, w, alpha), 3)
        plain = time_ms(torch, lambda: cuda_query.staged_quad_reference(kq, w, alpha), 3)
        lib = time_ms(torch, lambda: torch.matmul(w, kq.T), 3)
        check(f"(g) {what} pair: staged_quad mean M={COMMITTEE_CHUNK} C={j}", err_mean, tol_mean)
        check(f"(g) {what} pair: staged_quad quad M={COMMITTEE_CHUNK} C={j}, per query", rel,
              QUAD_REL_TOL, ms, plain, err_name="max_rel_err")
        m = COMMITTEE_CHUNK
        out[f"{what}_pair"] = {
            name: dict(max_abs_err=err_x, ms=ms_x, plain_ms=plain_x, library_ms=None,
                       **(bound(30 * m * j, 4 * (m * j + 7 * j + 7 * m)) if model.joint
                          else bound(10 * m * j, 4 * (m * j + 3 * m + 3 * j)))),
            "staged_quad": dict(max_rel_err=rel, ms=ms, plain_ms=plain, library_ms=lib,
                                **bound(m * j * j + 4 * m * j,
                                        4 * (m * j + j * j / 2 + j + 2 * m),
                                        SPLIT_TF32_FLOPS))}
        say(f"  (g) {what} pair at M {m} x {j}: D {ms:.4f} ms, twin {plain:.4f} ms, "
            f"matmul {lib:.4f} ms, bound {out[f'{what}_pair']['staged_quad']['bound_ms']:.4f} ms")
        del kq


def phase13(torch, launches) -> dict:
    """The local-expert committee at the JAX package's committee scale:
    (a)-(f) counted as the main path; then, outside the count, one expert
    of (a) and of (f) refit step by step with its W checks
    (`expert_split`), and (g)."""
    import gc

    t_start = time.perf_counter()
    cfg = committee_config()
    out: dict = {"card": card_line()}
    torch.cuda.synchronize()
    launches.clear()
    sess = committee_value(torch, cfg, out)
    after_a = dict(launches)
    require_launches(after_a, ("cov", "panel_update", "row_update", "staged_quad"),
                     "committee (a)")
    value_model = sess.model
    del sess
    touched, capped = committee_touches(torch, cfg, out)
    committee_checkpoint_and_service(torch, cfg, touched, capped, out)
    del touched
    gc.collect()
    torch.cuda.empty_cache()
    before_f = dict(launches)
    jsess = committee_joint(torch, cfg, out)
    torch.cuda.synchronize()
    counts = dict(launches)
    joint_counts = {k: v - before_f.get(k, 0) for k, v in counts.items()}
    require_launches(joint_counts, ("joint_cov", "panel_update", "row_update", "staged_quad"),
                     "joint committee (f)")
    out["launches"] = counts

    # The checks after the count: one expert's fit again, step by step,
    # with its W and quad against float64 (a and f), then (g).
    out["value"]["split"] = expert_split(torch, value_model, "(a)")
    out["joint"]["split"] = expert_split(torch, jsess.model, "(f)")
    committee_pair_kernels(torch, value_model, jsess.model, out)
    out["phase_s"] = time.perf_counter() - t_start
    say(f"  launches in the committee run: {counts}")
    say(json.dumps({"committee": out}, default=str))
    return counts


# ------------------------------------------------------------ phase 14

CLI_QUERY_N = 4096  # the query verb's points
CLI_FLAGS = ["--lengthscale", "0.4", "--noise", "1e-3"]  # phases 3-10's rbf


def points_arg(q: np.ndarray) -> str:
    """The query verb's --points, each coordinate as repr: it parses back to
    the same float64, so the verb and the session query the same points."""
    return ";".join(",".join(repr(float(v)) for v in p) for p in q)


def dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


class CliRun:
    """Runs the port's CLI in this process, verb by verb: each call's exit
    code (a SystemExit or an exception fails the phase) and seconds, and the
    launches made inside the calls only.  While it runs, every session the
    CLI saves records its query at that checkpoint's points first (outside
    the count), so the loaded checkpoint can be held to it bit for bit."""

    def __init__(self, torch, launches, workdir: str):
        from gpis_tpu_torch.api.session import ObjectModelSession
        from gpis_tpu_torch.cli.main import main

        self.torch, self.launches, self.workdir, self.main = torch, launches, workdir, main
        self.counts: dict = {}
        self.seconds: dict = {}
        # path -> (query points, the saving session's (mean, var) there, save s)
        self.saved: dict = {}
        self.probes: dict = {}  # path -> query points; and path + " extra" -> more points
        self.extra: dict = {}  # path -> the saving session's (mean, var) at the extra points
        self._cls = ObjectModelSession
        self._save = ObjectModelSession.save
        run = self

        def save(sess, path):
            snap = dict(run.launches)
            q = run.probes.get(path)
            answer = None if q is None else sess.query(q)
            if path + " extra" in run.probes:
                run.extra[path] = sess.query(run.probes[path + " extra"])
            run.launches.clear()
            run.launches.update(snap)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run._save(sess, path)
            run.saved[path] = (q, answer, time.perf_counter() - t0)
            return out

        ObjectModelSession.save = save

    def close(self) -> None:
        self._cls.save = self._save

    def __call__(self, label: str, argv: list) -> str:
        import contextlib
        import io

        snap = dict(self.launches)
        buf = io.StringIO()
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                rc = self.main(argv)
        except SystemExit as e:
            fail(f"CLI {label}: exited with {e.code}")
        self.torch.cuda.synchronize()
        self.seconds[label] = time.perf_counter() - t0
        if rc != 0:
            fail(f"CLI {label}: exit code {rc}")
        for k, v in self.launches.items():
            self.counts[k] = self.counts.get(k, 0) + v - snap.get(k, 0)
        text = buf.getvalue()
        say(f"  gpis-torch {label}: {self.seconds[label]:.3f} s; {text.strip().splitlines()[-1][:160]}"
            if text.strip() else f"  gpis-torch {label}: {self.seconds[label]:.3f} s")
        return text

    def path(self, name: str) -> str:
        import os

        return os.path.join(self.workdir, name)


def restored_bits(torch, run: CliRun, label: str, path: str) -> tuple:
    """Load the checkpoint at `path` into a fresh session (timed) and hold
    its query to the saving session's, to the bit."""
    q, answer, save_s = run.saved[path]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess = run._cls.load(path, device="cuda")
    load_s = time.perf_counter() - t0
    got = sess.query(q)
    same_bits(torch, f"CLI {label} checkpoint", got, answer)
    if not all(np.isfinite(a).all() for a in got):
        fail(f"CLI {label}: NaN in the restored query")
    return sess, got, save_s, load_s


def query_lines(mean, var, q) -> str:
    return "".join(f"{p[0]:+.4f},{p[1]:+.4f},{p[2]:+.4f}  f={m:+.6f}  var={v:.6e}\n"
                   for p, m, v in zip(q, mean, var))


def phase14(torch, launches) -> dict:
    """The command line on the card, through gpis_tpu_torch.cli.main.main
    (and once as `python -m gpis_tpu_torch.cli.main`): phase 10's cap-less
    sphere written as a binary PLY, fit with a --profile trace, mesh with
    its HTML, query, explore --json, update with 64 contacts in the cap,
    hyperopt, explore-viz; phase 4's cloud with --normals; phase 13's
    100,000 points as a committee; phase 7's cloud out of core, then mesh
    and query.  Launches are counted inside the verbs only."""
    import json as _json
    import os
    import shutil
    import tempfile

    from gpis_tpu_torch.data import io as cloud_io
    from gpis_tpu_torch.data.gpis import fibonacci_sphere
    from gpis_tpu_torch.native import bindings

    t_start = time.perf_counter()
    work = tempfile.mkdtemp(prefix="gpis_cli_")
    out: dict = {"card": card_line()}

    # Inputs: binary PLYs (read back through the C++ extractor), configs.
    if not bindings.available():
        fail("the native host library could not be built")
    pts = capped_sphere(16256)
    n_j, radius, center = JOINT_SPHERE
    jpts = (fibonacci_sphere(n_j, radius) + np.asarray(center)).astype(np.float32)
    jnrm = ((jpts - np.asarray(center, np.float32)) / radius).astype(np.float32)
    touches = touch_batches(np.random.default_rng(14), 1, (0.0, 0.0, 0.0), 1.0)[0]
    files = {"cloud.ply": (pts, None), "joint.ply": (jpts, jnrm), "touch.ply": (touches, None),
             "committee.ply": (fibonacci_sphere(COMMITTEE_N).astype(np.float32), None),
             "spill.ply": (fibonacci_sphere(SPILL_N).astype(np.float32), None)}
    for name, (p, n) in files.items():
        cloud_io.save_ply(os.path.join(work, name), p, normals=n, binary=True)
        back, back_n = cloud_io.load_cloud(os.path.join(work, name))
        if not (np.array_equal(back, p.astype(np.float64))
                and (n is None or np.array_equal(back_n, n.astype(np.float64)))):
            fail(f"{name}: the binary PLY did not read back exactly")
    model = {"n_external": 127, "n_internal": 1, "block": 128, "grid_resolution": 64,
             "grid_extent": 1.5}
    configs = {"value.json": {**model, "touch_capacity": TOUCH_CAPACITY},
               "joint.json": {**model, "touch_capacity": 256},
               "spill.json": {**model, "touch_capacity": 0},
               "committee.json": {"touch_capacity": 64, "grid_resolution": 64,
                                  "grid_extent": 1.5}}
    for name, m in configs.items():
        with open(os.path.join(work, name), "w") as f:
            _json.dump({"model": m}, f)

    run = CliRun(torch, launches, work)
    try:
        cli_verbs(torch, run, pts, jpts, files, out)
    finally:
        run.close()
    counts = run.counts
    out["verb_s"] = run.seconds
    out["launches"] = counts
    out["phase_s"] = time.perf_counter() - t_start
    say(f"  launches in the CLI verbs: {counts}")
    say(json.dumps({"cli": out}, default=str))
    require_launches(counts, ("cov", "panel_update", "row_update", "joint_cov",
                              "gemm_nt_masked", "gemm_nn_acc_masked", "stripe_write"), "CLI")
    if not counts.get("staged_quad", 0) + counts.get("fused_quad", 0):
        fail("neither staged_quad nor fused_quad was launched by the CLI run")
    shutil.rmtree(work, ignore_errors=True)
    return counts


def console_entry(torch, run: CliRun, value: str, pts, out: dict) -> None:
    """`python -m gpis_tpu_torch.cli.main query` on the checkpoint at
    `value` as a real process: its lines are the restored session's
    answer, formatted."""
    import os
    import subprocess

    q16 = big_query(torch, pts)[:16].astype(np.float64)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "gpis_tpu_torch.cli.main", "query", value,
                           "--points", points_arg(q16)], capture_output=True, text=True,
                          timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    out["subprocess_query_s"] = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"python -m gpis_tpu_torch.cli.main query exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    sess = run._cls.load(value, device="cuda")
    if proc.stdout != query_lines(*sess.query(q16), q16):
        fail("the console entry's query lines differ from the restored session's")
    say(f"  python -m gpis_tpu_torch.cli.main query (16 points, a new process): "
        f"{out['subprocess_query_s']:.3f} s")


def cli_verbs(torch, run: CliRun, pts, jpts, files, out: dict) -> None:
    import json as _json
    import os

    p = run.path
    value, updated, tuned = p("value.npz"), p("updated.npz"), p("tuned.npz")
    q = big_query(torch, pts)[:CLI_QUERY_N].astype(np.float64)
    # The value family's sessions answer at the query points and the touches
    # (one query each: a query's bits depend on its batch's shape).
    run.probes[value] = run.probes[updated] = run.probes[tuned] = q
    run.probes[value + " extra"] = run.probes[updated + " extra"] = files["touch.ply"][0]

    # fit with a profiler trace, then the saving session held to the bit.
    trace_dir = p("trace")
    run("fit --profile", ["fit", p("cloud.ply"), "-o", value, "--config", p("value.json"),
                          "--profile", trace_dir, *CLI_FLAGS])
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".json")] if os.path.isdir(
        trace_dir) else []
    if not traces or not os.path.getsize(os.path.join(trace_dir, traces[0])):
        fail("fit --profile left no trace file")
    out["trace_bytes"] = os.path.getsize(os.path.join(trace_dir, traces[0]))
    sess, _, save_s, load_s = restored_bits(torch, run, "fit (value)", value)
    del sess
    out["value"] = {"save_s": save_s, "load_s": load_s, "bytes": os.path.getsize(value)}

    # mesh at 64^3 with the HTML viewer; the PLY's surface.
    text = run("mesh --html", ["mesh", value, "-o", p("surface.ply"), "--resolution", "64",
                               "--html", p("surface.html")])
    verts = read_ply_vertices(p("surface.ply"))
    rmse = surface_rmse(verts[:, :3])
    out["mesh"] = {"n_verts": len(verts), "surface_rmse": rmse,
                   "html_bytes": os.path.getsize(p("surface.html"))}
    if not (np.isfinite(verts).all() and len(verts)) or "viewer ->" not in text:
        fail("mesh: NaN in the PLY, no vertex or no viewer")
    if not rmse < RMSE_GATE:
        fail(f"mesh: surface RMSE {rmse} >= {RMSE_GATE}")

    # query: the verb's lines are the saving session's answer, formatted.
    text = run(f"query ({len(q)} points)", ["query", value, "--points", points_arg(q)])
    if text != query_lines(*run.saved[value][1], q):
        fail("query: the verb's lines differ from the saving session's answer")

    text = run("explore --json", ["explore", value, "--json"])
    res = _json.loads(text)
    path = np.asarray(res["path"])
    out["explore"] = {"poses": len(path), "target_variance": res["target_variance"],
                      "target_z": direction_z(path[-1], np.zeros(3)) if len(path) else None}
    if not (len(path) and np.isfinite(path).all() and np.isfinite(res["target_variance"])):
        fail("explore: empty path or NaN")

    run("update (64 contacts)", ["update", value, p("touch.ply"), "-o", updated])
    touched_var0, touched_var = run.extra[value][1], run.extra[updated][1]
    os.remove(updated)
    fell = touched_var < touched_var0
    out["update"] = {"var_before_max": float(touched_var0.max()),
                     "var_after_max": float(touched_var.max()), "fell": int(fell.sum())}
    if not fell.all():
        fail(f"update: the variance did not fall at {int((~fell).sum())} touched points")

    hist = []
    real_opt = run._cls.optimize_hyperparameters

    def recording(sess, **kw):
        res = real_opt(sess, **kw)
        hist.append(res)
        return res

    run._cls.optimize_hyperparameters = recording
    try:
        text = run("hyperopt --steps 5", ["hyperopt", p("cloud.ply"), "-o", tuned, "--config",
                                          p("value.json"), "--steps", "5", *CLI_FLAGS])
    finally:
        run._cls.optimize_hyperparameters = real_opt
    h = np.asarray(hist[0].history)
    out["hyperopt"] = {"history": h.tolist(), "mll": hist[0].mll, "printed": text.strip()}
    if not (np.isfinite(h).all() and hist[0].mll > h[0]):
        fail(f"hyperopt: NaN in the history or the best MLL {hist[0].mll} not above the "
             f"start's {h[0]}")
    os.remove(tuned)

    run("explore-viz", ["explore-viz", value, "-o", p("viewer.html")])
    if "gpis-tpu viewer" not in open(p("viewer.html")).read():
        fail("explore-viz: no viewer")
    os.remove(value)
    torch.cuda.empty_cache()

    # The joint fit (phase 4's cloud), the committee (phase 13's), out of core (phase 7's).
    joint = p("joint.npz")
    run.probes[joint] = big_query(torch, jpts)[:CLI_QUERY_N].astype(np.float64)
    run("fit --normals", ["fit", p("joint.ply"), "-o", joint, "--normals", "--config",
                          p("joint.json"), *CLI_FLAGS])
    _, _, save_s, load_s = restored_bits(torch, run, "fit --normals", joint)
    out["joint"] = {"save_s": save_s, "load_s": load_s, "bytes": os.path.getsize(joint)}
    os.remove(joint)
    torch.cuda.empty_cache()

    committee = p("committee.npz")
    run.probes[committee] = q
    run("fit --experts 16 --expert-gate 8",
        ["fit", p("committee.ply"), "-o", committee, "--experts", str(COMMITTEE_E),
         "--expert-gate", str(COMMITTEE_GATE), "--config", p("committee.json"),
         "--lengthscale", "1.0", "--noise", "1e-4"])
    _, _, save_s, load_s = restored_bits(torch, run, "fit --experts", committee)
    out["committee"] = {"save_s": save_s, "load_s": load_s, "bytes": os.path.getsize(committee)}
    os.remove(committee)
    torch.cuda.empty_cache()

    spill = p("spill.npz")
    run.probes[spill] = q
    run("fit --out-of-core", ["fit", p("spill.ply"), "-o", spill, "--out-of-core", "--config",
                              p("spill.json"), *CLI_FLAGS])
    wdir = spill + ".w"
    _, (mean_s, var_s), save_s, load_s = restored_bits(torch, run, "fit --out-of-core", spill)
    torch.cuda.empty_cache()
    text = run("mesh (out of core)", ["mesh", spill, "-o", p("spill_surface.ply"),
                                      "--resolution", "48"])
    sverts = read_ply_vertices(p("spill_surface.ply"))
    text = run(f"query (out of core, {CLI_QUERY_N} points)", ["query", spill, "--points",
                                                              points_arg(q)])
    if text != query_lines(mean_s, var_s, q):
        fail("query (out of core): the verb's lines differ from the saving session's answer")
    console_entry(torch, run, spill, pts, out)
    out["ooc"] = {"w_dir_bytes": dir_bytes(wdir), "w_panels": len(os.listdir(wdir)) - 1,
                  "npz_bytes": os.path.getsize(spill), "save_s": save_s, "load_s": load_s,
                  "surface_rmse": surface_rmse(sverts[:, :3])}
    say(f"  out-of-core checkpoint: .w/ {out['ooc']['w_dir_bytes']} bytes in "
        f"{out['ooc']['w_panels']} panels, save {save_s:.3f} s, load {load_s:.3f} s "
        f"({card_line()})")
    if not (np.isfinite(sverts).all() and out["ooc"]["surface_rmse"] < RMSE_GATE):
        fail(f"mesh (out of core): NaN or surface RMSE {out['ooc']['surface_rmse']}")
    torch.cuda.empty_cache()


def read_ply_vertices(path: str) -> np.ndarray:
    """The vertex rows of an ASCII PLY written by viz.export (x y z, colors)."""
    with open(path) as f:
        n = 0
        for line in f:
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line.strip() == "end_header":
                break
        return np.loadtxt(f, max_rows=n, ndmin=2)


# ------------------------------------------------------------ phase 15

SHARDED_JOINT_BLOCK = 256  # MeshConfig's default block: J = 4 x 5,120 + 256 touch slots
TOUCH_RADIUS = 1.3  # phase 15's contacts: 1.3 x phase 4's radius, off the cloud


def phase15(torch, launches, incore_joint) -> dict:
    """The sharded joint fit on a one-rank NCCL group: phase 4's cloud and
    configuration (C 5,120, J 20,736 with 256 touch slots), float32, its
    model in a session (a one-rank mesh session keeps the single-card path,
    as phase 11's sharded run does): the 64^3 grid, extract_surface, the
    normals at 256 surface points, one 64-contact update, three
    method="distributed" hyperopt steps with their refit, save and load."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    from gpis_tpu_torch import ObjectModelSession
    from gpis_tpu_torch.api.session import _joint_obs
    from gpis_tpu_torch.data import gpis
    from gpis_tpu_torch.data.gpis import fibonacci_sphere
    from gpis_tpu_torch.gp.sharded_joint import fit_sharded_joint
    from gpis_tpu_torch.kernels import functions as kf
    from gpis_tpu_torch.surface import projection

    cfg, pts, normals, in_mean, in_var = incore_joint
    _, radius, center = JOINT_SPHERE
    center = np.asarray(center, np.float32)
    contacts = (fibonacci_sphere(TOUCH_BATCH, TOUCH_RADIUS * radius) + center).astype(np.float32)
    store = tempfile.mkdtemp(prefix="gpis_nccl_")
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(store, 'store')}",
                            rank=0, world_size=1)
    try:
        t_init = time.perf_counter()
        dist.all_reduce(torch.zeros((1,), device="cuda"))
        torch.cuda.synchronize()
        nccl_init_s = time.perf_counter() - t_init
        sess = ObjectModelSession(cfg, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches.clear()
        t0 = time.perf_counter()
        ts = gpis.build_training_set(pts, cfg, device="cuda")
        nrm_full, noise_g = _joint_obs(ts, normals, pts, cfg)
        sess.training, sess.frame = ts, ts.frame
        sess.model = fit_sharded_joint(cfg.kernel, ts.x, ts.y, nrm_full, ts.noise, noise_g,
                                       kf.kernel_params(cfg.lengthscale, cfg.signal_variance),
                                       n_devices=1, block=SHARDED_JOINT_BLOCK,
                                       pad_noise=cfg.pad_noise,
                                       touch_capacity=cfg.touch_capacity)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        model = sess.model
        mean, var, _ = sess.evaluate_grid()
        grid_s = sess.stats["grid_s"]
        verts, faces, vvar = sess.extract_surface(world_frame=False)
        c_n = sess.frame.to_normalized(torch.as_tensor(center, device="cuda"))
        sel = torch.as_tensor(verts[np.linspace(0, len(verts) - 1, 256).astype(int)],
                              dtype=sess.dtype, device="cuda")
        grad = projection.surface_normals(model, sel)
        mean0, var0 = sess.query(contacts)
        t0 = time.perf_counter()
        sess.update(contacts)
        torch.cuda.synchronize()
        update_s = time.perf_counter() - t0
        t_mean, t_var = sess.query(contacts)
        t0 = time.perf_counter()
        res = sess.optimize_hyperparameters(method="distributed", steps=3)
        torch.cuda.synchronize()
        opt_s = time.perf_counter() - t0
        counts = dict(launches)
        peak = torch.cuda.max_memory_allocated()
        big = big_query(torch, pts)
        want = sess.query(big)
        path = os.path.join(store, "sharded_joint.npz")
        t0 = time.perf_counter()
        sess.save(path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = ObjectModelSession.load(path, cfg, device="cuda")
        load_s = time.perf_counter() - t0
        got = restored.query(big)
        ckpt_bytes = os.path.getsize(path)
        joint_size, touched = model.l.shape[1], restored.model.n_touch
        del sess, restored, model
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    radial = sel - c_n
    min_cos = (torch.sum(grad * radial, dim=1) / radial.norm(dim=1)).min().item()
    rad = np.linalg.norm(verts - c_n.cpu().numpy(), axis=1) - radius / float(ts.frame.scale)
    rmse = float(np.sqrt(np.mean(rad**2))) if len(verts) else float("nan")
    finite = bool(np.isfinite(mean).all() and np.isfinite(var).all() and np.isfinite(vvar).all()
                  and torch.isfinite(grad).all().item() and np.isfinite(t_var).all()
                  and np.isfinite(res.history).all())
    say(f"  sharded joint P=1: J {joint_size} (C {ts.x.shape[0]}), launches {counts}")
    say(json.dumps({
        "sharded_joint": "P=1 nccl", "nccl_init_s": nccl_init_s, "fit_s": fit_s,
        "grid_s": grid_s, "update_s": update_s, "optimize_s": opt_s, "save_s": save_s,
        "load_s": load_s, "checkpoint_bytes": ckpt_bytes, "joint_size": joint_size,
        "contact_var": [float(var0.min()), float(t_var.max())],
        "contact_abs_mean": [float(np.abs(mean0).min()), float(np.abs(t_mean).max())],
        "surface_rmse": rmse, "min_normal_cos": min_cos, "history": res.history,
        "params": res.params, "max_memory_allocated_bytes": peak,
        "touches_after_refit": touched, "launches_E": counts.get("joint_cov", 0),
        "launches_F_band": counts.get("quad_band", 0),
        "launches_L": counts.get("band_trail", 0), "card": card_line(),
    }))
    if not finite:
        fail("NaN or inf in the sharded joint posterior")
    for name, a, b in (("mean", mean, in_mean), ("var", var, in_var)):
        check(f"sharded joint P=1 64^3 grid against phase 4's in-core joint grid: {name}",
              float(np.abs(a - b).max()), SHARDED_JOINT_GRID_GAP)
    if not rmse < RMSE_GATE:
        fail(f"sharded joint surface RMSE {rmse} >= {RMSE_GATE}")
    if not min_cos > COS_GATE:
        fail(f"sharded joint min cos(normal, radial) {min_cos} <= {COS_GATE}")
    # Off the cloud, where the prior field is far from 0 and the touch noise
    # is floored at 4 eps J k(0) ~ 1e-2 in float32: the variance falls and
    # the mean moves toward the contacts' target 0 at every contact.
    if not (np.all(t_var < var0) and np.all(np.abs(t_mean) < np.abs(mean0))):
        fail("sharded joint update: at a contact the variance did not fall or the mean did "
             "not move toward 0")
    if not max(res.history) > res.history[0]:
        fail(f"sharded joint distributed hyperopt: no MLL above the start's {res.history}")
    if touched != TOUCH_BATCH:
        fail(f"the hyperopt refit kept {touched} touches, not {TOUCH_BATCH}")
    same_bits(torch, "sharded joint checkpoint", got, want)
    require_launches(counts, ("joint_cov", "gemm_nt_masked", "band_trail", "quad_band"),
                     "sharded joint P=1")
    return counts


# ------------------------------------------------------------ phase 16

# The TRSM-fused query against the post-hoc one: the same W and the same
# per-tile products, the float32 sums of 256 row tiles' partials grouped
# by sweep instead of by panel (a few ulps of the quad, ~1).
FUSED_GAP = 1e-4
# The three-process fit against phase 7's in-process one: the same kernels
# on the same panels in the same order (read 0.0), so a few float32 ulps.
PHASE_SPLIT_GAP = 1e-5
# A float16 W's variance against the float32 W's on phase 7's problem.  Its
# gap grows with C at phase 7's density, lengthscale and noise; the JAX
# package's own, on the CPU in float32 (`scripts/torch_f16_w_gap.py`, polar
# caps of phase 7's set): rms 0.0235, 0.0481, 0.0635 and 99th percentile
# 0.070, 0.216, 0.281 at C 2,048, 4,096, 8,192, growing ~1.3x a doubling
# at the last, so ~0.11 and ~0.47 at C 32,768.  The gates are ~2x and
# ~1.5x those: a misread narrowed panel drives the clamped variance to its
# bounds over most of the box.
F16_VAR_RMS = 0.2
F16_VAR_P99 = 0.7
SPLIT_MLL_REL = 1e-4  # the split stream step against the one-call one: relative MLL
SPLIT_GRAD_REL = 1e-3  # and each gradient component, relative to itself (read <= 1.2e-5)

# One phase of the two-phase out-of-core fit, in a process of its own:
#   python -c PHASE_WORKER ROOT WHAT SPILL_DIR
# WHAT is "factor" (ooc_factor_phase on SPILL_DIR/problem.npz), "stop"
# (ooc_solve_phase(stop_after=4)) or "resume" (the rest, then the query of
# problem.npz's q into SPILL_DIR/answer.npz).  The last line printed is its
# seconds and the kernels it launched, as JSON.
PHASE_WORKER = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from gpis_tpu_torch import _build
from gpis_tpu_torch.linalg import outofcore as ooc

what, sd = sys.argv[2], sys.argv[3]
d = np.load(sd + "/problem.npz")
budget = int(d["budget"])
seen = {}
trsm = ooc.ooc_trsm


def spying(*a, **kw):
    seen["start_panel"] = kw.get("start_panel", 0)
    return trsm(*a, **kw)


ooc.ooc_trsm = spying
t0 = time.perf_counter()
if what == "factor":
    x, y, noise = (torch.as_tensor(d[k], device="cuda") for k in ("x", "y", "noise"))
    ooc.ooc_factor_phase(str(d["kernel"]), x, y, noise,
                         {"lengthscale": float(d["ls"]), "signal_variance": float(d["sv"])},
                         panel=int(d["panel"]), spill_dir=sd, device_budget=budget,
                         pad_noise=float(d["pad_noise"]))
elif what == "stop":
    if ooc.ooc_solve_phase(sd, stop_after=4, device_budget=budget, trsm_sweep=2) is not None:
        sys.exit("the stopped solve phase returned a model")
else:
    m = ooc.ooc_solve_phase(sd, device_budget=budget, trsm_sweep=2)
    mean, var = ooc.ooc_predict(m, torch.as_tensor(d["q"], device="cuda"))
    np.savez(sd + "/answer.npz", mean=mean.cpu().numpy(), var=var.cpu().numpy())
torch.cuda.synchronize()
print(json.dumps({"what": what, "s": time.perf_counter() - t0, "start_panel": seen.get(
    "start_panel"), "launches": dict(_build.LAUNCHES)}))
"""


def run_phase_worker(what: str, sd: str) -> dict:
    """One PHASE_WORKER process; its JSON line.  A failed process fails the
    run."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", PHASE_WORKER, root, what, sd], cwd=root,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        say(proc.stdout[-3000:])
        say(proc.stderr[-3000:])
        fail(f"the {what} phase's process exited {proc.returncode}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["process_s"] = wall
    return out


def dir_size(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)


def link_store(src_dir: str, dst_dir: str, copy: tuple = ()) -> None:
    """dst_dir/L as hard links to src_dir's L panel files (`copy` names the
    files copied instead), with state.npz copied: a second solve phase on
    the same factor without a second factor phase."""
    import os
    import shutil

    os.makedirs(os.path.join(dst_dir, "L"))
    shutil.copyfile(os.path.join(src_dir, "state.npz"), os.path.join(dst_dir, "state.npz"))
    for f in os.listdir(os.path.join(src_dir, "L")):
        a, b = os.path.join(src_dir, "L", f), os.path.join(dst_dir, "L", f)
        if f == "manifest.json" or f in copy:
            shutil.copyfile(a, b)
        else:
            os.link(a, b)


def phase16(torch, launches, spill, incore_value) -> list:
    """The two-phase out-of-core fit on phase 7's problem (C 32,768, panel
    4,096, a 1 GB device budget: L and W panels 4-7 spill to disk): (a) the
    factor phase, a stopped solve phase and its resume, each in a fresh
    process, the resumed model's 65,536-point query held to phase 7's
    in-process fit; (b) the TRSM-fused query held to (a)'s post-hoc one;
    (c) the int16 L codec passing ooc_residual_check, and failing it with
    one L panel damaged on disk; (d) a float16 W, whose update is refused;
    (e) one split stream-objective step on phase 3's training set held to
    the one-call objective."""
    import os
    import shutil
    import tempfile

    from gpis_tpu_torch.data import gpis
    from gpis_tpu_torch.gp import ooc_hyperopt as oho
    from gpis_tpu_torch.kernels import functions as kf
    from gpis_tpu_torch.linalg import outofcore as ooc

    cfg, params = spill["cfg"], spill["params"]
    root = tempfile.mkdtemp(prefix="gpis_phases_")
    runs, report = [], {"card": card_line()}
    try:
        # (a) three processes.
        sd = os.path.join(root, "a")
        os.makedirs(sd)
        np.savez(os.path.join(sd, "problem.npz"), x=spill["x"], y=spill["y"],
                 noise=spill["noise"], q=spill["q"], kernel=cfg.kernel,
                 ls=params["lengthscale"], sv=params["signal_variance"], panel=SPILL_PANEL,
                 budget=SPILL_BUDGET, pad_noise=cfg.pad_noise)
        procs = [run_phase_worker("factor", sd)]
        report["l_bytes_on_disk"] = dir_size(os.path.join(sd, "L"))
        backup = os.path.join(root, "a_factor")
        link_store(sd, backup)
        procs.append(run_phase_worker("stop", sd))
        w_stop = sorted(f for f in os.listdir(os.path.join(sd, "W")) if f.endswith(".bin"))
        l_left = sorted(f for f in os.listdir(os.path.join(sd, "L")) if f.endswith(".bin"))
        procs.append(run_phase_worker("resume", sd))
        report["w_bytes_on_disk"] = dir_size(os.path.join(sd, "W"))
        report["processes"] = [{k: p[k] for k in ("what", "s", "process_s", "start_panel")}
                               for p in procs]
        runs += [p["launches"] for p in procs]
        with np.load(os.path.join(sd, "answer.npz")) as d:
            a_mean, a_var = d["mean"], d["var"]
        shutil.rmtree(sd)
        if w_stop != [f"panel_{j}.bin" for j in range(4)] or "panel_0.bin" in l_left:
            fail(f"the stopped solve left W {w_stop} and L {l_left}")
        if procs[2]["start_panel"] != 4:
            fail(f"the resumed TRSM started at panel {procs[2]['start_panel']}, not 4")
        gaps = (float(np.abs(a_mean - spill["mean"]).max()),
                float(np.abs(a_var - spill["var"]).max()))
        report["a_gap_to_phase7"] = gaps
        check("two-phase fit (three processes) against phase 7's in-process fit: mean",
              gaps[0], PHASE_SPLIT_GAP)
        check("two-phase fit (three processes) against phase 7's in-process fit: var",
              gaps[1], PHASE_SPLIT_GAP)

        # (b) the TRSM-fused query, in this process, on the same factor.
        sd = os.path.join(root, "b")
        link_store(backup, sd)
        torch.cuda.synchronize()
        launches.clear()
        t0 = time.perf_counter()
        model, pair = ooc.ooc_solve_phase(sd, device_budget=SPILL_BUDGET, trsm_sweep=2,
                                          fused_query=spill["q"], keep_w=False)
        torch.cuda.synchronize()
        report["fused_solve_s"] = time.perf_counter() - t0
        runs.append(dict(launches))
        report["fused_w_panels_kept"] = sorted(j for j in range(8) if j in model.wstore)
        f_mean, f_var = (t.cpu().numpy() for t in pair)
        del model, pair
        shutil.rmtree(sd)
        gaps = float(np.abs(f_mean - a_mean).max()), float(np.abs(f_var - a_var).max())
        report["fused_gap"] = gaps
        check("TRSM-fused query against (a)'s post-hoc query: mean", gaps[0], FUSED_GAP)
        check("TRSM-fused query against (a)'s post-hoc query: var", gaps[1], FUSED_GAP)
        if report["fused_w_panels_kept"] != list(range(6)):
            fail(f"keep_w=False kept W panels {report['fused_w_panels_kept']}")
        require_launches(runs[-1], ("quad_band", "gemm_nn_acc_masked", "stripe_write"),
                         "TRSM-fused solve")

        # (d) a float16 W on the same factor: the update is refused.
        sd = os.path.join(root, "d")
        link_store(backup, sd)
        model = ooc.ooc_solve_phase(sd, device_budget=SPILL_BUDGET, trsm_sweep=2,
                                    w_dtype=torch.float16)
        h_mean, h_var = (t.cpu().numpy() for t in ooc.ooc_predict(
            model, torch.as_tensor(spill["q"], device="cuda")))
        try:
            model.update(torch.zeros((1, 3), device="cuda"), 0.0, 1e-6)
        except ValueError as e:
            report["f16_update_refused"] = str(e)[:60]
        else:
            fail("an update on a float16-spilled W was not refused")
        del model
        shutil.rmtree(sd)
        shutil.rmtree(backup)
        dv = np.abs(h_var.astype(np.float64) - a_var)
        gaps = float(np.abs(h_mean - a_mean).max()), float(dv.max())
        report["f16_w_gap"] = gaps
        report["f16_w_var_gap"] = {"max": gaps[1], "p99": float(np.quantile(dv, 0.99)),
                                   "rms": float(np.sqrt(np.mean(dv**2)))}
        check("float16 W against (a): mean (alpha never reads W)", gaps[0], FUSED_GAP)
        if not np.isfinite(h_var).all():
            fail("NaN or inf in the float16 W's variance")
        check("float16 W against (a): variance, root mean square",
              report["f16_w_var_gap"]["rms"], F16_VAR_RMS)
        check("float16 W against (a): variance, 99th percentile",
              report["f16_w_var_gap"]["p99"], F16_VAR_P99)

        # (c) the int16 L codec and its guard.
        sd = os.path.join(root, "c")
        x, y, noise = (torch.as_tensor(spill[k], device="cuda") for k in ("x", "y", "noise"))
        t0 = time.perf_counter()
        ooc.ooc_factor_phase(cfg.kernel, x, y, noise, params, panel=SPILL_PANEL, spill_dir=sd,
                             device_budget=SPILL_BUDGET, pad_noise=cfg.pad_noise,
                             l_codec="int16", defer_alpha=True)
        report["int16_factor_s"] = time.perf_counter() - t0
        report["int16_l_bytes_on_disk"] = dir_size(os.path.join(sd, "L"))
        pristine = os.path.join(root, "c_factor")
        link_store(sd, pristine)  # the solve phase unlinks L panels as W replaces them
        model = ooc.ooc_solve_phase(sd, device_budget=SPILL_BUDGET, trsm_sweep=2)
        clean = ooc.ooc_residual_check(model)
        del model
        # Three damages, each in its own copy of the coded factor (the damaged
        # panel copied, the rest hard-linked), each solved and checked: the
        # codes halved in (i) the second sampled block's own rows, (ii) a
        # 256-row block in the middle of the L panel farthest from every
        # sampled block, and (iii) the whole of that panel.  The check reads
        # no panel: (ii) and (iii) reach its sampled rows through alpha.
        block, nb = clean["block"], len(spill["x"]) // SPILL_PANEL
        sampled = [(r, r + block) for r in clean["rows"]]
        far = max((j for j in range(nb)
                   if all(b <= j * SPILL_PANEL or a >= (j + 1) * SPILL_PANEL for a, b in sampled)),
                  key=lambda j: min(abs((j + 0.5) * SPILL_PANEL - (a + b) / 2) for a, b in sampled))
        mid = far * SPILL_PANEL + (SPILL_PANEL - block) // 2
        damages = {"sampled_block": (clean["rows"][1], block),
                   "unsampled_block": (mid, block),
                   "unsampled_panel": (far * SPILL_PANEL, SPILL_PANEL)}
        checked = {}
        for what, (r0, n) in damages.items():
            j = r0 // SPILL_PANEL
            bad = os.path.join(root, f"c_{what}")
            link_store(pristine, bad, copy=(f"panel_{j}.bin",))
            with open(os.path.join(bad, "L", "manifest.json")) as f:
                shape = json.load(f)["panels"][str(j)][0]
            codes = np.memmap(os.path.join(bad, "L", f"panel_{j}.bin"), dtype=np.int16,
                              mode="r+", shape=tuple(shape))
            lo = r0 - j * SPILL_PANEL
            codes[lo:lo + n] //= 2
            codes.flush()
            del codes
            model = ooc.ooc_solve_phase(bad, device_budget=SPILL_BUDGET, trsm_sweep=2)
            checked[what] = ooc.ooc_residual_check(model)
            checked[what]["damaged_rows"] = [int(r0), int(r0 + n)]
            del model
            shutil.rmtree(bad)
        shutil.rmtree(sd)
        shutil.rmtree(pristine)
        report["int16_residual_clean"] = clean
        report["int16_residual_damaged"] = checked
        for what, res in checked.items():
            say(f"  int16 L, codes halved in rows {res['damaged_rows']} ({what}): rel_bw "
                f"{res['rel_bw']:.3e}, rel_y {res['rel_y']:.3e}: "
                f"{'passed' if res['ok'] else 'refused'}")
        if not clean["ok"]:
            fail(f"ooc_residual_check refused the clean int16-coded fit: {clean}")
        passed = [what for what, res in checked.items() if res["ok"]]
        if passed:
            fail(f"ooc_residual_check passed a fit with a damaged L panel ({passed}): {checked}")

        # (e) the split stream-objective step on phase 3's training set.
        cfg3, pts3 = incore_value[0], incore_value[1]
        ts = gpis.build_training_set(pts3, cfg3, device="cuda")
        p3 = kf.kernel_params(cfg3.lengthscale, cfg3.signal_variance)
        mll, g = oho.ooc_mll_and_grad(cfg3.kernel, ts.x, ts.y, ts.noise, p3, panel=1024,
                                      pad_noise=cfg3.pad_noise)
        sd = os.path.join(root, "e")
        torch.cuda.synchronize()
        launches.clear()
        t0 = time.perf_counter()
        ooc.ooc_factor_phase(cfg3.kernel, ts.x, ts.y, ts.noise, p3, panel=1024, spill_dir=sd,
                             pad_noise=cfg3.pad_noise, defer_alpha=True)
        mll2, g2 = oho.ooc_mll_and_grad_solve_phase(sd, noise_base=ts.noise)
        torch.cuda.synchronize()
        report["split_step_s"] = time.perf_counter() - t0
        runs.append(dict(launches))
        shutil.rmtree(sd)
        keys = ("log_ls", "log_noise_scale", "log_sv")
        g, g2 = np.array([float(g[k]) for k in keys]), np.array([float(g2[k]) for k in keys])
        report["split_step"] = {"mll": float(mll2), "mll_one_call": float(mll),
                                "grad": g2.tolist(), "grad_one_call": g.tolist()}
        check("split stream step against the one-call objective: MLL (relative)",
              abs(float(mll2) - float(mll)) / abs(float(mll)), SPLIT_MLL_REL, err_name="rel_err")
        for k, a, b in zip(keys, g2, g):
            check(f"split stream step against the one-call objective: d/d{k} (relative)",
                  abs(a - b) / max(abs(b), 1e-30), SPLIT_GRAD_REL, err_name="rel_err")
        require_launches(runs[-1], ("gram_band", "gemm_nt_masked", "gemm_nn_acc_masked",
                                    "stripe_write"), "split stream step")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say(json.dumps({"two_phase_out_of_core": report}))
    total = {}
    for run in runs:
        for k, v in run.items():
            total[k] = total.get(k, 0) + v
    require_launches(total, ("gram_band", "gemm_nt_masked", "gemm_nn_acc_masked",
                             "stripe_write", "quad_band", "panel_update"), "two-phase fit")
    return runs


BENCH_C = 16384  # `gpis-torch bench`'s default: 16,256 + 127 + 1 points
BENCH_CHUNK = 8192
# One C x C float32 matrix (W formed in place over L over the Gram) and one
# chunk's staged kq, plus 0.5 GB: 2.11 GB.
BENCH_PEAK_GB = (BENCH_C**2 * 4 + BENCH_CHUNK * BENCH_C * 4) / 1e9 + 0.5
BENCH_KEYS = {"metric", "hbm_peak_gb", "value", "unit", "vs_baseline", "fit_s", "query_s",
              "surface_rmse", "n_train", "n_query", "ok"}
# Three times the surface RMSE read on the card (4.0e-4); bench.py's own
# `ok` keeps its 0.02.
BENCH_RMSE_GATE = 1.2e-3
# The bench's float32 grid against a float64 plain PyTorch fit of the same
# inputs (library Cholesky and triangular solve on the card), at
# BENCH_REF_POINTS grid points drawn with seed 0: max |mean gap| and max
# |variance gap|, about five times the 2.04e-6 and 2.13e-5 read on an H100.
BENCH_REF_POINTS = 8192
BENCH_MEAN_GAP = 1e-5
BENCH_VAR_GAP = 1e-4


def plain_posterior64(torch, name, x, y, noise, params, q, chunk: int = 8192):
    """A float64 plain PyTorch posterior on x's device: the Gram by the
    covariance's plain twin, `torch.linalg.cholesky_ex`, alpha by
    cho_solve, and at q (`chunk` rows at a time) the mean and the variance
    by a triangular solve.  Returns (mean, var) as NumPy arrays."""
    from gpis_tpu_torch.kernels import functions as kf
    from gpis_tpu_torch.kernels import gram as kg
    from gpis_tpu_torch.kernels.cuda_gram import cov_reference

    x, y, noise, q = (t.double() for t in (x, y, noise, q))
    l, info = torch.linalg.cholesky_ex(kg.gram_reference(name, x, params, noise=noise))
    if int(info):
        fail(f"the float64 plain reference's Gram is not positive definite (info {int(info)})")
    alpha = torch.cholesky_solve(y[:, None], l)[:, 0]
    k0 = kf.k_diag0(name, params)
    mean, var = [], []
    for i in range(0, q.shape[0], chunk):
        kq = cov_reference(name, q[i:i + chunk], x, params)
        v = torch.linalg.solve_triangular(l, kq.T, upper=False)
        mean.append((kq @ alpha).cpu().numpy())
        var.append((k0 - (v * v).sum(0)).cpu().numpy())
        del kq, v
    return np.concatenate(mean), np.concatenate(var)


def bench_reference(torch, grid: dict, steps: int) -> dict:
    """The bench's saved grid (mean, var) against float64 plain PyTorch on
    the same inputs (`plain_posterior64`), the noise below 1 raised by the
    warm-up ladder's `steps`, at BENCH_REF_POINTS grid points.  Returns the
    max absolute gaps."""
    from gpis_tpu_torch.cli import bench
    from gpis_tpu_torch.surface.grid import make_grid

    x, y, noise, params, _ = bench.workload(bench.N_SURFACE, dtype=torch.float64, device="cuda")
    noise = torch.where(noise < 1.0, noise * 10.0**steps, noise)
    coords, _ = make_grid(bench.RES, bench.EXTENT, dtype=torch.float64, device="cuda")
    idx = np.random.default_rng(0).choice(coords.shape[0], BENCH_REF_POINTS, replace=False)
    mean, var = plain_posterior64(torch, bench.CONFIG.kernel, x, y, noise, params,
                                  coords[torch.as_tensor(idx, device="cuda")])
    del x, coords
    torch.cuda.empty_cache()
    return {"mean_gap": float(np.abs(grid["mean"].ravel()[idx] - mean).max()),
            "var_gap": float(np.abs(grid["var"].ravel()[idx] - var).max())}


def phase17(torch) -> dict:
    """`python -m gpis_tpu_torch.cli.main bench` in a fresh process: bench.py's
    headline fit and 64^3 grid through the port's CLI.  Its stdout JSON line
    is printed with the card's line and gated, its saved grid is held to a
    float64 reference (`bench_reference`), and its launches are read from
    the `launches` line of its stderr."""
    import os
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "grid.npz")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "gpis_tpu_torch.cli.main", "bench", "--save-grid", path],
            cwd=root, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        err = proc.stderr.strip().splitlines()
        for line in err[-40:]:
            say(f"  bench: {line}")
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or len(lines) != 1:
            say(proc.stdout[-3000:])
            fail(f"gpis-torch bench exited {proc.returncode} with {len(lines)} stdout lines")
        with np.load(path) as f:
            grid = {k: f[k] for k in ("mean", "var")}
    result = json.loads(lines[0])
    launch_lines = [line for line in err if line.startswith("launches ")]
    if len(launch_lines) != 1:
        fail("gpis-torch bench printed no launches line")
    counts = json.loads(launch_lines[0][len("launches "):])
    steps = sum(line.startswith("NaN factor") for line in err)
    gaps = bench_reference(torch, grid, steps)
    say(json.dumps({"bench": result, "ladder_steps": steps, "float64_gaps": gaps,
                    "card": card_line(), "process_s": wall}))
    if not BENCH_KEYS <= set(result):
        fail(f"bench: keys {sorted(BENCH_KEYS - set(result))} missing")
    recorded = [k for k in result if k.endswith("_recorded") or k.startswith("BENCH")]
    if recorded:
        fail(f"bench: recorded results attached: {recorded}")
    if result["ok"] is not True:
        fail("bench: ok is not true")
    if not result["surface_rmse"] < BENCH_RMSE_GATE:
        fail(f"bench: surface RMSE {result['surface_rmse']} >= {BENCH_RMSE_GATE}")
    if (result["n_train"], result["n_query"]) != (BENCH_C, 64**3):
        fail(f"bench: n_train {result['n_train']}, n_query {result['n_query']}")
    if abs(result["value"] - (result["fit_s"] + result["query_s"])) > 1.5e-3:
        fail("bench: value is not fit_s + query_s")
    if result["hbm_peak_gb"] is None or result["hbm_peak_gb"] > BENCH_PEAK_GB:
        fail(f"bench: peak {result['hbm_peak_gb']} GB above {BENCH_PEAK_GB:.2f}")
    check("bench grid's mean against float64, max |gap|", gaps["mean_gap"], BENCH_MEAN_GAP)
    check("bench grid's variance against float64, max |gap|", gaps["var_gap"], BENCH_VAR_GAP)
    require_launches(counts, ("cov", "panel_update", "row_update", "staged_quad"), "bench")
    return counts


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    try:
        from gpis_tpu_torch import _build
    except ImportError as e:
        fail(f"gpis_tpu_torch is not importable from here ({e})")
    say("phase 0: card")
    card = card_line()
    say(card)

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
    counts, spill = phase7(torch, _build.LAUNCHES)
    runs.append(counts)
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
    torch.cuda.empty_cache()

    say("phase 12: the exploration loop and its service through make_server")
    runs.append(phase12(torch, _build.LAUNCHES, incore_value[0], incore_joint[0]))
    torch.cuda.empty_cache()

    say("phase 13: the local-expert committee through ObjectModelSession")
    runs.append(phase13(torch, _build.LAUNCHES))
    torch.cuda.empty_cache()

    say("phase 14: the command line (gpis_tpu_torch.cli.main)")
    runs.append(phase14(torch, _build.LAUNCHES))
    torch.cuda.empty_cache()

    say("phase 15: the sharded joint fit on a one-rank NCCL group")
    runs.append(phase15(torch, _build.LAUNCHES, incore_joint))
    torch.cuda.empty_cache()

    say("phase 16: the two-phase out-of-core fit, its phases in fresh processes")
    runs += phase16(torch, _build.LAUNCHES, spill, incore_value)
    torch.cuda.empty_cache()

    say("phase 17: the headline bench, `gpis-torch bench`, in a fresh process")
    runs.append(phase17(torch))

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
