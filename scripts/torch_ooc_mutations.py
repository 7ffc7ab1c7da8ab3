#!/usr/bin/env python3
"""Mutation check of chip_smoke.py's kernel checks for the out-of-core, the
tensor-core (NN and NT) and the inv / sharded kernels, on one card.

    python3 scripts/torch_ooc_mutations.py [CHECK ...]

With CHECK names (e.g. joint_kernel_checks) only the mutations that those
checks cover run; `cpu` names the mutations of the tactile-update path,
which the CPU tests catch (they import jax, so they run where the CPU tier
runs, with no card).

For each mutation below it copies the repository to a temporary directory,
breaks one kernel (or its plan) there, and runs the phase-2 check that
covers it against the broken build: `chip_smoke.ooc_kernels` (Kernel I and
the band modes of A and F, at phase 7's shapes), `chip_smoke.quad_kernel_checks`
(D and F's four modes, the tile's NT layout with the QUAD epilogue, F with
a generated B, against float64 twins per query, in the `_QSPLIT` regime and
with the bias gate),
`chip_smoke.tc_fused_quad_bits` (float32 F's bits against the recorded
sha256; F has no bias gate of its own: its float32 generation of kq alone
moves a nonnegative quad's mean ~1.9e-7 from the float64 twin's),
`chip_smoke.nn_kernel_checks` (float32 C and H, the split-TF32 tensor-core
kernel's NN layout, with its bias gate), `chip_smoke.nt_kernel_checks`
(B and G, its NT layout, with the bias gate at a = b),
`chip_smoke.joint_kernel_checks` (Kernel E in
float32 and float64, three covariances, aligned and ragged layouts, value
rows, an off-tile band with noise and general metadata, over NaN-filled
outputs, twice bit for bit) or `chip_smoke.inv_and_trail_kernels` (J and
K, the tile's NT and NN layouts with STORE, with their bias gate, at the
in-core factor's shapes; L, the NN layout with SUB_FROM in place, with its
bias gate and its untouched-region check, at the sharded TRSM's) or
`chip_smoke.cov_kernel_checks` (Kernel A in float32 and
float64, four covariances, cross, Gram and band at ragged shapes, over
NaN-filled outputs, its pinned diagonal bit for bit).
The tactile-update mutations (the noise floor, W's upper block, alpha0,
the out-of-core tail in the mean, a converged seed's steps) and five of the
committee's (`gp/experts.py`: W's tril, the rBCM weight, the floor scale,
the touch route, PoE's real-row mask) run the CPU tests that cover them
instead, `JAX_PLATFORMS=cpu python -m pytest NODE`; the committee's Newton
residual in TF32 runs `chip_smoke.committee_w_checks` (a two-expert
committee at B = 7,168, its refined W against the float32 factor's exact
inverse) on the card.
A mutation is caught when a check fails.  Prints
one line per mutation with the failing check; exits nonzero if any mutation
passed every check.  The repository itself is never modified.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import torch_turns

OOC, NN, NT, INV, QUAD, JOINT, COV = ("ooc_kernels", "nn_kernel_checks", "nt_kernel_checks",
                                      "inv_and_trail_kernels", "quad_kernel_checks",
                                      "joint_kernel_checks", "cov_kernel_checks")
F_BITS = "tc_fused_quad_bits"  # takes torch alone
EXPERTS = "gpis_tpu_torch/gp/experts.py"

# (what, the chip_smoke check that covers it, source file, text, broken text)
MUTATIONS = [
    ("C/H drop the hi*lo cross product", NN, "gpis_tpu_torch/csrc/tc_nn.cuh",
     "wgmma_tf32(step, desc(a_hi + off), desc(b_lo + off), 1);", ""),
    ("C/H as 1xTF32 (lo halves zero)", NN, "gpis_tpu_torch/csrc/tc_nn.cuh",
     "lo = __uint_as_float(rna_tf32(x - hi));", "lo = 0.0f;"),
    ("C/H add each truncated step unrounded", NN, "gpis_tpu_torch/csrc/tc_nn.cuh",
     "acc[i] += round23(step[i]);", "acc[i] += step[i];"),
    ("C's plan ends each split tile's triangle one chunk short", NN,
     "gpis_tpu_torch/linalg/cuda_chol.py",
     "ke = bounds[i + 1] if i + 1 < len(bounds) else hi",
     "ke = bounds[i + 1] if i + 1 < len(bounds) else hi - TC_CHUNK"),
    ("C/H transpose B one k row off", NN, "gpis_tpu_torch/csrc/tc_nn.cuh",
     "const int k = 4 * k4 + i;", "const int k = (4 * k4 + i + 1) % BK;"),
    ("C/H reduce skips a tile's last partial", NN, "gpis_tpu_torch/csrc/tc_nn.cuh",
     "for (int i = 0; i < f.cnt; ++i) {", "for (int i = 0; i < f.cnt - 1; ++i) {"),
    ("B/G split B's operand through the NN transpose", NT, "gpis_tpu_torch/csrc/tc_nn.cuh",
     "split_rows(raw + RAW_A_BYTES,", "split_cols(raw + RAW_A_BYTES,"),
    ("B/G's SUB_FROM epilogue adds the product", NT, "gpis_tpu_torch/csrc/tc_nn.cuh",
     "return old - v;  // SUB_FROM", "return old + v;  // SUB_FROM"),
    ("finish tiles with cnt 0 write zeros instead of S (G at k0 0)", NT,
     "gpis_tpu_torch/csrc/tc_nn.cuh", "const FinishTile f = tiles[blockIdx.x];\n",
     "const FinishTile f = tiles[blockIdx.x];\n"
     "  if (f.cnt == 0) {\n"
     "    const int e0 = blockIdx.y * 8 * BN + threadIdx.x * 4;\n"
     "    for (int j = 0; j < 4; ++j)\n"
     "      epilogue<STORE>(out, ldo, s, lds, m, n, f.m0 + e0 / BN, f.n0 + e0 % BN + j, 0.f);\n"
     "    return;\n"
     "  }\n"),
    ("the NT plan ends each split tile one chunk short", NT,
     "gpis_tpu_torch/linalg/cuda_chol.py",
     "ke = bounds[i + 1] if i + 1 < len(bounds) else hi",
     "ke = bounds[i + 1] if i + 1 < len(bounds) else hi - TC_CHUNK"),
    ("B/G sum all their steps in one running sum (no 2,048-deep segments)", NT,
     "gpis_tpu_torch/csrc/tc_nn.cuh", "constexpr int SEG_CHUNKS = 64;",
     "constexpr int SEG_CHUNKS = 1 << 20;"),
    ("B/G as 1xTF32 (lo halves zero)", NT, "gpis_tpu_torch/csrc/tc_nn.cuh",
     "lo = __uint_as_float(rna_tf32(x - hi));", "lo = 0.0f;"),
    ("I drops the stripe's last row", OOC, "gpis_tpu_torch/csrc/chol.cu",
     "out, ldd, blk, ldb, r, w, head, nvec, vpr_log2);",
     "out, ldd, blk, ldb, r - 1, w, head, nvec, vpr_log2);"),
    ("I's vector path drops a row's last vector", OOC, "gpis_tpu_torch/csrc/chol.cu",
     "if (row < r && vec < nvec) reinterpret_cast<V*>(dst",
     "if (row < r && vec < nvec - 1) reinterpret_cast<V*>(dst"),
    ("I's scalar tail starts one column late", OOC, "gpis_tpu_torch/csrc/chol.cu",
     "const int64_t col = k < head ? k : k + nvec * PER;",
     "const int64_t col = k < head ? k : k + nvec * PER + 1;"),
    ("A band mode puts k(0) + noise at the in-core diagonal", OOC, "gpis_tpu_torch/csrc/cov.cu",
     "row0 + r0 - cb, k0,", "r0 - cb, k0,"),
    ("A's scalar path stops a column short of the right edge", COV, "gpis_tpu_torch/csrc/cov.cu",
     "if (cb + c < n) o[c] = v[c];", "if (cb + c < n - 1) o[c] = v[c];"),
    ("A drops the diagonal in tiles it enters mid-tile", COV, "gpis_tpu_torch/csrc/cov.cu",
     "&& c0 < row0 + r0 + rows) {", "&& c0 <= row0 + r0) {"),
    ("J/K's plan ends each tile's triangle one chunk short of its last column / row", INV,
     "gpis_tpu_torch/linalg/cuda_chol.py", "else m0 + k_offset) + t,",
     "else m0 + k_offset) + t - TC_CHUNK,"),
    ("J adds into its output (ADD in place of STORE)", INV, "gpis_tpu_torch/csrc/chol.cu",
     "gpis::tc::launch<gpis::tc::NT, gpis::tc::STORE>(\n      acc,",
     "gpis::tc::launch<gpis::tc::NT, gpis::tc::ADD>(\n      acc,"),
    ("K adds into its output (ADD in place of STORE)", INV, "gpis_tpu_torch/csrc/chol.cu",
     "gpis::tc::launch<gpis::tc::NN, gpis::tc::STORE>(\n      v,",
     "gpis::tc::launch<gpis::tc::NN, gpis::tc::ADD>(\n      v,"),
    ("J drops V's lo half (acc hi x V lo: V is J's B operand)", INV,
     "gpis_tpu_torch/csrc/tc_nn.cuh", "wgmma_tf32(step, desc(a_hi + off), desc(b_lo + off), 1);",
     ""),
    ("K drops V's lo half (V lo x rhs hi: V is K's A operand)", INV,
     "gpis_tpu_torch/csrc/tc_nn.cuh", "wgmma_tf32(step, desc(a_lo + off), desc(b_hi + off), 1);",
     ""),
    ("J/K add each truncated step unrounded", INV, "gpis_tpu_torch/csrc/tc_nn.cuh",
     "acc[i] += round23(step[i]);", "acc[i] += step[i];"),
    ("L skips its first tile of live rows", INV, "gpis_tpu_torch/linalg/cuda_chol.py",
     "r_b, w = _trail_ranges(r, c, b, int(j0), int(row0))",
     "r_b, w = _trail_ranges(r, c, b, int(j0), int(row0) - TC_TILE)"),
    ("L drops the panel's own B columns", INV, "gpis_tpu_torch/linalg/cuda_chol.py",
     "min(j0 + block, c)", "min(j0, c)"),
    ("L's live rows start one row early (a dead row written)", INV,
     "gpis_tpu_torch/linalg/cuda_chol.py", "max(j0 + block - row0, 0)",
     "max(j0 + block - row0 - 1, 0)"),
    ("L adds the product (ADD in place of SUB_FROM)", INV, "gpis_tpu_torch/csrc/chol.cu",
     "gpis::tc::launch<gpis::tc::NN, gpis::tc::SUB_FROM>(\n      lcol,",
     "gpis::tc::launch<gpis::tc::NN, gpis::tc::ADD>(\n      lcol,"),
    ("L's plan ends one k chunk short", INV, "gpis_tpu_torch/linalg/cuda_chol.py",
     '_tc_launch_args("band_trail", live_l, wj, r - r_b, w, b)',
     '_tc_launch_args("band_trail", live_l, wj, r - r_b, w, b - TC_CHUNK)'),
    ("QUAD drops one warpgroup's rows from the column sum", QUAD,
     "gpis_tpu_torch/csrc/tc_nn.cuh", "for (int w = 1; w < 8; ++w) sum += red[w * BN + t];",
     "for (int w = 1; w < 4; ++w) sum += red[w * BN + t];"),
    ("F's generator stores each k group of four columns one group off", QUAD,
     "gpis_tpu_torch/csrc/tc_nn.cuh", "const uint32_t off = row + ((k4 ^ sw) << 4);",
     "const uint32_t off = row + ((((k4 + 1) & 7) ^ sw) << 4);"),
    ("D's plan ends each tile's triangle one chunk short", QUAD,
     "gpis_tpu_torch/kernels/cuda_query.py",
     '_tc_launch_args("staged_quad", w, kq, c, m, c, upper="rows",',
     '_tc_launch_args("staged_quad", w, kq, c, m, c, upper="rows", k_offset=-cuda_chol.TC_CHUNK,'),
    ("F band's plan without k_offset (the in-core bound)", QUAD,
     "gpis_tpu_torch/kernels/cuda_query.py", "upper=\"rows\", k_offset=int(row0), whole=True)",
     "upper=\"rows\", k_offset=0, whole=True)"),
    ("D adds each truncated step unrounded (the warp-specialised body, B through TMA)", QUAD,
     "gpis_tpu_torch/csrc/tc_nn.cuh", "  for (int i = 0; i < 64; ++i) acc[i] += round23(d[i]);",
     "  for (int i = 0; i < 64; ++i) acc[i] += kTmaB<GEN> ? d[i] : round23(d[i]);"),
    ("F adds each truncated step unrounded (the warp-specialised body, B generated)", F_BITS,
     "gpis_tpu_torch/csrc/tc_nn.cuh", "  for (int i = 0; i < 64; ++i) acc[i] += round23(d[i]);",
     "  for (int i = 0; i < 64; ++i) acc[i] += kTmaB<GEN> ? round23(d[i]) : d[i];"),
    ("the producer stores zero lo tiles of its TMA boxes (1xTF32 W, and D's kq)", QUAD,
     "gpis_tpu_torch/csrc/tc_nn.cuh", "sts128(dst + (2 * box + 1) * SW_TILE_BYTES + off, l);",
     "sts128(dst + (2 * box + 1) * SW_TILE_BYTES + off, make_float4(0.f, 0.f, 0.f, 0.f));"),
    ("F's producer stores zero lo tiles of the generated B (1xTF32 kq)", QUAD,
     "gpis_tpu_torch/csrc/tc_nn.cuh", "sts128(off + SW_TILE_BYTES, l);",
     "sts128(off + SW_TILE_BYTES, make_float4(0.f, 0.f, 0.f, 0.f));"),
    ("the quad's reduce skips the last partial row", QUAD, "gpis_tpu_torch/csrc/quad.cuh",
     "for (int64_t i = 0; i < tiles; ++i) s += partial[i * m + q];",
     "for (int64_t i = 0; i < tiles - 1; ++i) s += partial[i * m + q];"),
    ("E's value rows take the value/value formula (k) at gradient columns", JOINT,
     "gpis_tpu_torch/csrc/joint.cu", "v[m] = cm[m][6] * k - g * vd;", "v[m] = k;"),
    ("E's scalar path stops a column short of the right edge", JOINT,
     "gpis_tpu_torch/csrc/joint.cu", "if (cb + m < s) o[m] = v[m];",
     "if (cb + m < s - 1) o[m] = v[m];"),
    ("E drops the noise in tiles the diagonal enters mid-tile", JOINT,
     "gpis_tpu_torch/csrc/joint.cu", "&& c0 < row0 + r0 + JT_ROWS;", "&& c0 <= row0 + r0;"),
    ("E drops the r2 <= 1e-24 mask from d2k", JOINT, "gpis_tpu_torch/csrc/joint.cu",
     "    h = zero ? T(0) : h;\n", ""),
    ("E's gradient rows take u_c along axis 0 whatever their axis", JOINT,
     "gpis_tpu_torch/csrc/joint.cu", "cm[m][6] * da - cm[m][2 + KIND]", "cm[m][6] * da - cm[m][3]"),
    ("update drops the touch noise floor", "tests/test_torch_update.py::"
     "test_update_noise_floor_matches_jax", "gpis_tpu_torch/gp/regression.py",
     "new_noise = torch.clamp(new_noise, min=floor)", "new_noise = new_noise"),
    ("update leaves W's block [:n0, n0:] as it found it", "tests/test_torch_update.py::"
     "test_update_zeroes_the_upper_block_of_w_as_jax_does", "gpis_tpu_torch/gp/regression.py",
     "    linv[:n, n:] = 0.0\n", ""),
    ("ooc_update borders against alpha in place of the fit's alpha0", "tests/test_torch_ooc.py::"
     "test_ooc_update_matches_jax", "gpis_tpu_torch/linalg/outofcore.py",
     "alpha0 = model.alpha0 if model.alpha0 is not None else model.alpha",
     "alpha0 = model.alpha"),
    ("the out-of-core mean skips the touch tail's term", "tests/test_torch_ooc.py::"
     "test_ooc_update_matches_jax", "gpis_tpu_torch/linalg/outofcore.py",
     "    mean = mean + kq2 @ model.tail_alpha\n", ""),
    ("a converged seed keeps stepping while others are active", "tests/test_torch_projection.py::"
     "test_converged_seeds_do_not_move", "gpis_tpu_torch/surface/projection.py",
     "active = torch.nonzero(f.abs() > tol).flatten()\n        if active.numel() == 0:",
     "active = torch.arange(f.shape[0], device=f.device)\n"
     "        if not bool((f.abs() > tol).any()):"),
    ("the committee's W keeps the Newton step's entries above its diagonal",
     "tests/test_torch_experts.py::test_newton_step_refines_w_and_keeps_it_lower_triangular",
     EXPERTS,
     "        torch.tril(r, out=out)", "        out.copy_(r)"),
    ("the committee's Newton residual in TF32", "committee_w_checks", EXPERTS,
     "                blk = l[r0:r1, c0:r1].to(torch.float64) @ w64[:r1 - c0]",
     "                torch.backends.cuda.matmul.allow_tf32 = True\n"
     "                blk = l[r0:r1, c0:r1] @ w[c0:r1, c0:c1]"),
    ("rBCM weighs every expert 1 (BCM's beta)",
     "tests/test_torch_experts.py::test_committee_tracks_exact_and_jax", EXPERTS,
     "        return 0.5 * (math.log(k0) - torch.log(vc)), vc",
     "        return torch.ones_like(vc), vc"),
    ("the committee floor at scale 4 (the bound before the Newton step)",
     "tests/test_torch_experts.py::test_combine_weights_and_floor_match_jax_in_float32", EXPERTS,
     '"GPIS_EXPERT_FLOOR_SCALE", "0.5"', '"GPIS_EXPERT_FLOOR_SCALE", "4.0"'),
    ("touches routed to the farthest expert",
     "tests/test_torch_experts.py::test_touch_update_routes_and_matches_jax", EXPERTS,
     "route = ((new_x[:, None, :] - cent[None, :, :]) ** 2).sum(-1).argmin(1)",
     "route = ((new_x[:, None, :] - cent[None, :, :]) ** 2).sum(-1).argmax(1)"),
    ("PoE scales the noise of every row (no real-row mask)",
     "tests/test_torch_experts.py::test_poe_improves_and_matches_jax", EXPERTS,
     "            noise = torch.where(real[e], ns[e] * scale, ns[e])",
     "            noise = ns[e] * scale"),
]

RUN = ("import torch, chip_smoke as cs; "
       "cs.{}(torch, torch.Generator(device='cuda').manual_seed(0), {{}})")
RUN_BITS = "import torch, chip_smoke as cs; cs.{}(torch)"


def _command(check: str, copy: str) -> tuple[list[str], dict]:
    """The command that runs `check` against the broken copy: a chip_smoke
    check on the card, or CPU tests (a pytest node id)."""
    env = dict(os.environ, PYTHONPATH=copy)
    if check.startswith("tests/"):
        env["JAX_PLATFORMS"] = "cpu"
        return [sys.executable, "-m", "pytest", check, "-q", "-x", "-p", "no:cacheprovider"], env
    return [sys.executable, "-c", (RUN_BITS if check == F_BITS else RUN).format(check)], env


def main() -> int:
    missed = 0
    only = set(sys.argv[1:])
    for what, check, rel, text, broken in MUTATIONS:
        kind = "cpu" if check.startswith("tests/") else check
        if only and kind not in only:
            continue
        with tempfile.TemporaryDirectory() as tmp:
            copy = torch_turns.copy_tree(os.path.join(tmp, "repo"))
            path = os.path.join(copy, rel)
            with open(path) as f:
                src = f.read()
            if src.count(text) != 1:
                print(f"FAIL: mutation '{what}' does not apply to {rel}", flush=True)
                return 1
            with open(path, "w") as f:
                f.write(src.replace(text, broken))
            cmd, env = _command(check, copy)
            proc = subprocess.run(cmd, cwd=copy, env=env, capture_output=True, text=True,
                                  timeout=900)
        failed = [ln.strip() for ln in proc.stdout.splitlines() if "FAILED" in ln]
        caught = proc.returncode != 0 and bool(failed)
        missed += not caught
        detail = failed[0] if failed else (proc.stdout + proc.stderr).strip()[-300:]
        print(f"{'caught' if caught else 'MISSED'}: {what}: {detail}", flush=True)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
