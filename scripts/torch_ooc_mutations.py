#!/usr/bin/env python3
"""Mutation check of chip_smoke.py's kernel checks for the out-of-core and
the inv / sharded kernels, on one card.

    python3 scripts/torch_ooc_mutations.py

For each mutation below it copies the repository to a temporary directory,
breaks one kernel there, and runs the phase-2 check that covers it against
the broken build: `chip_smoke.ooc_kernels` (Kernels G, H, I and the band
modes of A and F, at phase 7's shapes) or `chip_smoke.inv_and_trail_kernels`
(Kernels J, K and L at the in-core factor's and the sharded TRSM's shapes).
A mutation is caught when a check fails.  Prints
one line per mutation with the failing check; exits nonzero if any mutation
passed every check.  The repository itself is never modified.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OOC, INV = "ooc_kernels", "inv_and_trail_kernels"

# (what, the chip_smoke check that covers it, source file, text, broken text)
MUTATIONS = [
    ("F band mode with the in-core live-column bound (i+1)*64", OOC,
     "gpis_tpu_torch/csrc/fused_query.cu",
     "const int64_t k_end = min64(row_base + row0 + rows, c);",
     "const int64_t k_end = min64(row0 + rows, c);"),
    ("G skips its last k slice", OOC, "gpis_tpu_torch/csrc/chol.cu",
     "ldb, cols, 0, k0);", "ldb, cols, 0, k0 - BK);"),
    ("H skips its last k slice", OOC, "gpis_tpu_torch/csrc/chol.cu",
     "for (int64_t k0 = 0; k0 < kd; k0 += BK) {", "for (int64_t k0 = 0; k0 < kd - BK; k0 += BK) {"),
    ("I drops the stripe's last row", OOC, "gpis_tpu_torch/csrc/chol.cu",
     "for (int64_t i = blockIdx.y; i < r; i += gridDim.y)",
     "for (int64_t i = blockIdx.y; i < r - 1; i += gridDim.y)"),
    ("A band mode puts k(0) + noise at the in-core diagonal", OOC, "gpis_tpu_torch/csrc/cov.cu",
     "if (sym && row0 + i == j)", "if (sym && i == j)"),
    ("J stops its k loop one slice short of the tile's last column", INV,
     "gpis_tpu_torch/csrc/chol.cu", "ldv, cols, 0,\n             col0 + cols);",
     "ldv, cols, 0,\n             col0 + cols - BK);"),
    ("K stops its k loop one slice short of the tile's last row", INV,
     "gpis_tpu_torch/csrc/chol.cu", "const int64_t k_end = row0 + rows;",
     "const int64_t k_end = row0 + rows - BK;"),
    ("L skips its first tile of live rows", INV, "gpis_tpu_torch/csrc/chol.cu",
     "? 0 : j0 + bw - row0;", "? 0 : j0 + bw - row0 + TILE;"),
    ("L drops the panel's own B columns", INV, "gpis_tpu_torch/csrc/chol.cu",
     "const int64_t w = j0 + bw < c ? j0 + bw : c;", "const int64_t w = j0 < c ? j0 : c;"),
]

RUN = ("import torch, chip_smoke as cs; "
       "cs.{}(torch, torch.Generator(device='cuda').manual_seed(0), {{}})")


def main() -> int:
    missed = 0
    for what, check, rel, text, broken in MUTATIONS:
        with tempfile.TemporaryDirectory() as tmp:
            copy = os.path.join(tmp, "repo")
            shutil.copytree(REPO, copy, ignore=shutil.ignore_patterns(
                "_build", ".git", "__pycache__"))
            path = os.path.join(copy, rel)
            with open(path) as f:
                src = f.read()
            if src.count(text) != 1:
                print(f"FAIL: mutation '{what}' does not apply to {rel}", flush=True)
                return 1
            with open(path, "w") as f:
                f.write(src.replace(text, broken))
            env = dict(os.environ, PYTHONPATH=copy)
            proc = subprocess.run([sys.executable, "-c", RUN.format(check)], cwd=copy, env=env,
                                  capture_output=True, text=True, timeout=900)
        failed = [ln.strip() for ln in proc.stdout.splitlines() if "FAILED" in ln]
        caught = proc.returncode != 0 and bool(failed)
        missed += not caught
        detail = failed[0] if failed else (proc.stdout + proc.stderr).strip()[-300:]
        print(f"{'caught' if caught else 'MISSED'}: {what}: {detail}", flush=True)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
