#!/usr/bin/env python3
"""Float32 Kernels B and G (the NT layout of the split-TF32 tile,
gpis_tpu_torch/csrc/tc_nn.cuh) at several k-segment depths, on one card.

    python3 scripts/torch_nt_segments.py

NT sums its rounded steps in registers over each segment of SEG_CHUNKS k
chunks of 32 and flushes the segment into its output.  For each depth below
the script copies the repository to a temporary directory, sets
SEG_CHUNKS there (the repository itself is never modified), builds all the
copies at once, and then, in turns (first to last, last to first), times B
at C = 16,384, j0 8,192 and G at phase 7's k-step (R 8,192, P 4,096, k0
4,096 and 28,672) and diagonal block (a = b, k0 24,576) with CUDA events,
and measures the diagonal block's worst error against the float64 twin
over chip_smoke's tolerance (2e-6 x sum|a||b| + 4 ulp max|S|): the
accuracy the segments buy.  Prints one JSON line a run and the card.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = "gpis_tpu_torch/csrc/tc_nn.cuh"
LINE = "constexpr int SEG_CHUNKS = {};"
DEPTHS = {"512": 16, "2048": 64, "none": 1 << 20}  # k depth: SEG_CHUNKS

RUN = r'''
import json, sys, torch
import chip_smoke as cs
from gpis_tpu_torch.linalg import cuda_chol

name = sys.argv[1]
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
out = {"segment_k": name}
m = torch.randn((16384, 16384), generator=gen, device=dev) / 8192**0.5
out["B_j0_8192_ms"] = cs.time_ms(torch, lambda: cuda_chol.panel_update(m, 8192, 256), 10)
del m
r, p, wide = 8192, 4096, 32768
cur = torch.randn((r, wide), generator=gen, device=dev) / (wide - p) ** 0.5
lk = torch.randn((p, wide), generator=gen, device=dev) / (wide - p) ** 0.5
for k0 in (4096, 28672):
    s = cur[:, k0:k0 + p]
    out[f"G_k0_{k0}_ms"] = cs.time_ms(torch, lambda: cuda_chol.gemm_nt_masked(cur, lk, s, k0), 3)
j0 = wide - r
s = cur[:, j0:]
out["G_diag_ms"] = cs.time_ms(torch, lambda: cuda_chol.gemm_nt_masked(cur, cur, s, j0), 3)
got = cuda_chol.gemm_nt_masked(cur, cur, s, j0)
want = s.double() - cur[:, :j0].double() @ cur[:, :j0].double().T
err, tol = cs.tc_err(got, want, cur[:, :j0], cur[:, :j0].T)
out["G_diag_err_over_tol"] = err / (tol + 4 * cs.F32_EPS * s.abs().max().item())
out["card"] = cs.card_line()
print(json.dumps(out), flush=True)
'''


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp:
        copies = {}
        for name, chunks in DEPTHS.items():
            copy = os.path.join(tmp, name)
            shutil.copytree(REPO, copy, ignore=shutil.ignore_patterns(
                "_build", ".git", "__pycache__"))
            path = os.path.join(copy, HEADER)
            with open(path) as f:
                src = f.read()
            current = [ln for ln in src.splitlines() if ln.startswith(LINE.format("")[:-1])]
            if len(current) != 1:
                print(f"FAIL: no single SEG_CHUNKS line in {HEADER}", flush=True)
                return 1
            with open(path, "w") as f:
                f.write(src.replace(current[0].split("//")[0].rstrip(), LINE.format(chunks)))
            copies[name] = copy
        builds = [subprocess.Popen([sys.executable, "-c",
                                    "from gpis_tpu_torch import _build; _build.build()"],
                                   cwd=c, env=dict(os.environ, PYTHONPATH=c))
                  for c in copies.values()]
        if any(b.wait() for b in builds):
            print("FAIL: a build failed", flush=True)
            return 1
        order = list(copies) + list(copies)[::-1]
        for name in order:
            proc = subprocess.run([sys.executable, "-c", RUN, name], cwd=copies[name],
                                  env=dict(os.environ, PYTHONPATH=copies[name]),
                                  capture_output=True, text=True, timeout=600)
            if proc.returncode:
                print(f"FAIL: {name}: {proc.stderr.strip()[-500:]}", flush=True)
                return 1
            print(proc.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
