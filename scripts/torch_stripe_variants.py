#!/usr/bin/env python3
"""Kernel I (the out-of-core stripe write, gpis_tpu_torch/csrc/chol.cu) at
several depths of loads in flight, on one card.

    python3 scripts/torch_stripe_variants.py

Each thread of I loads STRIPE_UNROLL 16-byte vectors before it stores them,
and the grid holds STRIPE_CTAS_PER_SM CTAs of 256 threads a multiprocessor.
For each variant below the script copies the repository to a temporary
directory, sets the two there (the repository itself is never modified),
builds all the copies at once, and then, in turns (first to last, last to
first), times I and `copy_` at phase 7's k-step (an 8,192 x 4,096 stripe
into an 8,192 x 32,768 band at column 16,384) and at phase 5's (1,024 x
1,024 into 1,024 x 16,384) with `chip_smoke.device_ms` (the card's own
time), after checking I bit for bit.  Prints one JSON line a run and the
card.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = "gpis_tpu_torch/csrc/chol.cu"
# name: (loads a thread, log2 of the vectors a work item, CTAs a multiprocessor)
VARIANTS = {"u4_c4": (4, 10, 4), "u4_c8": (4, 10, 8), "u8_c4": (8, 11, 4), "u4_c2": (4, 10, 2)}
LINES = ("constexpr int STRIPE_UNROLL = ", "constexpr int STRIPE_ITEM_LOG2 = ",
         "constexpr int STRIPE_CTAS_PER_SM = ")

RUN = r'''
import json, sys, torch
import chip_smoke as cs
from gpis_tpu_torch.linalg import cuda_chol

dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
out = {"variant": sys.argv[1]}
for r, w, c in ((8192, 4096, 32768), (1024, 1024, 16384)):
    dst = torch.zeros((r, c), device=dev)
    blk = torch.randn((r, w), generator=gen, device=dev)
    c0 = c // 2
    got = cuda_chol.stripe_write(dst.clone(), blk, c0)
    if not torch.equal(got, cuda_chol.stripe_write_reference(dst.clone(), blk, c0)):
        sys.exit(f"stripe_write is not exact at {r} x {w}")
    del got
    out[f"I_{r}x{w}_ms"] = cs.device_ms(torch, lambda: cuda_chol.stripe_write(dst, blk, c0), 20)
    out[f"copy_{r}x{w}_ms"] = cs.device_ms(torch, lambda: dst[:, c0:c0 + w].copy_(blk), 20)
    out[f"bound_{r}x{w}_ms"] = cs.bound(0, 4 * 2 * r * w)["bound_ms"]
    del dst, blk
out["card"] = cs.card_line()
print(json.dumps(out), flush=True)
'''


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp:
        copies = {}
        for name, values in VARIANTS.items():
            copy = os.path.join(tmp, name)
            shutil.copytree(REPO, copy, ignore=shutil.ignore_patterns(
                "_build", ".git", "__pycache__"))
            path = os.path.join(copy, SOURCE)
            with open(path) as f:
                lines = f.read().splitlines(keepends=True)
            for prefix, value in zip(LINES, values):
                hits = [i for i, ln in enumerate(lines) if ln.startswith(prefix)]
                if len(hits) != 1:
                    print(f"FAIL: no single '{prefix}' line in {SOURCE}", flush=True)
                    return 1
                comment = lines[hits[0]].partition("//")[2]
                lines[hits[0]] = f"{prefix}{value};" + (f"  //{comment}" if comment else "\n")
            with open(path, "w") as f:
                f.writelines(lines)
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
