#!/usr/bin/env python3
"""Kernel E (the joint covariance tile, gpis_tpu_torch/csrc/joint.cu) of
several source trees, timed in turns on one card, with its SASS counts.

    python3 scripts/torch_joint_turns.py [OTHER_TREE ...] [--variants] [--reps N]

Each OTHER_TREE is another checkout of this repository (an older commit, or
a variant of this one).  With --variants the script also copies this tree
to a temporary directory once for each entry of VARIANTS below, sets the
kernel's tuning constants there (the repository itself is never modified)
and adds the copies as other trees.  The trees run in turns
(`torch_turns.main`), each in a process of its own that imports that tree's
`gpis_tpu_torch` (building its kernels there), and each times E in float32
on the same inputs made from one seed, at chip_smoke.py's shapes: the joint
Gram at J = 21,504 (C = 5,120 sphere points and 1,024 touch slots at the
origin, noise 1e-3), the cross of 8,192 value queries against those J
columns, and phase 6's band of 1,024 rows at row0 19,456 with noise.  Each
time is the mean of N calls by CUDA events after a warm-up, queued behind a
~3 ms spin kernel so that the card's time and not the host's enqueue is
read (as chip_smoke.device_ms); the cross and the band are also held to
the plain twin (max error over max|K|).  One JSON line a run, then for
each other tree the per-shape ratio of its two runs' mean to this tree's
(OTHER / this), the card's name and power limit, each shape's byte bound,
and each tree's SASS counts: for every
function of joint.cu (nvcc -cubin for sm_90a, cuobjdump -sass), its
instructions, MUFU.EX2 and other MUFU operations, and those of its longest
loop (the largest backward branch), beside ptxas's registers and spills.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch_turns

SOURCE = "gpis_tpu_torch/csrc/joint.cu"
HBM_BYTES = 3.35e12  # the H100's memory rate
# name: {constant line prefix in SOURCE: value}.  JOINT_ROWS: rows (16-byte
# vectors) a thread; JOINT_MIN_CTAS: __launch_bounds__' minimum CTAs a
# multiprocessor in float32 (a cap on registers).
_ROWS, _MIN = "constexpr int JOINT_ROWS = ", "constexpr int JOINT_MIN_CTAS = "
VARIANTS: dict[str, dict[str, str]] = {
    "rows16": {_ROWS: "16"}, "rows64": {_ROWS: "64"}, "min3": {_MIN: "3"},
    "rows16_min1": {_ROWS: "16", _MIN: "1"},
}


def shapes():
    """(name, rows, row0, with noise) of the three timed calls; J = 21,504."""
    return (("gram_J21504", 21504, 0, True), ("cross_M8192_J21504", 8192, None, False),
            ("band_R1024_row0_19456_J21504", 1024, 19456, True))


def worker(tree: str, reps: int) -> dict:
    torch_turns.import_tree(tree)
    import torch

    from gpis_tpu_torch.data.gpis import fibonacci_sphere
    from gpis_tpu_torch.kernels import cuda_joint

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = {"lengthscale": 0.4, "signal_variance": 1.0}
    x = torch.as_tensor(fibonacci_sphere(5120), dtype=torch.float32, device=dev)
    cols = cuda_joint.joint_meta(x, torch.zeros((1024, 3), device=dev))
    j = cols[0].shape[0]
    noise = torch.full((j,), 1e-3, device=dev)
    q = (torch.rand((8192, 3), generator=gen, device=dev) * 3.0 - 1.5).contiguous()

    out = {}
    for name, r, row0, with_noise in shapes():
        rows = cols if r == j else (cuda_joint.value_meta(q) if row0 is None else
                                    tuple(t[row0:row0 + r] for t in cols))
        nz = noise if with_noise else None
        call = (lambda rows=rows, nz=nz, row0=row0:  # noqa: E731
                cuda_joint.joint_rows("rbf", rows, cols, p, noise_col=nz, row0=row0 or 0))
        if r < j:
            want = cuda_joint.joint_rows_reference("rbf", rows, cols, p, noise_col=nz,
                                                   row0=row0 or 0)
            err = (call() - want).abs().max().item() / want.abs().max().item()
            out[f"{name}_rel_err"] = err
            del want
        out[f"{name}_ms"] = torch_turns.device_ms(call, reps, spin=True)
    return out


def bounds_ms() -> dict:
    """Each shape's byte bound: the output written once, the 7-float
    metadata of rows and columns and the noise read once (float32)."""
    j = 21504
    return {name: 4 * (r * j + 7 * (r + j) + (j if nz else 0)) / HBM_BYTES * 1e3
            for name, r, _, nz in shapes()}


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)


def sass_counts(tree: str) -> dict:
    """Per function of the tree's joint.cu: SASS instructions, MUFU.EX2 and
    other MUFU operations, the same within its longest loop, and ptxas's
    registers and spill bytes."""
    src = os.path.join(tree, SOURCE)
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "joint.cubin")
        proc = subprocess.run([_tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
                               "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v", src, "-o", cubin],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode:
            return {"error": proc.stderr[-2000:]}
        ptxas, fn = {}, None
        for line in proc.stderr.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                ptxas.setdefault(fn, {})["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and fn:
                ptxas.setdefault(fn, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        sass = subprocess.run([_tool("cuobjdump"), "-sass", cubin], capture_output=True,
                              text=True, timeout=300).stdout
    out, fn, body = {}, None, []

    def opcode(ins: str) -> str:
        words = ins.split()
        return words[1] if words[0].startswith("@") and len(words) > 1 else words[0]

    def count(ins_list):
        ops = [opcode(i) for i in ins_list]
        return {"instructions": len(ops),
                "mufu_ex2": sum(o == "MUFU.EX2" for o in ops),
                "mufu_other": sum(o.startswith("MUFU") and o != "MUFU.EX2" for o in ops)}

    def close():
        if fn is None:
            return
        addr = [(int(a, 16), ins) for a, ins in body]
        loop = []
        for a, ins in addr:
            target = re.search(r"0x([0-9a-f]+)", ins)
            if opcode(ins).startswith("BRA") and target and int(target.group(1), 16) < a:
                span = [i for b, i in addr if int(target.group(1), 16) <= b <= a]
                loop = span if len(span) > len(loop) else loop
        name = subprocess.run(["c++filt", fn], capture_output=True, text=True).stdout.strip() \
            if shutil.which("c++filt") else fn
        out[name] = dict(count([i for _, i in addr]), loop=count(loop), **ptxas.get(fn, {}))

    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            close()
            fn, body = m.group(1), []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;?\s*(?:/\*.*)?$", line)
        if m and fn and m.group(2):
            body.append((m.group(1), m.group(2).rstrip(" ;")))
    close()
    return out


def make_variants(tmp: str) -> list[str]:
    trees = []
    for name, values in VARIANTS.items():
        copy = torch_turns.copy_tree(os.path.join(tmp, name))
        path = os.path.join(copy, SOURCE)
        with open(path) as f:
            lines = f.read().splitlines(keepends=True)
        for prefix, value in values.items():
            hits = [i for i, ln in enumerate(lines) if ln.startswith(prefix)]
            if len(hits) != 1:
                raise SystemExit(f"FAIL: no single '{prefix}' line in {SOURCE}")
            comment = lines[hits[0]].partition("//")[2]
            lines[hits[0]] = f"{prefix}{value};" + (f"  //{comment}" if comment else "\n")
        with open(path, "w") as f:
            f.writelines(lines)
        trees.append(copy)
    return trees


def print_sass(trees: list[str]) -> None:
    print(json.dumps({"bound_ms": bounds_ms()}), flush=True)
    for tree in trees:
        print(json.dumps({"tree": tree, "sass": sass_counts(tree)}), flush=True)


def main() -> int:
    variants = "--variants" in sys.argv
    if variants:
        sys.argv.remove("--variants")
    return torch_turns.main(__file__, worker, reps=10, timed=lambda k: k.endswith("_ms"),
                            extra_trees=make_variants if variants else None, after=print_sass)


if __name__ == "__main__":
    sys.exit(main())
