"""Shared driver of the scripts that time kernels of several source trees
in turns on one card (`torch_quad_turns.py`, `torch_joint_turns.py`,
`torch_cov_turns.py`).

A turns script defines a `worker(tree, reps) -> {name: value}` that runs
in a process of its own, imports that tree's `gpis_tpu_torch`
(`import_tree`) and times its kernels (`device_ms`).  `main` runs the
trees, then this tree, then all of them again in the reverse order (with
one other tree: OTHER, this, this, OTHER), prints one JSON line a run,
then for each other tree the ratio of its two runs' mean to this tree's
(OTHER / this) for every timed value, and the card's name and power limit.
`ignored` and `copy_tree` make copies of this tree without the directories
`.gitignore` lists (build outputs, logs, scratch checkouts); `make_variants`
makes such copies with a kernel's tuning constants set; `sass_counts` reads
a kernel source's SASS (nvcc and cuobjdump, on the machine with the card).
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from collections.abc import Callable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ignored() -> list[str]:
    """The names of the directories .gitignore lists."""
    with open(os.path.join(REPO, ".gitignore")) as f:
        return [os.path.basename(ln.strip().rstrip("/")) for ln in f if ln.strip().endswith("/")]


def copy_tree(dst: str) -> str:
    """Copy this tree to dst, without .git and the ignored directories."""
    shutil.copytree(REPO, dst, ignore=shutil.ignore_patterns(".git", *ignored()))
    return dst


def make_variants(tmp: str, source: str, variants: dict[str, dict[str, str]]) -> list[str]:
    """One copy of this tree in tmp for each entry of `variants` (name:
    {constant line prefix in `source`: value}), with those constants set."""
    trees = []
    for name, values in variants.items():
        copy = copy_tree(os.path.join(tmp, name))
        path = os.path.join(copy, source)
        with open(path) as f:
            lines = f.read().splitlines(keepends=True)
        for prefix, value in values.items():
            hits = [i for i, ln in enumerate(lines) if ln.startswith(prefix)]
            if len(hits) != 1:
                raise SystemExit(f"FAIL: no single '{prefix}' line in {source}")
            comment = lines[hits[0]].partition("//")[2]
            lines[hits[0]] = f"{prefix}{value};" + (f"  //{comment}" if comment else "\n")
        with open(path, "w") as f:
            f.writelines(lines)
        trees.append(copy)
    return trees


def import_tree(tree: str):
    """Put tree first on sys.path, check that its `gpis_tpu_torch` is the
    one imported, build its kernels, and return its `_build`."""
    sys.path.insert(0, tree)
    from gpis_tpu_torch import _build

    assert os.path.dirname(os.path.dirname(os.path.abspath(_build.__file__))) == \
        os.path.abspath(tree)
    _build.library()
    return _build


def device_ms(fn, reps: int, *, spin: bool = False) -> float:
    """Mean ms of `reps` calls of fn by CUDA events, after one warm-up call.
    With spin the calls queue behind a ~3 ms spin kernel, so that the card's
    time and not the host's enqueue is read."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if spin:
        torch.cuda._sleep(6_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)


def sass_counts(tree: str, source: str, ops: bool = False) -> dict:
    """Per function of the tree's `source` (nvcc -cubin for sm_90a,
    cuobjdump -sass): its SASS instructions, MUFU.EX2 and other MUFU
    operations, the same within each of its loops (the spans of its
    backward branches of 16 instructions or more, longest first), and
    ptxas's registers and spill bytes; with `ops`, each loop's count of
    every opcode too, and ptxas's warnings."""
    src = os.path.join(tree, source)
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "kernel.cubin")
        proc = subprocess.run([_tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
                               "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v", src, "-o", cubin],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode:
            return {"error": proc.stderr[-2000:]}
        ptxas, fn, notes = {}, None, []
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
            if ops and ("warning" in line.lower() or "Performance" in line):
                notes.append(line.strip())
        sass = subprocess.run([_tool("cuobjdump"), "-sass", cubin], capture_output=True,
                              text=True, timeout=300).stdout
    out, fn, body = {}, None, []

    def opcode(ins: str) -> str:
        words = ins.split()
        return words[1] if words[0].startswith("@") and len(words) > 1 else words[0]

    def count(ins_list):
        names = [opcode(i) for i in ins_list]
        out = {"instructions": len(names),
               "mufu_ex2": sum(o == "MUFU.EX2" for o in names),
               "mufu_other": sum(o.startswith("MUFU") and o != "MUFU.EX2" for o in names)}
        if ops:
            out["ops"] = dict(collections.Counter(names).most_common())
        return out

    def close():
        if fn is None:
            return
        addr = [(int(a, 16), ins) for a, ins in body]
        loops = []
        for a, ins in addr:
            target = re.search(r"0x([0-9a-f]+)", ins)
            if opcode(ins).startswith("BRA") and target and int(target.group(1), 16) < a:
                span = [i for b, i in addr if int(target.group(1), 16) <= b <= a]
                if len(span) >= 16:
                    loops.append(span)
        loops.sort(key=len, reverse=True)
        name = subprocess.run(["c++filt", fn], capture_output=True, text=True).stdout.strip() \
            if shutil.which("c++filt") else fn
        warnings = [n for n in notes if fn in n]
        out[name] = dict(count([i for _, i in addr]), loops=[count(lp) for lp in loops],
                         **ptxas.get(fn, {}), **({"warnings": warnings} if warnings else {}))

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


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def main(script: str, worker: Callable[[str, int], dict], *, reps: int,
         timed: Callable[[str], bool] = lambda key: True,
         extra_trees: Callable[[str], list[str]] | None = None,
         after: Callable[[list[str]], None] | None = None) -> int:
    """Command line of a turns script: `[OTHER_TREE ...] [--reps N]` (no
    other tree times this one alone, twice), or `--worker TREE` in the
    processes it starts.  `timed` picks the keys whose ratios are printed;
    `extra_trees(tmp)` adds trees made in a temporary directory;
    `after(trees)` prints more once the runs end."""
    args = sys.argv[1:]
    if "--reps" in args:
        i = args.index("--reps")
        reps = int(args[i + 1])
        del args[i:i + 2]
    if args and args[0] == "--worker":
        print(json.dumps(worker(args[1], reps)), flush=True)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        trees = [os.path.abspath(a) for a in args] + (extra_trees(tmp) if extra_trees else [])
        trees.append(REPO)
        runs = {tree: [] for tree in trees}
        for tree in trees + trees[::-1]:
            proc = subprocess.run([sys.executable, os.path.abspath(script), "--worker", tree,
                                   "--reps", str(reps)], capture_output=True, text=True,
                                  cwd=tree, timeout=1200)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            times = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[tree].append(times)
            print(json.dumps({"tree": tree, "ms": times}), flush=True)
        mine = runs[REPO]
        for tree in trees[:-1]:
            ratio = {k: (runs[tree][0][k] + runs[tree][1][k]) / (mine[0][k] + mine[1][k])
                     for k in mine[0] if timed(k)}
            print(json.dumps({"tree": tree, "other_over_this": ratio}), flush=True)
        print(json.dumps({"card": card()}), flush=True)
        if after:
            after(trees)
    return 0
