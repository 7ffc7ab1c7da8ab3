"""Find where the port's host blocks on the card, cell by cell, and which
`profiling.wait` covers each place.

    python3 scripts/torch_sync_sites.py [CELL ...] [--seed N]

For each benchmark cell (default: every cell of BENCHMARK.json), sets the
cell's loop up on cuda:0 as `perfbench/run.py` does, then serves one
request under a CPU profiler (so the port's spans record) with
`torch.cuda.set_sync_debug_mode("warn")`.  Every synchronizing call warns;
each is attributed to its innermost frame in `gpis_tpu_torch/` (or the
innermost frame outside torch) and to the port's innermost open span.
Prints, per cell, each site with its count and the span it ran in (a
`wait.*` span covers it; anything else is a wait the record does not
name), then the request's counters.  Needs a CUDA card.
"""

import argparse
import collections
import os
import sys
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _site(stack) -> str:
    ours = [f for f in stack if f"{os.sep}gpis_tpu_torch{os.sep}" in f.filename]
    mine = [f for f in stack if f"{os.sep}torch{os.sep}" not in f.filename
            and not f.filename.endswith("warnings.py")]
    f = (ours or mine or stack)[-1]
    return f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} {f.name}"


def _open_span(profiling) -> str:
    rec = profiling._record
    stack = rec.stack()
    return rec.spans[stack[-1]][0] if stack else "(no span)"


def one_cell(cell: str, seed: int):
    import torch

    from gpis_tpu_torch.utils import profiling
    from perfbench import harness, loops

    spec = harness.cell_spec(harness.load_bench(ROOT), cell)
    loop = loops.make_loop(spec["config"], spec["traffic"], seed, torch.device("cuda:0"))
    loop.setup()
    torch.cuda.synchronize()
    sites = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        sites[(_site(traceback.extract_stack()[:-1]), _open_span(profiling))] += 1

    profiling.reset()
    shown = warnings.showwarning
    warnings.showwarning = hook
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    units = loop.request()
                    torch.cuda.synchronize()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
    finally:
        warnings.showwarning = shown
    snap = profiling.snapshot()
    print(f"== {cell} (seed {seed}): one request, {units} {loop.unit}(s)")
    for (site, span), n in sorted(sites.items()):
        mark = "" if span.startswith("wait.") else "   <- not in a wait span"
        print(f"  {n:6d}  {site}  in {span}{mark}")
    print(f"  counters: {dict(sorted(snap['counters'].items()))}")
    names = collections.Counter(s[0] for s in snap["spans"])
    print(f"  spans: {dict(sorted(names.items()))}")
    loop.release()
    return sum(n for (_, span), n in sites.items() if not span.startswith("wait."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cells", nargs="*")
    ap.add_argument("--seed", type=int, default=2**31 + 11)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from perfbench import harness

    cells = args.cells or [w["name"] for w in harness.load_bench(ROOT)["workloads"]]
    bare = sum(one_cell(c, args.seed) for c in cells)
    print(f"synchronizing calls outside any wait span: {bare}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
