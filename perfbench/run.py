"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload value20k.grid --seed 7 --seconds 20 --trace 0

Loads and warms up the cell (set-up), measures for --seconds (the window
closes when the request in flight at that time completes), checks what the
window produced against the plain reference, and prints, as the last line
of standard output, one JSON object: correct, attempted, failed, metrics
(the cell's end-to-end metrics, or with --trace 1 its per-layer metrics),
device, with --trace 1 breakdown, and last `compared`, each number checked
beside its limit (also the last lines of standard error).  Exits non-zero
without printing a result when there is no CUDA card, when the package
under test is not beside this folder, or when the JAX package or JAX was
loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def power_limit_w():
    """The card's power limit in watts, or None where nvidia-smi cannot say."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    bench = harness.load_bench(ROOT)
    spec = harness.cell_spec(bench, args.workload)
    chips = int(spec["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    import gpis_tpu_torch

    where = os.path.dirname(os.path.dirname(os.path.abspath(gpis_tpu_torch.__file__)))
    if where != ROOT:
        print(f"gpis_tpu_torch was imported from {where}, not from this checkout {ROOT}",
              file=sys.stderr)
        return 2
    limit_w = power_limit_w()
    result, compared, run = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                                             device="cuda:0", t_process=T_PROCESS,
                                             power_limit_w=limit_w, bench=bench)
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules were loaded: {bad}", file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                        "count": chips, "memory_peak_bytes": run.peak_bytes,
                        "power_limit_w": limit_w}
    if run.trace is not None:
        result["device"].update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    print(f"card {result['device']['kind']}, power limit {limit_w} W; set-up {run.setup_s} s, "
          f"window {run.window_s} s, {run.units} {run.unit}s in {result['attempted']} requests",
          file=sys.stderr)
    for k, (v, lim) in compared.items():
        print(f"{k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
