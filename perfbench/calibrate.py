"""Readings from which a cell's limits are set: in one process, a short run
of the cell on each seed, its compared numbers, and with --control the
control's on the same window (the reference in float32 with TF32 products,
in the program's place); with --fault NAME the same under a planted fault.

    python3 perfbench/calibrate.py --workload value20k.grid --seeds 1-12 --seconds 5 --control
    python3 perfbench/calibrate.py --workload value20k.hyperopt --seeds 1-3 --seconds 1 \\
        --fault unchanged --fault half --fault altered

One JSON line a run, then a summary line: for each number the largest
program reading, the smallest control reading and each fault's smallest.
Needs a CUDA card.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", action="append", default=[])
    args = ap.parse_args(argv)

    import torch

    from perfbench import faults, harness

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_bench(ROOT)
    spec = harness.cell_spec(bench, args.workload)
    summary: dict = {"program": {}, "control": {}}
    for fault in [None] + args.fault:
        for seed in seeds(args.seeds):
            t0 = time.perf_counter()
            planted = (contextlib.nullcontext() if fault is None
                       else faults.planted(fault, spec["traffic"]["kind"]))
            with planted:
                _, _, run = harness.run_cell(spec, seed, args.seconds, False, device="cuda:0",
                                             t_process=t0, bench=bench,
                                             control=args.control and fault is None)
            line = {"workload": args.workload, "seed": seed, "fault": fault,
                    "readings": run.readings, "control": run.control, "units": run.units,
                    "window_s": run.window_s, "setup_s": run.setup_s,
                    "peak_bytes": run.peak_bytes, "run_s": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            side = "program" if fault is None else fault
            for k, v in run.readings.items():
                best = summary.setdefault(side, {}).get(k)
                summary[side][k] = v if best is None else (max(best, v) if fault is None
                                                           else min(best, v))
            for k, v in (run.control or {}).items():
                best = summary["control"].get(k)
                summary["control"][k] = v if best is None else min(best, v)
            torch.cuda.empty_cache()
    print(json.dumps({"summary": summary, "workload": args.workload,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
