"""One run of one cell: load what `BENCHMARK.json` names, set up, measure a
window, check the outputs against the plain reference, and assemble the
result line.

Everything that belongs to one configuration, one traffic mix, one cell's
limits or one metric is a file of its own that this module finds by name:
`configs/<config>.json`, `traffic/<traffic>.json` (whose `kind` names
`kinds/<kind>.py`, see `perfbench.loops`), `limits/<cell>.json` and
`metrics/<metric>.py` (a reader `read(run)` returning a number, a dict with
"value" and extra keys, or None when it finds nothing to read).
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import sys
import time

import torch

from perfbench import loops, trace

__all__ = ["HERE", "Run", "load_bench", "cell_spec", "applicable", "read_metric", "run_cell",
           "FORBIDDEN", "forbidden_modules"]

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "gpis_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Entries of sys.modules whose top-level name (before the first dot,
    compared whole) is one the port must not load."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_bench(root: str) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell_spec(bench: dict, cell: str, base: str = HERE) -> dict:
    """The cell's entry with its configuration, traffic and limits loaded."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if cell not in by_name:
        raise KeyError(f"no workload {cell!r}; BENCHMARK.json has {sorted(by_name)}")
    w = by_name[cell]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    return {"workload": w,
            "config": _json(os.path.join(base, "configs", os.path.basename(cfg["file"]))),
            "traffic": _json(os.path.join(base, "traffic", w["traffic"] + ".json")),
            "limits": _json(os.path.join(base, "limits", cell + ".json"))}


def applicable(metrics: list, cell: str) -> list:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def read_metric(name: str, run, base: str = HERE):
    path = os.path.join(base, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = mod.read(run)
    if got is None:
        return None
    return dict(got) if isinstance(got, dict) else {"value": float(got)}


class Run:
    """What a metric reader sees: the window's length, the units done, the
    spans (host seconds by name), the trace (or None), the problem's sizes,
    the peak device memory, the set-up time, the configuration and traffic,
    and the compared numbers (the control's too, where asked for)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def mean_span(self, name: str):
        v = self.spans.get(name)
        return sum(v) / len(v) if v else None


def run_cell(spec: dict, seed: int, seconds: float, with_trace: bool, *, device,
             t_process: float, power_limit_w=None, base: str = HERE, bench: dict | None = None,
             control: bool = False):
    """Set up, measure for `seconds`, check; returns (result, compared, run)
    where compared maps each number to (value, limit).  `control` adds the
    control's readings on the same window as `run.control`."""
    device = torch.device(device)
    cell = spec["workload"]["name"]
    loop = loops.make_loop(spec["config"], spec["traffic"], seed, device, base)
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    loop.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_process
    traces: list = []
    attempted = failed = units = 0
    ctx = trace.traced(device, traces) if with_trace else contextlib.nullcontext()
    with ctx:
        with torch.profiler.record_function(trace.WINDOW_SPAN):
            t0 = time.perf_counter()
            while True:
                attempted += 1
                try:
                    units += loop.request()
                except Exception as e:  # noqa: BLE001 - a failed request is counted, not fatal
                    failed += 1
                    print(f"request {attempted} failed: {type(e).__name__}: {e}", file=sys.stderr)
                if time.perf_counter() - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    loop.collect()
    loop.release()
    readings = loop.compare()
    control_readings = None
    if control:
        loop.control = True
        control_readings = loop.compare()
    limits = spec["limits"]
    compared = {k: (readings.get(k, math.inf), float(v)) for k, v in limits.items()}
    correct = failed == 0 and all(math.isfinite(v) and v <= lim for v, lim in compared.values())
    run = Run(cell=cell, window_s=window_s, setup_s=setup_s, units=units,
              unit=loop.unit, spans=loop.spans, sizes=loop.sizes,
              peak_bytes=peak, trace=traces[0] if traces else None, power_limit_w=power_limit_w,
              config=spec["config"], traffic=spec["traffic"], readings=readings,
              control=control_readings)
    bench = bench or {}
    wanted = applicable(bench.get("per_layer" if with_trace else "end_to_end", []), cell)
    metrics = {}
    for m in wanted:
        got = read_metric(m["name"], run, base)
        if got is not None:
            metrics[m["name"]] = {**got, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics}
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    return result, compared, run
