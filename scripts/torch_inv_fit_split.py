#!/usr/bin/env python3
"""Where a warm in-core fit's time goes on the card: one `torch.profiler`
window over `regression.fit_inference`, one GPU.

    python3 scripts/torch_inv_fit_split.py [TAG [TRACE_DIR]]

The training set is chip_smoke.py phase 3's (and phase 8's): a 16,256-point
Fibonacci sphere, rbf, lengthscale 0.4, surface noise 1e-3, 127 external
points and 1 internal, float32, so C = 16,384, factored and inverted in
256-wide blocks.  For each `panel_solve` route ("inv": Kernels J and K;
"xla": substitution), after two warm fits, one fit runs under the profiler
with each stage of the factor and TRSM loops wrapped in a named range
(`record_function`): the Gram (Kernel A), B, C, J and K, `_potrf`
(`cholesky_ex` and its `int(info)`, the host's one sync a factor step),
`_tri_small_inv` (its identity and copy) and the library's
`solve_triangular` (V = Ljj^{-1} on the "inv" route, the panel and row
substitutions on "xla").  Each device
event (kernel, copy, fill) is charged to the range whose host call
launched it; what no range launched is the loops' own copies and fills,
split by kernel name.  Printed per route:

* device ms and event count per range, and the top kernel names in each;
* host ms per call of each range (what the wrapper costs to enqueue);
* the device's busy and idle time over the fit, and the idle time that
  follows each `int(info)` copy back to the host (the launches queued
  after the sync sit on the critical path);
* the fit's host-clock time in the window, and fit_inference in turns
  (xla, inv, inv, xla) without the profiler;
* the host's microseconds per J and K call, whole and by part, beside
  `torch.matmul`'s (`host_parts`).

The ranges cost the host a few microseconds each: the window's fit is
slower than an unprofiled one, which the in-turns times give.  The chrome
trace goes to TRACE_DIR/inv_fit_trace_<TAG>_<route>.json (TRACE_DIR: the
repository's git-ignored traces/ unless given).  Prints one
JSON line with the card's name and power limit; exits nonzero without a
card or when the profiler saw no device event.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PREFIX = "fit/"


def _ranged(torch, name: str, fn):
    def call(*args, **kw):
        with torch.profiler.record_function(PREFIX + name):
            return fn(*args, **kw)
    return call


@contextlib.contextmanager
def _stages(torch):
    """Wrap each stage of the factor and TRSM loops in a named range."""
    from gpis_tpu_torch.gp import regression
    from gpis_tpu_torch.linalg import cuda_chol

    saved = []

    def patch(mod, attr, name):
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, _ranged(torch, name, getattr(mod, attr)))

    for attr, name in (("panel_update", "B panel_update"), ("row_update", "C row_update"),
                       ("panel_scale", "J panel_scale"), ("row_scale", "K row_scale"),
                       ("_potrf", "potrf (cholesky_ex + int(info))"),
                       ("_tri_small_inv", "_tri_small_inv (eye, copy)")):
        patch(cuda_chol, attr, name)
    patch(regression.kg, "gram", "A gram")
    patch(torch.linalg, "solve_triangular", "solve_triangular")
    try:
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def _kernel_group(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return name.split(" (")[0]
    if "fill" in low or low.startswith("memset"):
        return "fill"
    if "copy" in low:
        return "copy"
    return "other"


def _short(name: str) -> str:
    return name if len(name) <= 70 else name[:67] + "..."


def split_trace(events: list) -> dict:
    """Device time by the range that launched each device event; host time
    per range call; busy, idle and post-sync idle time of the device."""
    ranges = sorted(((e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):])
                     for e in events if e.get("cat") == "user_annotation"
                     and e.get("name", "").startswith(PREFIX)), key=lambda r: r[0])
    starts = [r[0] for r in ranges]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in HOST_LAUNCH_CATS and "correlation" in e.get("args", {})}
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])
    if not dev:
        return {}

    def owner(ts: float) -> str | None:
        # The innermost range holding the launch: the latest start before it
        # whose end is after it (a nested range, the library solve inside
        # `_tri_small_inv`, starts later and so wins).
        i = bisect.bisect_right(starts, ts) - 1
        while i >= 0:
            if ranges[i][1] >= ts:
                return ranges[i][2]
            i -= 1
        return None

    by_stage = collections.defaultdict(lambda: {"device_ms": 0.0, "events": 0,
                                                "kernels": collections.Counter()})
    for e in dev:
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        stage = owner(ts) if ts is not None else None
        if stage is None:
            stage = "loop body: " + _kernel_group(e["name"])
        s = by_stage[stage]
        s["device_ms"] += e["dur"] / 1e3
        s["events"] += 1
        s["kernels"][_short(e["name"])] += e["dur"] / 1e3
    host = collections.defaultdict(list)
    for t0, t1, name in ranges:
        host[name].append((t1 - t0) / 1e3)
    # Busy time: the union of device intervals; idle: the rest of the span.
    busy, cur0, cur1 = 0.0, dev[0]["ts"], dev[0]["ts"] + dev[0]["dur"]
    for e in dev[1:]:
        if e["ts"] > cur1:
            busy += cur1 - cur0
            cur0, cur1 = e["ts"], e["ts"] + e["dur"]
        else:
            cur1 = max(cur1, e["ts"] + e["dur"])
    busy += cur1 - cur0
    span = max(e["ts"] + e["dur"] for e in dev) - dev[0]["ts"]
    # Idle after each copy back to the host (`int(info)`): to the next start.
    after_sync = []
    for i, e in enumerate(dev[:-1]):
        if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]:
            end = e["ts"] + e["dur"]
            nxt = min((d["ts"] for d in dev[i + 1:i + 8]), default=end)
            after_sync.append(max(nxt - end, 0.0))
    return {
        "stages": {k: {"device_ms": v["device_ms"], "events": v["events"],
                       "top_kernels": {n: t for n, t in v["kernels"].most_common(3)}}
                   for k, v in sorted(by_stage.items(), key=lambda kv: -kv[1]["device_ms"])},
        "host_ms_per_call": {k: {"calls": len(v), "mean": float(np.mean(v)),
                                 "total": float(np.sum(v))} for k, v in host.items()},
        "device_span_ms": span / 1e3, "device_busy_ms": busy / 1e3,
        "device_idle_ms": (span - busy) / 1e3,
        "syncs": len(after_sync), "idle_after_sync_ms": float(np.sum(after_sync)) / 1e3,
        "idle_after_sync_mean_us": float(np.mean(after_sync)) if after_sync else 0.0,
    }


def host_parts(torch, cuda_chol, _build) -> dict:
    """Host microseconds per call of J at R = 8,064 and K at N = 8,448 (the
    factor's and TRSM's middle steps), whole and by part -- the argument
    checks, the output's allocation, the plan and its TMA check
    (`_tc_launch_args`), the launch through ctypes (tensor maps, launch) --
    beside `torch.matmul` on the same operands.  Each part is called 2,000
    times back to back, the card waited for every 200 outside the clock."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    c, b = 16384, 256
    a = torch.randn((c, c), generator=gen, device="cuda")
    v = torch.linalg.cholesky(a[:b, :b] @ a[:b, :b].T / b + torch.eye(b, device="cuda"))
    v = torch.linalg.solve_triangular(v, torch.eye(b, device="cuda"), upper=False).contiguous()
    acc, rhs = a[8320:, 8064:8320], torch.randn((b, 8448), generator=gen, device="cuda")
    j_out, k_out = torch.empty((acc.shape[0], b), device="cuda"), torch.empty_like(rhs)
    j_plan, _ = cuda_chol._tc_launch_args("panel_scale", acc, v, acc.shape[0], b, b,
                                          upper="cols")
    k_plan, _ = cuda_chol._tc_launch_args("row_scale", v, rhs, b, rhs.shape[1], b,
                                          upper="rows")
    parts = {
        "J panel_scale": lambda: cuda_chol.panel_scale(acc, v),
        "J check_cuda_rows": lambda: _build.check_cuda_rows("panel_scale", acc, v),
        "J output torch.empty": lambda: torch.empty((acc.shape[0], b), device="cuda"),
        "J _tc_launch_args": lambda: cuda_chol._tc_launch_args(
            "panel_scale", acc, v, acc.shape[0], b, b, upper="cols"),
        "J _build.call": lambda: _build.call(
            "gpis_panel_scale", acc, acc.data_ptr(), acc.stride(0), acc.shape[0], v.data_ptr(),
            v.stride(0), b, j_out.data_ptr(), b, *j_plan),
        "J's matmul": lambda: torch.matmul(acc, v.T),
        "K row_scale": lambda: cuda_chol.row_scale(v, rhs),
        "K _build.call": lambda: _build.call(
            "gpis_row_scale", rhs, v.data_ptr(), v.stride(0), b, rhs.data_ptr(), rhs.stride(0),
            rhs.shape[1], k_out.data_ptr(), rhs.shape[1], *k_plan),
        "K's matmul": lambda: torch.matmul(v, rhs),
    }
    out = {}
    for name, fn in parts.items():
        fn()
        secs = 0.0
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            secs += time.perf_counter() - t0
        out[name] = secs / 2000 * 1e6
    torch.cuda.synchronize()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: this script needs a CUDA card", flush=True)
        return 1
    from gpis_tpu_torch import ModelConfig, _build
    from gpis_tpu_torch.data import gpis
    from gpis_tpu_torch.data.gpis import fibonacci_sphere
    from gpis_tpu_torch.gp import regression
    from gpis_tpu_torch.kernels import functions as kf
    from gpis_tpu_torch.linalg import cuda_chol

    tag = sys.argv[1] if len(sys.argv) > 1 else "run"
    query = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    card = subprocess.run(query, capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    out: dict = {"tag": tag, "card": card, "build_s": _build.build()[1]}
    _build.library()
    cfg = ModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3, n_external=127,
                      n_internal=1, block=128, touch_capacity=0)
    ts = gpis.build_training_set(fibonacci_sphere(16256).astype(np.float32), cfg, device="cuda")
    params = kf.kernel_params(cfg.lengthscale, cfg.signal_variance)
    out["capacity"] = ts.x.shape[0]
    default = cuda_chol.PANEL_SOLVE

    def fit():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = regression.fit_inference(cfg.kernel, ts.x, ts.y, ts.noise, params,
                                         block=cfg.block, pad_noise=cfg.pad_noise)
        torch.cuda.synchronize()
        return model, time.perf_counter() - t0

    trace_dir = sys.argv[2] if len(sys.argv) > 2 else os.path.join(ROOT, "traces")
    os.makedirs(trace_dir, exist_ok=True)
    try:
        for route in ("inv", "xla"):
            cuda_chol.PANEL_SOLVE = route
            _build.LAUNCHES.clear()
            for _ in range(2):  # warm: plans cached, library handles made
                fit()
            launches = {k: v // 2 for k, v in _build.LAUNCHES.items()}
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with _stages(torch), torch.profiler.profile(activities=acts) as prof:
                _, fit_s = fit()
            path = os.path.join(trace_dir, f"inv_fit_trace_{tag}_{route}.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                split = split_trace(json.load(f)["traceEvents"])
            if not split:
                print(f"FAIL: the profiler saw no device event ({route})", flush=True)
                return 1
            out[route] = {"fit_s_profiled": fit_s, "launches_per_fit": launches, **split}
            print(f"route {route}: fit {fit_s * 1e3:.3f} ms under the profiler; device busy "
                  f"{split['device_busy_ms']:.3f} ms, idle {split['device_idle_ms']:.3f} ms "
                  f"({split['syncs']} syncs, {split['idle_after_sync_ms']:.3f} ms idle after "
                  "them)", flush=True)
            for name, s in split["stages"].items():
                host = split["host_ms_per_call"].get(name)
                host_s = (f"  host {host['mean'] * 1e3:.1f} us/call x {host['calls']}"
                          if host else "")
                print(f"  {name:48s} device {s['device_ms']:9.3f} ms  {s['events']:5d} events"
                      f"{host_s}", flush=True)
        out["host_us"] = host_parts(torch, cuda_chol, _build)
        print("host us a call: " + ", ".join(f"{k} {v:.1f}" for k, v in out["host_us"].items()),
              flush=True)
        turns = []
        for route in ("xla", "inv", "inv", "xla"):
            cuda_chol.PANEL_SOLVE = route
            turns.append([route, fit()[1]])
        out["fit_inference_s_in_turns"] = turns
    finally:
        cuda_chol.PANEL_SOLVE = default
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
