"""The device trace of a window: torch.profiler over the window, read back
from its Chrome trace.

From it: the seconds in which an operation ran on the device (the union of
kernel, copy and set intervals inside the window), the window's length,
the device time of each kernel by name, and the idle gaps between device
operations named by what the host was doing meanwhile (the innermost host
event over the gap's middle, under the benchmark's own span).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile

import torch

__all__ = ["Trace", "traced", "short_name", "idle_share", "busy_ms_per", "WINDOW_SPAN"]

WINDOW_SPAN = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def short_name(name: str) -> str:
    """A kernel's name without 'void ' and its argument list."""
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            return name[:i]
    return name


class Trace:
    """What a traced window held: `window_s`, `busy_s`, `kernel_s` (device
    seconds by short kernel name) and `gaps` (idle seconds by host
    activity)."""

    def __init__(self, events: list):
        win = [e for e in events if e.get("name") == WINDOW_SPAN and e.get("ph") == "X"
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace holds no window span")
        t0, t1 = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])
        self.window_s = (t1 - t0) * 1e-6
        dev, host = [], []
        for e in events:
            if e.get("ph") != "X" or "ts" not in e:
                continue
            a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
            if b <= t0 or a >= t1:
                continue
            a, b = max(a, t0), min(b, t1)
            if e.get("cat") in DEVICE_CATS:
                dev.append((a, b, short_name(e["name"])))
            elif e.get("cat") in HOST_CATS and e["name"] != WINDOW_SPAN:
                host.append((a, b, e["name"], e.get("cat")))
        self.kernel_s = collections.Counter()
        for a, b, name in dev:
            self.kernel_s[name] += (b - a) * 1e-6
        merged = []
        for a, b, _ in sorted(dev):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) * 1e-6
        self.gaps = self._gaps(merged, t0, t1, host)

    @staticmethod
    def _gaps(merged, t0, t1, host) -> collections.Counter:
        """Idle seconds by label: the benchmark's span over the gap's middle
        and the innermost other host event there ("python" where none: the
        host ran code that records no event)."""
        edges = [t0] + [x for iv in merged for x in iv] + [t1]
        ours = sorted((a, b, n[len("perfbench."):]) for a, b, n, c in host
                      if c == "user_annotation" and n.startswith("perfbench."))
        rest = sorted(h for h in host if not (h[3] == "user_annotation"
                                              and h[2].startswith("perfbench.")))
        out = collections.Counter()
        for i in range(0, len(edges), 2):
            a, b = edges[i], edges[i + 1]
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            out[" > ".join((_covering(ours, mid) or "between requests",
                            _covering(rest, mid) or "python"))] += (b - a) * 1e-6
        return out

    def breakdown(self, n: int = 10) -> dict:
        return {"device_ops": [[k, v] for k, v in self.kernel_s.most_common(n)],
                "idle_gaps": [[k, v] for k, v in self.gaps.most_common(n)]}


def _covering(events, t, depth: int = 4096):
    """The name of the latest-starting event of `events` (sorted by start)
    that covers t, among the `depth` that start last before it."""
    j = bisect.bisect_right(events, (t, float("inf"))) - 1
    for k in range(j, max(j - depth, -1), -1):
        if events[k][1] >= t:
            return events[k][2]
    return None


def idle_share(run):
    """Share of the traced window in which no operation ran on the device,
    in %: the reader of every cell's `idle_share.<cell kind>` metric."""
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def busy_ms_per(run, unit: str):
    """Device-busy milliseconds (the union of the operations' intervals) per
    `unit` completed in the traced window."""
    if run.trace is None or run.trace.busy_s <= 0 or run.unit != unit or not run.units:
        return None
    return 1e3 * run.trace.busy_s / run.units


@contextlib.contextmanager
def traced(device: torch.device, holder: list):
    """Profile the body; on exit append its Trace to `holder`.  The Chrome
    trace goes to a temporary file under TMPDIR and is removed."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    holder.append(Trace(events))
