"""Tracing and timing hooks (port of gpis_tpu/utils/profiling.py): named
wall-clock stages that end in a device synchronize, and a profiler window
around a call.

`trace(dir)` wraps `torch.profiler.profile` (the CPU, and the card where
there is one) and writes a Chrome trace (chrome://tracing, Perfetto) into
`dir` when the block ends; `trace(None)` does nothing.  `device_sync`
waits for the card's work on the tensors it is given, where the JAX
package calls `block_until_ready`.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch

__all__ = ["Timer", "timed", "trace", "device_sync"]


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def device_sync(x):
    """Wait until the card's work producing the tensors in x (a tensor, or
    lists, tuples and dicts of them) is done; returns x (accurate timing)."""
    for dev in {t.device for t in _tensors(x) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return x


class Timer:
    """Accumulates named wall-clock stages; emits machine-readable JSON."""

    def __init__(self):
        self.stages: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    def json(self) -> str:
        return json.dumps({k: round(v, 6) for k, v in self.stages.items()})


@contextlib.contextmanager
def timed(label: str, out: dict | None = None):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if out is not None:
        out[label] = dt


@contextlib.contextmanager
def trace(log_dir: str | None):
    """A torch.profiler window whose Chrome trace lands in
    `log_dir/trace.<pid>.<ns>.json` when log_dir is set; no-op otherwise."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace.{os.getpid()}.{time.time_ns()}.json"))
