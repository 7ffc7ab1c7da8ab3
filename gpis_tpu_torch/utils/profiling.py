"""The port's tracing: spans and counters recorded while a torch.profiler
runs, and a profiler window around a call.

* `span(name, device=...)` -- a context manager.  While no profiler runs
  in the calling thread (`torch.autograd._profiler_enabled()`, a flag of
  the thread, is false) it is one shared no-op: no clock read, no
  allocation, no `record_function`.  While one runs it opens
  `record_function("gpis." + name)`, so the span lands in the profiler's
  Chrome trace beside the kernels, and appends (name, parent index, request
  id, start ns, end ns) on `time.perf_counter_ns` to the record.  A span
  opened with no span of its thread open above it is a root and takes a new
  request id; spans nested in it share that id.  With `device` (True for
  the current card, or a torch.device on one) the span also records a
  timing event on the card's current stream at entry and at exit.
* `spanned(name)` -- a decorator: the function's body in a span.
* `count(name, n)` -- adds n to a counter while a profiler runs.
* `wait(site, n)` -- a point where the host blocks on the card (n copies
  to the host in a row): adds n to `sync.<site>` and spans `wait.<site>`.
* `snapshot()` -- the record: `spans`, `counters`, `device_ms` (a device
  span's milliseconds between its events, else None; resolving them
  synchronizes the card once), and `anchor`, the pair (time.time_ns(),
  time.perf_counter_ns()) read when recording began, which maps the spans'
  clock onto the Chrome trace's (Unix ns = `baseTimeNanoseconds` + ts).
  `reset()` clears it.
* `trace(dir)` -- a torch.profiler window (the CPU, and the card where
  there is one) that writes `trace.<pid>.<ns>.json` (chrome://tracing,
  Perfetto) and the window's record as `spans.<pid>.<ns>.json` into `dir`
  when the block ends; `trace(None)` does nothing.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time

import torch

__all__ = ["span", "spanned", "count", "wait", "snapshot", "reset", "trace"]

_enabled = torch.autograd._profiler_enabled
_NOOP = contextlib.nullcontext()


class _Record:
    """Spans, counters and pending device events since the last reset."""

    def __init__(self):
        self.spans: list[list] = []  # [name, parent, request, start_ns, end_ns]
        self.counters: dict[str, int] = {}
        self.events: list = []  # (span index, device, start event, end event)
        self.device_ms: dict[int, float] = {}
        self.anchor = None
        self.requests = itertools.count()
        self.local = threading.local()  # .stack: the thread's open span indices

    def stack(self) -> list:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack


_record = _Record()


class _Span:
    __slots__ = ("name", "device", "rec", "index", "range", "start")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        rec = self.rec = _record
        if rec.anchor is None:
            rec.anchor = (time.time_ns(), time.perf_counter_ns())
        stack = rec.stack()
        parent = stack[-1] if stack else -1
        request = rec.spans[parent][2] if stack else next(rec.requests)
        self.index = len(rec.spans)
        rec.spans.append([self.name, parent, request, time.perf_counter_ns(), None])
        stack.append(self.index)
        # The host clock encloses the range, so a span's time holds the
        # range's own cost, as a host clock around the call would.
        self.range = torch.autograd.profiler.record_function("gpis." + self.name)
        self.range.__enter__()
        if self.device is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if self.device is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            rec.events.append((self.index, self.device, self.start, end))
        self.range.__exit__(*exc)
        rec.spans[self.index][4] = time.perf_counter_ns()
        rec.stack().pop()
        return False


def _card(device):
    """The card a device span times, or None (no card, or a CPU device)."""
    if device is True:
        if not torch.cuda.is_available():
            return None
        return torch.device("cuda", torch.cuda.current_device())
    if isinstance(device, torch.device) and device.type == "cuda":
        return device
    return None


def span(name: str, *, device=False):
    """A span named `name` while a profiler runs, else the shared no-op."""
    if not _enabled():
        return _NOOP
    return _Span(name, _card(device))


def spanned(name: str):
    """Decorator: each call of the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _enabled():
                return fn(*args, **kwargs)
            with _Span(name, None):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` while a profiler runs."""
    if _enabled():
        c = _record.counters
        c[name] = c.get(name, 0) + n


def wait(site: str, n: int = 1):
    """Wrap a point where the host blocks on the card (n times, for n
    copies to the host in a row): counts `sync.<site>` and spans
    `wait.<site>` while a profiler runs."""
    if not _enabled():
        return _NOOP
    count("sync." + site, n)
    return _Span("wait." + site, None)


def snapshot() -> dict:
    """The record since the last reset (see the module note); spans still
    open have end None."""
    rec = _record
    if rec.events:
        for dev in {dev for _, dev, _, _ in rec.events}:
            torch.cuda.synchronize(dev)
        for index, _, start, end in rec.events:
            rec.device_ms[index] = start.elapsed_time(end)
        rec.events = []
    return {"anchor": rec.anchor, "spans": [tuple(s) for s in rec.spans],
            "counters": dict(rec.counters),
            "device_ms": [rec.device_ms.get(i) for i in range(len(rec.spans))]}


def reset() -> None:
    """Forget every span, counter and device event recorded so far."""
    global _record
    _record = _Record()


@contextlib.contextmanager
def trace(log_dir: str | None):
    """A torch.profiler window whose Chrome trace lands in
    `log_dir/trace.<pid>.<ns>.json`, and its spans and counters in
    `log_dir/spans.<pid>.<ns>.json`, when log_dir is set; no-op otherwise."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with torch.profiler.profile(activities=activities) as prof:
        yield
    stem = f"{os.getpid()}.{time.time_ns()}.json"
    prof.export_chrome_trace(os.path.join(log_dir, "trace." + stem))
    with open(os.path.join(log_dir, "spans." + stem), "w") as f:
        json.dump(snapshot(), f)
