"""Time the port's recorder (`gpis_tpu_torch/utils/profiling.py`) on this
host: an empty span, wait, device span and count, with no profiler running
and under `torch.profiler` (CPU, and CUDA where there is a card), beside a
bare `record_function` range and an empty call.

    python3 scripts/torch_span_cost.py [N]

Prints one JSON line: microseconds a call, each the best of 5 passes of N
calls (default 5,000).
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from gpis_tpu_torch.utils import profiling  # noqa: E402


def _empty():
    pass


def _span():
    with profiling.span("cost"):
        pass


def _device_span():
    with profiling.span("cost", device=True):
        pass


def _wait():
    with profiling.wait("cost"):
        pass


def _count():
    profiling.count("cost")


def _range():
    with torch.autograd.profiler.record_function("cost"):
        pass


CALLS = {"empty": _empty, "span": _span, "device_span": _device_span, "wait": _wait,
         "count": _count, "record_function": _range}


def _us(fn, n: int) -> float:
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter_ns() - t0) / n / 1e3)
        profiling.reset()
    return best


def main(argv=None) -> int:
    n = int((argv or sys.argv[1:] or [5000])[0])
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.init()
    out = {"n": n, "card": torch.cuda.get_device_name(0) if torch.cuda.is_available() else None,
           "off": {k: _us(f, n) for k, f in CALLS.items()}}
    with torch.profiler.profile(activities=acts):
        out["on"] = {k: _us(f, n) for k, f in CALLS.items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
