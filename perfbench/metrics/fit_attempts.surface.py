"""Factor attempts a fit: the program's `fit.attempts` over its
`session.start` spans; above 1, the jitter ladder refactored
(program_counter)."""

from perfbench import spans


def read(run):
    snap = spans.snapshot()
    if snap is None or run.unit != "surface":
        return None
    starts = sum(1 for s in snap["spans"] if s[0] == "session.start" and s[1] == -1)
    tried = spans.counter(snap, "fit.attempts")
    return tried / starts if tried is not None and starts else None
