"""Device milliseconds a surface in the program's `comm.*` spans on the
traced rank: its stream's time in the broadcasts, all-reduces, all-gathers
and ring hops, waits on slower ranks included (program_span)."""

from perfbench import spans


def read(run):
    snap = spans.snapshot()
    if snap is None:
        return None
    got = [ms for s, ms in zip(snap["spans"], snap["device_ms"])
           if s[0].startswith("comm.") and ms is not None]
    return spans.per(run, "surface", sum(got) if got else None)
