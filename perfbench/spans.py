"""The program's own spans and counters (`gpis_tpu_torch.utils.profiling`),
recorded while the traced window's profiler ran, for the `program_span` and
`program_counter` readers under `metrics/`.  Each helper returns None where
nothing was recorded: an untraced run, a program without the recorder, or a
device span on no card.  Spans are (name, parent, request, start ns, end
ns); a session verb is a root span, and what it ran shares its request id.
"""

from __future__ import annotations

__all__ = ["snapshot", "per", "host_and_wait_ms", "device_ms", "counter", "syncs"]


def snapshot():
    """`profiling.snapshot()`, or None where the program has no recorder or
    recorded nothing."""
    try:
        from gpis_tpu_torch.utils.profiling import snapshot as snap
    except ImportError:
        return None
    got = snap()
    return got if got["spans"] or got["counters"] else None


def per(run, unit: str, value):
    """value over the window's completed units, or None."""
    if value is None or run.unit != unit or not run.units:
        return None
    return value / run.units


def host_and_wait_ms(snap, root: str):
    """Milliseconds of the closed root spans named `root`, split into the
    host's own time and the time in their outermost `wait.*` spans; None
    where there is no such root."""
    spans = snap["spans"]
    requests = {s[2] for s in spans if s[0] == root and s[1] == -1 and s[4] is not None}
    if not requests:
        return None
    total = sum(s[4] - s[3] for s in spans if s[0] == root and s[1] == -1 and s[2] in requests)
    waited = 0
    for s in spans:
        if s[2] not in requests or not s[0].startswith("wait.") or s[4] is None:
            continue
        p = s[1]
        while p != -1 and not spans[p][0].startswith("wait."):
            p = spans[p][1]
        if p == -1:  # no wait above it: counted once
            waited += s[4] - s[3]
    return 1e-6 * (total - waited), 1e-6 * waited


def device_ms(snap, name: str):
    """Device milliseconds of the spans named `name`, summed; None where none
    was timed on a card."""
    got = [ms for s, ms in zip(snap["spans"], snap["device_ms"]) if s[0] == name
           and ms is not None]
    return sum(got) if got else None


def counter(snap, name: str):
    return snap["counters"].get(name)


def syncs(snap):
    """Every `sync.<site>` count: the host's blocking waits on the card."""
    got = [v for k, v in snap["counters"].items() if k.startswith("sync.")]
    return sum(got) if got else None
