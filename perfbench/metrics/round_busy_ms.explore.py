"""Device-busy milliseconds (the union of the operations' intervals in the
trace) per exploration round of the traced window: the device's share of a
round, steadier than the round's host-bound time."""

from perfbench.trace import busy_ms_per


def read(run):
    return busy_ms_per(run, "round")
