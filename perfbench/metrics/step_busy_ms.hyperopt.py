"""Device-busy milliseconds (the union of the operations' intervals in the
trace) per marginal-likelihood step of the traced window."""

from perfbench.trace import busy_ms_per


def read(run):
    return busy_ms_per(run, "step")
