"""Device milliseconds a surface between the events of the program's
`chol.factor` spans: the fit's Cholesky factor, every jitter attempt
(program_span)."""

from perfbench import spans


def read(run):
    snap = spans.snapshot()
    return spans.per(run, "surface", snap and spans.device_ms(snap, "chol.factor"))
