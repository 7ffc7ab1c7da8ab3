"""Device milliseconds a marginal-likelihood step between the events of the
program's `hyperopt.forward` spans (the loss: Gram, factor, solve)
(program_span)."""

from perfbench import spans


def read(run):
    snap = spans.snapshot()
    return spans.per(run, "step", snap and spans.device_ms(snap, "hyperopt.forward"))
