"""Device milliseconds a surface between the events of the program's
`shard.factor` spans on the traced rank: the distributed Cholesky factor
of its band, every jitter attempt, its collectives' waits included
(program_span)."""

from perfbench import spans


def read(run):
    snap = spans.snapshot()
    return spans.per(run, "surface", snap and spans.device_ms(snap, "shard.factor"))
