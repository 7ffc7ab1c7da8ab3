"""Device milliseconds a surface between the events of the program's
`shard.linv` spans on the traced rank: its band of W = L^{-1} by the
distributed right-looking TRSM, its broadcasts' waits included
(program_span)."""

from perfbench import spans


def read(run):
    snap = spans.snapshot()
    return spans.per(run, "surface", snap and spans.device_ms(snap, "shard.linv"))
