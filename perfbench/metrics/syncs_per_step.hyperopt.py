"""The host's blocking waits on the card a marginal-likelihood step, each
call's refit shared over its steps: every `sync.<site>` count of the
program (program_counter)."""

from perfbench import spans


def read(run):
    snap = spans.snapshot()
    return spans.per(run, "step", snap and spans.syncs(snap))
