"""The host's blocking waits on the card a round, plan and update: every
`sync.<site>` count of the program (program_counter)."""

from perfbench import spans


def read(run):
    snap = spans.snapshot()
    return spans.per(run, "round", snap and spans.syncs(snap))
