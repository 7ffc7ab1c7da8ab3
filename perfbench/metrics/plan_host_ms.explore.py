"""Host milliseconds a round of the program's `session.next_best_path` span
outside its `wait.*` spans: the planner's own host work, while the card
idles (program_span)."""

from perfbench import spans


def read(run):
    snap = spans.snapshot()
    got = snap and spans.host_and_wait_ms(snap, "session.next_best_path")
    return spans.per(run, "round", got and got[0])
