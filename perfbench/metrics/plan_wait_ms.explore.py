"""Host milliseconds a round in the `wait.*` spans inside the program's
`session.next_best_path` span: the planner's waits on the card
(program_span)."""

from perfbench import spans


def read(run):
    snap = spans.snapshot()
    got = snap and spans.host_and_wait_ms(snap, "session.next_best_path")
    return spans.per(run, "round", got and got[1])
