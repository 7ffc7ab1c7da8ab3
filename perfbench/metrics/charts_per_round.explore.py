"""Charts the planner made a round (the program's `plan.charts`; the root
chart is not counted) (program_counter)."""

from perfbench import spans


def read(run):
    snap = spans.snapshot()
    return spans.per(run, "round", snap and spans.counter(snap, "plan.charts"))
