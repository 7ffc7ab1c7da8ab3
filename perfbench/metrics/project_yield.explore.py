"""Charts made over candidates projected (`plan.charts` / `project.tried`),
in %: the planner's useful outcomes over its attempts (program_counter)."""

from perfbench import spans


def read(run):
    snap = spans.snapshot()
    if snap is None or run.unit != "round":
        return None
    made, tried = spans.counter(snap, "plan.charts"), spans.counter(snap, "project.tried")
    return 100.0 * made / tried if made is not None and tried else None
