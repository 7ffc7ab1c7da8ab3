"""Mean host milliseconds of session.update in the window (it ends in a
synchronize)."""


def read(run):
    v = run.mean_span("update")
    return None if v is None else 1e3 * v
