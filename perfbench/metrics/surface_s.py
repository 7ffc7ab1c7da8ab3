"""The window's seconds over the surfaces completed (host clock;
every request ends in a synchronize, and the window closes when the
request in flight at --seconds completes)."""


def read(run):
    if run.unit != "surface" or not run.units:
        return None
    return run.window_s / run.units
