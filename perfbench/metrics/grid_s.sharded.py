"""Mean of the session's own grid span, stats["grid_s"] (host clock, the
grid copied to the host), over the window's surfaces, on the traced rank
(the last band's)."""


def read(run):
    return run.mean_span("grid_s")
