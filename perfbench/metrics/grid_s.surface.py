"""Mean of the session's own grid span, stats["grid_s"] (host clock, ending in
the copy to the host), over the window's surfaces."""


def read(run):
    return run.mean_span("grid_s")
