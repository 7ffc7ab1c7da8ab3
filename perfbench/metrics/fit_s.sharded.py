"""Mean of the session's own fit span, stats["fit_s"] (host clock ending in
a synchronize), over the window's surfaces, on the traced rank (the last
band's)."""


def read(run):
    return run.mean_span("fit_s")
