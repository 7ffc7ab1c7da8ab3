"""Mean host seconds of next_best_path in the window (it returns host arrays,
so it ends in a synchronize)."""


def read(run):
    return run.mean_span("next_best_path")
