"""The surfaces' products (factor, W = L^-1, alpha, the grid's quad and mean:
perfbench.counts.surface_flops over the observed rows) over the traced
window's seconds and the card's TF32 peak, in %."""

from perfbench import counts


def read(run):
    if run.trace is None or run.trace.busy_s <= 0 or run.unit != "surface" or not run.units:
        return None
    flops = run.units * counts.surface_flops(run.sizes["n"], run.sizes["m"])
    return 100.0 * flops / (run.trace.window_s * counts.PEAKS["product_flops"])
