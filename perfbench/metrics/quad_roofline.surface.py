"""The variance quad's kernels (D, F: the split-TF32 tile with its QUAD
epilogue, and the partial rows' reduction) against their roofline: the
least time of the surfaces' quads (|W k_q|^2 over the grid, W triangular)
over their device time in the traced window, in %."""

import re

from perfbench import counts

# D and F are the split-TF32 tile with its QUAD epilogue (layout NT = 1, QUAD = 3);
# the others are the float64 routes' quad kernels.
KERNELS = re.compile(r"\btc_kernel<1, 3\b|\b(quad_reduce|quad_partial|fused_partial)_kernel\b")


def read(run):
    if run.trace is None or run.unit != "surface" or not run.units:
        return None
    t = sum(s for k, s in run.trace.kernel_s.items() if KERNELS.search(k))
    if t <= 0:
        return None
    n, m = run.sizes["n"], run.sizes["m"]
    least, binds = counts.bound_s(product_flops=counts.quad_flops(m, n),
                                  nbytes=counts.quad_bytes(m, n))
    return {"value": 100.0 * run.units * least / t, "binds": binds,
            "power_limit_w": run.power_limit_w}
