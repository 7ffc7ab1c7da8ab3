"""Kernel G on the traced rank (the split-TF32 tile's NT layout with its
SUB_FROM epilogue, `tc_kernel<1, 2`, the factor's panel update) against its
roofline: the least time of the band's panel updates
(`perfbench.counts_sharded`) over its device time in the traced window,
in %."""

import re

from perfbench import counts, counts_sharded

KERNELS = re.compile(r"\btc_kernel<1, 2\b")


def read(run):
    if run.trace is None or run.unit != "surface" or not run.units or "band" not in run.sizes:
        return None
    t = sum(s for k, s in run.trace.kernel_s.items() if KERNELS.search(k))
    if t <= 0:
        return None
    r0, r1 = run.sizes["band"]
    least, binds = counts.bound_s(
        product_flops=counts_sharded.panel_flops(r0, r1, run.sizes["block"]),
        nbytes=counts_sharded.panel_bytes(r0, r1))
    return {"value": 100.0 * run.units * least / t, "binds": binds,
            "power_limit_w": run.power_limit_w}
