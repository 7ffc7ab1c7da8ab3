"""Kernel F's band mode on the traced rank (the split-TF32 tile with its
QUAD epilogue, `tc_kernel<1, 3`, once a ring hop) against its roofline:
the least time of the band's share of the surfaces' |W k_q|^2 over the
grid (`perfbench.counts_sharded`) over its device time in the traced
window, in %."""

import re

from perfbench import counts, counts_sharded

KERNELS = re.compile(r"\btc_kernel<1, 3\b")


def read(run):
    if run.trace is None or run.unit != "surface" or not run.units or "band" not in run.sizes:
        return None
    t = sum(s for k, s in run.trace.kernel_s.items() if KERNELS.search(k))
    if t <= 0:
        return None
    (r0, r1), m = run.sizes["band"], run.sizes["m"]
    least, binds = counts.bound_s(product_flops=counts_sharded.band_quad_flops(m, r0, r1),
                                  nbytes=counts_sharded.band_quad_bytes(m, r0, r1))
    return {"value": 100.0 * run.units * least / t, "binds": binds,
            "power_limit_w": run.power_limit_w}
