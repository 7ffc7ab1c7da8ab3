"""The covariance tiles (A for a value model, E for a joint one) against
their roofline: the least time of the surfaces' Grams (lower triangle) and
grid cross-covariances over their device time in the traced window, in %."""

import re

from perfbench import counts

KERNELS = re.compile(r"\b(joint_)?cov_kernel\b")


def read(run):
    if run.trace is None or run.unit != "surface" or not run.units:
        return None
    t = sum(s for k, s in run.trace.kernel_s.items() if KERNELS.search(k))
    if t <= 0:
        return None
    n, m = run.sizes["n"], run.sizes["m"]
    least, binds = counts.bound_s(fp32_flops=counts.gram_flops(n) + counts.cov_flops(m, n),
                                  nbytes=counts.gram_bytes(n) + counts.cov_bytes(m, n))
    return {"value": 100.0 * run.units * least / t, "binds": binds,
            "power_limit_w": run.power_limit_w}
