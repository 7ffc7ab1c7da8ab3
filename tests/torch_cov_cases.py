"""Kernel A's (gpis_tpu_torch/csrc/cov.cu) risky shapes and their inputs,
shared by tests/test_torch_kernels.py (the twin against the Pallas calls)
and tests/test_torch_cuda.py (the kernel against the twin)."""

import numpy as np


def edge_cases():
    """(mode, m, n) at the shapes Kernel A's tile makes risky: one row and
    130 (a thread's rows end mid-tile), 17 and 131 columns (n % 4 != 0, the
    scalar stores; the row ends mid-tile).  The Gram is square, at each of
    those sizes; a band takes m < n rows."""
    cases = [("cross", m, n) for m in (1, 130) for n in (17, 131)]
    cases += [("gram", n, n) for n in (1, 17, 130, 131)]
    cases += [("band", m, n) for m in (1, 130) for n in (17, 131) if m < n]
    return cases


def edge_inputs(mode, m, n):
    """float64 numpy inputs of one case, from a seed: n points with up to 4
    of them repeated at other indices (coincident points off the diagonal),
    noise uniform in [1e-4, 1e-2], m query rows (cross mode) and the band's
    row0 = (n - m) - (n - m) // 3, off every tile.  Returns (x, noise, q,
    row0); q is None but in cross mode, row0 None but in band mode."""
    rng = np.random.default_rng(m * 1000 + n)
    x = rng.normal(size=(n, 3))
    x[n // 2:n // 2 + min(4, n // 2)] = x[:min(4, n // 2)]
    noise = rng.uniform(1e-4, 1e-2, size=n)
    q = rng.normal(size=(m, 3)) if mode == "cross" else None
    row0 = (n - m) - (n - m) // 3 if mode == "band" else None
    return x, noise, q, row0
