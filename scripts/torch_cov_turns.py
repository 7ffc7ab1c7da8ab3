#!/usr/bin/env python3
"""Kernel A (the covariance tile, gpis_tpu_torch/csrc/cov.cu) of several
source trees, timed in turns on one card, with its SASS counts.

    python3 scripts/torch_cov_turns.py [OTHER_TREE ...] [--variants] [--reps N]

Each OTHER_TREE is another checkout of this repository (an older commit, or
a variant of this one).  With --variants the script also copies this tree
to a temporary directory once for each entry of VARIANTS below, sets the
kernel's tuning constants there (the repository itself is never modified)
and adds the copies as other trees.  The trees run in turns
(`torch_turns.main`), each in a process of its own that imports that tree's
`gpis_tpu_torch` (building its kernels there), and each times A in float32,
rbf (lengthscale 0.4), on the same inputs made from one seed, at the shapes
the main path gives it (chip_smoke.py's): the 16,384² Gram with noise 1e-3
(Fibonacci sphere points), the cross of 8,192 queries (uniform in
[-1.5, 1.5]³) against those 16,384 points (the staged kq chunk), the
committee's cross of 8,192 queries against 7,168 points, the band of 8,192
rows at row0 16,384 of the C = 32,768 Gram with noise (phase 7's), and the
planner's chart predict (M = 1) and padded round (M = 256) against 17,408
points.  Each time is the mean of N calls by CUDA events after a warm-up,
queued behind a ~3 ms spin kernel so that the card's time and not the
host's enqueue is read (as chip_smoke.device_ms).  Each output is also
reduced to a digest (its bits as int32, weighted by position, summed in
int64 on the card), so that trees whose kernels give the same bits show the
same digest.  One JSON line a run, then for each other tree the per-shape
ratio of its two runs' mean to this tree's (OTHER / this), the card's name
and power limit, each shape's byte bound, and each tree's SASS counts: for
every function of cov.cu (`torch_turns.sass_counts`), its instructions,
MUFU operations and those of each loop (a float32 row loop has one MUFU an
element), beside ptxas's registers and spills.
"""

from __future__ import annotations

import json
import sys

import torch_turns

SOURCE = "gpis_tpu_torch/csrc/cov.cu"
HBM_BYTES = 3.35e12  # the H100's memory rate
# name: {constant line prefix in SOURCE: value}.  COV_ROWS: rows (16-byte
# vectors) a thread walks; COV_MIN_CTAS: __launch_bounds__' minimum CTAs a
# multiprocessor in float32 (a cap on registers).
_ROWS, _MIN = "constexpr int COV_ROWS = ", "constexpr int COV_MIN_CTAS = "
VARIANTS: dict[str, dict[str, str]] = {
    "rows4": {_ROWS: "4"}, "rows16": {_ROWS: "16"}, "min2": {_MIN: "2"}, "min8": {_MIN: "8"},
}


def shapes():
    """(name, rows M, columns C, row0 or None, sym) of the timed calls."""
    return (("gram_C16384", 16384, 16384, None, True),
            ("cross_M8192_C16384", 8192, 16384, None, False),
            ("committee_M8192_C7168", 8192, 7168, None, False),
            ("band_R8192_row0_16384_C32768", 8192, 32768, 16384, True),
            ("cross_M1_C17408", 1, 17408, None, False),
            ("cross_M256_C17408", 256, 17408, None, False))


def worker(tree: str, reps: int) -> dict:
    torch_turns.import_tree(tree)
    import torch

    from gpis_tpu_torch.data.gpis import fibonacci_sphere
    from gpis_tpu_torch.kernels import cuda_gram

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = {"lengthscale": 0.4, "signal_variance": 1.0}
    q = (torch.rand((8192, 3), generator=gen, device=dev) * 3.0 - 1.5).contiguous()
    out = {}
    for name, m, c, row0, sym in shapes():
        x = torch.as_tensor(fibonacci_sphere(c), dtype=torch.float32, device=dev)
        if sym:
            a = x if row0 is None else x[row0:row0 + m]
            noise = torch.full((m,), 1e-3, device=dev)
        else:
            a, noise = q[:m], None
        call = (lambda a=a, x=x, noise=noise, sym=sym, row0=row0:  # noqa: E731
                cuda_gram.cov("rbf", a, x, p, noise=noise, sym=sym, row0=row0))
        bits = call().view(torch.int32).flatten().to(torch.int64)
        weight = torch.arange(1, bits.numel() + 1, device=dev, dtype=torch.int64) % 1000003
        out[f"{name}_digest"] = int((bits * weight).sum().item())
        del bits, weight
        out[f"{name}_ms"] = torch_turns.device_ms(call, reps, spin=True)
    return out


def bounds_ms() -> dict:
    """Each shape's byte bound: the output written once, the coordinates of
    rows and columns and the noise read once (float32)."""
    return {name: 4 * (m * c + 3 * (m + c) + (m if sym else 0)) / HBM_BYTES * 1e3
            for name, m, c, _, sym in shapes()}


def print_sass(trees: list[str]) -> None:
    print(json.dumps({"bound_ms": bounds_ms()}), flush=True)
    for tree in trees:
        print(json.dumps({"tree": tree, "sass": torch_turns.sass_counts(tree, SOURCE)}),
              flush=True)


def main() -> int:
    variants = "--variants" in sys.argv
    if variants:
        sys.argv.remove("--variants")
    extra = (lambda tmp: torch_turns.make_variants(tmp, SOURCE, VARIANTS)) if variants else None
    return torch_turns.main(__file__, worker, reps=20, timed=lambda k: k.endswith("_ms"),
                            extra_trees=extra, after=print_sass)


if __name__ == "__main__":
    sys.exit(main())
