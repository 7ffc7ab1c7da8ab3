#!/usr/bin/env python3
"""Kernel E (the joint covariance tile, gpis_tpu_torch/csrc/joint.cu) of
several source trees, timed in turns on one card, with its SASS counts.

    python3 scripts/torch_joint_turns.py [OTHER_TREE ...] [--variants] [--reps N]

Each OTHER_TREE is another checkout of this repository (an older commit, or
a variant of this one).  With --variants the script also copies this tree
to a temporary directory once for each entry of VARIANTS below, sets the
kernel's tuning constants there (the repository itself is never modified)
and adds the copies as other trees.  The trees run in turns
(`torch_turns.main`), each in a process of its own that imports that tree's
`gpis_tpu_torch` (building its kernels there), and each times E in float32
on the same inputs made from one seed, at chip_smoke.py's shapes: the joint
Gram at J = 21,504 (C = 5,120 sphere points and 1,024 touch slots at the
origin, noise 1e-3), the cross of 8,192 value queries against those J
columns, and phase 6's band of 1,024 rows at row0 19,456 with noise.  Each
time is the mean of N calls by CUDA events after a warm-up, queued behind a
~3 ms spin kernel so that the card's time and not the host's enqueue is
read (as chip_smoke.device_ms); the cross and the band are also held to
the plain twin (max error over max|K|).  One JSON line a run, then for
each other tree the per-shape ratio of its two runs' mean to this tree's
(OTHER / this), the card's name and power limit, each shape's byte bound,
and each tree's SASS counts: for every
function of joint.cu (`torch_turns.sass_counts`), its instructions, MUFU.EX2
and other MUFU operations, and those of each of its loops (the spans of its
backward branches), beside ptxas's registers and spills.
"""

from __future__ import annotations

import json
import sys

import torch_turns

SOURCE = "gpis_tpu_torch/csrc/joint.cu"
HBM_BYTES = 3.35e12  # the H100's memory rate
# name: {constant line prefix in SOURCE: value}.  JOINT_ROWS: rows (16-byte
# vectors) a thread; JOINT_MIN_CTAS: __launch_bounds__' minimum CTAs a
# multiprocessor in float32 (a cap on registers).
_ROWS, _MIN = "constexpr int JOINT_ROWS = ", "constexpr int JOINT_MIN_CTAS = "
VARIANTS: dict[str, dict[str, str]] = {
    "rows16": {_ROWS: "16"}, "rows64": {_ROWS: "64"}, "min3": {_MIN: "3"},
    "rows16_min1": {_ROWS: "16", _MIN: "1"},
}


def shapes():
    """(name, rows, row0, with noise) of the three timed calls; J = 21,504."""
    return (("gram_J21504", 21504, 0, True), ("cross_M8192_J21504", 8192, None, False),
            ("band_R1024_row0_19456_J21504", 1024, 19456, True))


def worker(tree: str, reps: int) -> dict:
    torch_turns.import_tree(tree)
    import torch

    from gpis_tpu_torch.data.gpis import fibonacci_sphere
    from gpis_tpu_torch.kernels import cuda_joint

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = {"lengthscale": 0.4, "signal_variance": 1.0}
    x = torch.as_tensor(fibonacci_sphere(5120), dtype=torch.float32, device=dev)
    cols = cuda_joint.joint_meta(x, torch.zeros((1024, 3), device=dev))
    j = cols[0].shape[0]
    noise = torch.full((j,), 1e-3, device=dev)
    q = (torch.rand((8192, 3), generator=gen, device=dev) * 3.0 - 1.5).contiguous()

    out = {}
    for name, r, row0, with_noise in shapes():
        rows = cols if r == j else (cuda_joint.value_meta(q) if row0 is None else
                                    tuple(t[row0:row0 + r] for t in cols))
        nz = noise if with_noise else None
        call = (lambda rows=rows, nz=nz, row0=row0:  # noqa: E731
                cuda_joint.joint_rows("rbf", rows, cols, p, noise_col=nz, row0=row0 or 0))
        if r < j:
            want = cuda_joint.joint_rows_reference("rbf", rows, cols, p, noise_col=nz,
                                                   row0=row0 or 0)
            err = (call() - want).abs().max().item() / want.abs().max().item()
            out[f"{name}_rel_err"] = err
            del want
        out[f"{name}_ms"] = torch_turns.device_ms(call, reps, spin=True)
    return out


def bounds_ms() -> dict:
    """Each shape's byte bound: the output written once, the 7-float
    metadata of rows and columns and the noise read once (float32)."""
    j = 21504
    return {name: 4 * (r * j + 7 * (r + j) + (j if nz else 0)) / HBM_BYTES * 1e3
            for name, r, _, nz in shapes()}


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
    return torch_turns.main(__file__, worker, reps=10, timed=lambda k: k.endswith("_ms"),
                            extra_trees=extra, after=print_sass)


if __name__ == "__main__":
    sys.exit(main())
