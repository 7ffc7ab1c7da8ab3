#!/usr/bin/env python3
"""Kernels D and F of several source trees, timed in turns on one card.

    python3 scripts/torch_quad_turns.py [OTHER_TREE ...] [--reps N]

Each OTHER_TREE is another checkout of this repository (an older commit,
or a variant of this one), or just its `gpis_tpu_torch` package in a
directory.  The trees run in turns (`torch_turns.main`), each in a process
of its own that imports that tree's `gpis_tpu_torch` (building its kernels
there), and each times at phase 2's shapes of chip_smoke.py, in float32
on the same inputs made from one seed: D (`staged_quad`) at M 8,192 and
M 128 against C 16,384, F value at M 8,192, C 16,384, F joint at J 21,504,
F band value (R 4,096 at row0 28,672 of C 32,768) and F band joint (R 1,024
at row0 19,456 of J 20,480).  Each time is the mean of N calls by CUDA
events after a warm-up.  One JSON line a run, then for each other tree the
per-shape ratio of its two runs' mean to this tree's (OTHER / this), and
the card's name and power limit.
"""

from __future__ import annotations

import sys

import torch_turns


def worker(tree: str, reps: int) -> dict:
    torch_turns.import_tree(tree)
    import torch

    from gpis_tpu_torch.data.gpis import fibonacci_sphere
    from gpis_tpu_torch.kernels import cuda_joint, cuda_query
    from gpis_tpu_torch.kernels import gram as kg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = {"lengthscale": 0.4, "signal_variance": 1.0}

    def tril_w(rows, width, row0):
        w = torch.tril(torch.randn((rows, width), generator=gen, device=dev), diagonal=row0)
        return w.div_(torch.arange(row0 + 1, row0 + rows + 1, device=dev).sqrt()[:, None])

    def ms(fn):
        return torch_turns.device_ms(fn, reps)

    out = {}
    q = (torch.rand((8192, 3), generator=gen, device=dev) * 3.0 - 1.5).contiguous()
    x = torch.as_tensor(fibonacci_sphere(16384), dtype=torch.float32, device=dev)
    w = tril_w(16384, 16384, 0)
    alpha = torch.randn((16384,), generator=gen, device=dev)
    kq = kg.cross_cov("rbf", q, x, p)
    small = kq[:128]
    out["D_M8192_C16384"] = ms(lambda: cuda_query.staged_quad(kq, w, alpha))
    out["D_M128_C16384"] = ms(lambda: cuda_query.staged_quad(small, w, alpha))
    out["F_value_M8192_C16384"] = ms(
        lambda: cuda_query.fused_quad("value", "rbf", q, x, p, alpha, w))
    del kq, w
    jx = torch.as_tensor(fibonacci_sphere(5120), dtype=torch.float32, device=dev)
    jcols = cuda_joint.pack_meta(cuda_joint.joint_meta(jx, torch.zeros((1024, 3), device=dev)))
    wj = tril_w(jcols.shape[0], jcols.shape[0], 0)
    aj = torch.randn((jcols.shape[0],), generator=gen, device=dev)
    out["F_joint_M8192_J21504"] = ms(
        lambda: cuda_query.fused_quad("joint", "rbf", q, jcols, p, aj, wj))
    del wj
    xb = torch.as_tensor(fibonacci_sphere(32768), dtype=torch.float32, device=dev)
    wb = tril_w(4096, 32768, 28672)
    out["F_band_value_M8192_R4096_row0_28672"] = ms(
        lambda: cuda_query.quad_band("value", "rbf", q, xb, p, wb, 28672))
    del wb
    jb = cuda_joint.pack_meta(cuda_joint.joint_meta(jx))
    wjb = tril_w(1024, jb.shape[0], jb.shape[0] - 1024)
    out["F_band_joint_M8192_R1024_row0_19456"] = ms(
        lambda: cuda_query.quad_band("joint", "rbf", q, jb, p, wjb, jb.shape[0] - 1024))
    return out


def main() -> int:
    return torch_turns.main(__file__, worker, reps=5)


if __name__ == "__main__":
    sys.exit(main())
