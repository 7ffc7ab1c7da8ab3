#!/usr/bin/env python3
"""Kernels D and F of several source trees, timed in turns on one card.

    python3 scripts/torch_quad_turns.py [OTHER_TREE ...] [--reps N]

Each OTHER_TREE is another checkout of this repository (an older commit,
or a variant of this one), or just its `gpis_tpu_torch` package in a
directory.  The trees run in turns (`torch_turns.main`), each in a process
of its own that imports that tree's `gpis_tpu_torch` (building its kernels
there), and each times at phase 2's shapes of chip_smoke.py, in float32
on the same inputs made from one seed: D (`staged_quad`) at M 8,192 and
M 128 against C 16,384, at M 8,192 against C 20,480 (the benchmark's
capacity) and at the planner's M 1, 32, 256 and 2,048 against C 17,408,
F value at M 8,192, C 16,384, F joint at J 21,504,
F band value (R 4,096 at row0 28,672 of C 32,768), F band joint (R 1,024
at row0 19,456 of J 20,480) and F band value at the last rank's band of the
four-card cell `sharded147k` (R 36,864 at row0 110,592 of C 147,456: a
21.7 GB band, one call ~2 s, so half as many calls).  Each time is the mean
of N calls by CUDA events after a warm-up.  One JSON line a run, then for
each other tree the per-shape ratio of its two runs' mean to this tree's
(OTHER / this), and the card's name and power limit.  Then, for every
tree, the SASS of D (`torch_turns.sass_counts` on csrc/query.cu) and of F
value and joint (csrc/fused_query.cu): registers, spills and ptxas's
warnings, and each loop of 16 instructions or more with its instructions
by pipe (`PIPES`: ALU, FMA, the tensor cores' HGMMA, the uniform datapath,
shared memory and barriers) and by opcode.
"""

from __future__ import annotations

import json
import sys

import torch_turns

# The pipe each SASS opcode (its name before the first dot) issues to on
# sm_90, as NVIDIA's profiler names them: "alu" (integer and logic, 16 lanes
# a quarter), "fma" (FP32 add, multiply, FMA, and the integer multiply-add
# IMAD of ptxas's balancing), "hgmma" (the warpgroup MMA), "uniform" (the
# warp-uniform datapath), "shared" (shared-memory loads, stores and
# mbarriers), anything else "other".  VIADD, the integer add ptxas
# alternates with IADD3, is "other": its pipe is not documented.
PIPES = {
    "alu": {"IADD3", "LOP3", "SHF", "LEA", "ISETP", "FSETP", "SEL", "FSEL", "PRMT", "IMNMX",
            "FMNMX", "MOV", "BMSK", "SGXT", "IABS", "VIMNMX", "PLOP3", "P2R", "R2P", "FLO",
            "POPC", "BREV", "CS2R", "S2R"},
    "fma": {"FADD", "FMUL", "FFMA", "IMAD", "IMUL", "FMUL32I", "FADD32I", "FFMA32I",
            "IMAD32I"},
    "hgmma": {"HGMMA", "WARPGROUP", "WARPSYNC"},
    "uniform": {"UIADD3", "UMOV", "ULOP3", "USHF", "ULEA", "UISETP", "USEL", "UPRMT", "R2UR",
                "S2UR", "UIMAD", "ULDC", "UBMSK", "UFLO", "UPOPC", "UPLOP3", "VOTEU"},
    "shared": {"LDS", "STS", "LDSM", "SYNCS", "BAR", "ATOMS", "MEMBAR", "FENCE", "UTMALDG",
               "UBLKCP"},
}


def pipe_of(opcode: str) -> str:
    base = opcode.split(".")[0]
    return next((pipe for pipe, names in PIPES.items() if base in names), "other")


def print_sass(trees: list[str]) -> None:
    """D's and F's SASS in each tree: registers, spills, ptxas's warnings,
    and each loop's instructions by pipe and by opcode."""
    for tree in trees:
        fns = {}
        for source in ("query.cu", "fused_query.cu"):
            fns.update(torch_turns.sass_counts(tree, f"gpis_tpu_torch/csrc/{source}", ops=True))
        for name, f in fns.items():
            if "tc_kernel<1, 3" not in name:
                continue
            loops = []
            for lp in f["loops"]:
                pipes: dict = {}
                for op, n in lp["ops"].items():
                    pipes[pipe_of(op)] = pipes.get(pipe_of(op), 0) + n
                loops.append({"instructions": lp["instructions"], "by_pipe": pipes,
                              "ops": lp["ops"]})
            print(json.dumps({"tree": tree, "sass": name, "instructions": f["instructions"],
                              **{k: f.get(k) for k in ("registers", "spill_bytes", "warnings")},
                              "loops": loops}), flush=True)


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
        w = torch.randn((rows, width), generator=gen, device=dev).tril_(diagonal=row0)
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
    for c, sizes in ((20480, (8192,)), (17408, (1, 32, 256, 2048))):
        xc = torch.as_tensor(fibonacci_sphere(c), dtype=torch.float32, device=dev)
        wc = tril_w(c, c, 0)
        ac = torch.randn((c,), generator=gen, device=dev)
        kqc = kg.cross_cov("rbf", q[:max(sizes)], xc, p)
        for m in sizes:
            out[f"D_M{m}_C{c}"] = ms(lambda: cuda_query.staged_quad(kqc[:m], wc, ac))
        del wc, kqc
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
    del wjb, xb
    xr = torch.as_tensor(fibonacci_sphere(147456), dtype=torch.float32, device=dev)
    wr = tril_w(36864, 147456, 110592)
    out["F_band_value_M8192_R36864_row0_110592"] = torch_turns.device_ms(
        lambda: cuda_query.quad_band("value", "rbf", q, xr, p, wr, 110592), max(1, reps // 2))
    return out


def main() -> int:
    return torch_turns.main(__file__, worker, reps=5, after=print_sass)


if __name__ == "__main__":
    sys.exit(main())
