#!/usr/bin/env python3
"""The port's row-sharded session on P cards of one host, one NCCL rank a card.

    python3 scripts/torch_sharded_ranks.py [P] [N]   # P = 4, N = 16256 by default

Builds the kernels, then starts P processes of this script, rank r on
cuda:r, joined through a file store in a temporary directory (NCCL,
collectives time out after 60 s; the parent kills every rank still running
after 600 s).  Every rank builds chip_smoke.py phase 3's cloud (an N-point
Fibonacci sphere, rbf, lengthscale 0.4, surface noise 1e-3, 127 external
points and 1 internal, float32; C = 16,384 at the default N) and runs it
through the user entry point, ObjectModelSession(config,
mesh=MeshConfig(n_devices=P)): start twice (the first call carries the
process's one-time set-up), the 64^3 grid, a 65,536-point query.  Rank 0
then fits the same cloud on
its card alone (fit_inference) and holds the sharded grid and query to it.
Prints rank 0's JSON line (gaps, surface RMSE, times, launches, the cards'
names and power limits); exits nonzero if a rank fails, the posterior has
a NaN, the surface RMSE is 0.02 or more, or a gap exceeds 1e-2.  The times
are one sample each: the check is of correctness across cards.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GAP = 1e-2  # the sharded grid against the single-card one: float32, two factor orders
RMSE_GATE = 0.02


def rank_main(rank: int, world: int, n: int, store: str) -> int:
    import datetime

    import torch
    import torch.distributed as dist

    from gpis_tpu_torch import ModelConfig, ObjectModelSession, _build
    from gpis_tpu_torch.config import MeshConfig
    from gpis_tpu_torch.data.gpis import fibonacci_sphere

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        dist.all_reduce(torch.zeros((1,), device="cuda"))  # build the communicator
        _build.library()  # load the kernels the parent built
        torch.cuda.synchronize()
        cfg = ModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3, n_external=127,
                          n_internal=1, block=128, touch_capacity=0, grid_resolution=64,
                          grid_extent=1.5)
        pts = fibonacci_sphere(n).astype(np.float32)
        big = np.random.default_rng(7).uniform(-1.5, 1.5, size=(65536, 3)).astype(np.float32)
        _build.LAUNCHES.clear()
        sess = ObjectModelSession(cfg, mesh=MeshConfig(n_devices=world), device="cuda")
        first_fit_s = sess.start(pts).stats["fit_s"]
        sess.start(pts)
        mean, var, _ = sess.evaluate_grid()
        verts, _, _ = sess.extract_surface()
        t0 = time.perf_counter()
        big_mean, big_var = sess.query(big)
        big_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        out = {"ranks": world, "rank": rank, "device": str(sess.device),
               "capacity": sess.model.capacity, "first_fit_s": first_fit_s,
               "fit_s": sess.stats["fit_s"],
               "query_s": sess.stats["grid_s"], "big_query_s": big_s, "launches": launches}
    finally:
        dist.destroy_process_group()
    if rank != 0:
        return 0
    rmse = float(np.sqrt(np.mean((np.linalg.norm(verts, axis=1) - 1.0) ** 2)))
    ref = ObjectModelSession(cfg, device="cuda:0").start(pts)
    ref_mean, ref_var, _ = ref.evaluate_grid()
    ref_big_mean, ref_big_var = ref.query(big)
    query = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    cards = subprocess.run(query, capture_output=True, text=True, timeout=60).stdout
    out.update(
        surface_rmse=rmse, single_card_fit_s=ref.stats["fit_s"],
        grid_gap_mean=float(np.abs(mean - ref_mean).max()),
        grid_gap_var=float(np.abs(var - ref_var).max()),
        big_gap_mean=float(np.abs(big_mean - ref_big_mean).max()),
        big_gap_var=float(np.abs(big_var - ref_big_var).max()),
        finite=bool(all(np.isfinite(a).all() for a in (mean, var, big_mean, big_var))),
        cards=cards.strip().splitlines())
    print(json.dumps(out), flush=True)
    gaps = [out[k] for k in ("grid_gap_mean", "grid_gap_var", "big_gap_mean", "big_gap_var")]
    return 0 if out["finite"] and rmse < RMSE_GATE and max(gaps) <= GAP else 1


def main() -> int:
    import torch

    world = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 16256
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"FAIL: this script needs {world} CUDA cards", flush=True)
        return 1
    from gpis_tpu_torch import _build

    print(f"built the kernels in {_build.build()[1]:.1f} s", flush=True)  # once, for every rank
    store = os.path.join(tempfile.mkdtemp(prefix="gpis_nccl_"), "store")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                               str(world), str(n), store]) for r in range(world)]
    deadline = time.monotonic() + 600
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        print("FAIL: a rank did not finish in 600 s", flush=True)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    codes = [proc.returncode for proc in procs]
    if any(codes):
        print(f"FAIL: rank exit codes {codes}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        sys.exit(rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]))
    sys.exit(main())
