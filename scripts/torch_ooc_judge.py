#!/usr/bin/env python3
"""The port's out-of-core value fit at the JAX package's judge size, on one card.

    python3 scripts/torch_ooc_judge.py [N]        # N = 100128 by default

The problem is bench/ooc_staged.py's (BENCH_r05.json, N = 100,128): an
N-point Fibonacci sphere, rbf, lengthscale 0.4, surface noise 1e-3, 127
external points and 1 internal, float32, so C = 102,400 at panel 4,096.
It runs through the user entry point, ObjectModelSession.start(points,
out_of_core=True), on the default device budget (all the card can spare),
then one 65,536-point query and extract_surface on the 64^3 grid.  Prints
one JSON line: fit_s, query_s (the 65,536 points), grid_s, surface RMSE,
peak device memory, the spilled panels, the launches and the card.  Exits
nonzero without a card, or on NaN.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: this run needs a CUDA card", flush=True)
        return 1
    from gpis_tpu_torch import ModelConfig, ObjectModelSession, _build
    from gpis_tpu_torch.data.gpis import fibonacci_sphere

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100128
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    cfg = ModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3, n_external=127,
                      n_internal=1, block=128, touch_capacity=0, grid_resolution=64,
                      grid_extent=1.5)
    pts = fibonacci_sphere(n).astype(np.float32)
    q = np.random.default_rng(7).uniform(-1.25, 1.25, size=(65536, 3)).astype(np.float32)
    _build.library()  # the build is set-up, not fit time
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.LAUNCHES.clear()
    sess = ObjectModelSession(cfg, device="cuda").start(pts, out_of_core=True)
    fit_s = sess.stats["fit_s"]
    t0 = time.perf_counter()
    mean, var = sess.query(q)
    query_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    verts, faces, vvar = sess.extract_surface()
    extract_s = time.perf_counter() - t0
    rmse = float(np.sqrt(np.mean((np.linalg.norm(verts, axis=1) - 1.0) ** 2)))
    finite = bool(np.isfinite(mean).all() and np.isfinite(var).all() and np.isfinite(vvar).all())
    model = sess.model
    print(json.dumps({
        "n": n, "capacity": model.capacity, "panel": model.panel, "fit_s": fit_s,
        "query_s": query_s, "n_query": len(q), "grid_s": sess.stats["grid_s"],
        "extract_surface_s": extract_s, "surface_rmse": rmse, "n_verts": len(verts),
        "jitter": float(model.noise[0] - sess.training.noise[0]), "finite": finite,
        "w_panels_spilled": model.wstore.spilled(),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "launches": dict(_build.LAUNCHES), "card": card,
    }), flush=True)
    return 0 if finite else 1


if __name__ == "__main__":
    sys.exit(main())
