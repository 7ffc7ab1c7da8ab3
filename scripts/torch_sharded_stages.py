#!/usr/bin/env python3
"""Stage times of the port's row-sharded fit on a one-rank NCCL group, one card.

    python3 scripts/torch_sharded_stages.py [N]     # N = 16256 by default

The training set is chip_smoke.py phase 3's: an N-point Fibonacci sphere,
rbf, lengthscale 0.4, surface noise 1e-3, 127 external points and 1
internal, float32, so C = 16,384.  After the kernels are built and NCCL's
communicator is built (its first collective, timed apart), each stage of
`fit_sharded` runs, in turns with its alternatives where it has them: the
band Gram (Kernel A band); the distributed Cholesky, its panel updates
through Kernel G; W = L^{-1} right-looking with its trailing
update through Kernel L and through `addmm_`, and left-looking
(`sharded_linv_ll`); alpha.  Beside them, the in-core factor and TRSM on
the same Gram (Kernels B and C, and J and K under panel_solve="inv").
Every time is host clock around work that ends in
torch.cuda.synchronize().  Prints one JSON line with the card's name and
power limit; exits nonzero without a card.
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


def main() -> int:
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("FAIL: this script needs a CUDA card", flush=True)
        return 1
    from gpis_tpu_torch import ModelConfig, _build
    from gpis_tpu_torch.data import gpis
    from gpis_tpu_torch.data.gpis import fibonacci_sphere
    from gpis_tpu_torch.kernels import functions as kf
    from gpis_tpu_torch.kernels import gram as kg
    from gpis_tpu_torch.linalg import cuda_chol
    from gpis_tpu_torch.linalg import sharded as sh
    from gpis_tpu_torch.parallel.mesh import make_row_mesh

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 16256
    query = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    card = subprocess.run(query, capture_output=True, text=True, timeout=60).stdout.strip()
    cfg = ModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3, n_external=127,
                      n_internal=1, block=128, touch_capacity=0)
    ts = gpis.build_training_set(fibonacci_sphere(n).astype(np.float32), cfg, device="cuda")
    params = kf.kernel_params(cfg.lengthscale, cfg.signal_variance)
    store = tempfile.mkdtemp(prefix="gpis_nccl_")
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(store, 'store')}",
                            rank=0, world_size=1)
    out: dict = {"capacity": ts.x.shape[0], "card": card, "build_s": _build.build()[1]}
    _build.library()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    try:
        out["nccl_init_s"] = timed(lambda: dist.all_reduce(torch.zeros((1,), device="cuda")))[1]
        mesh = make_row_mesh(1)
        a, out["gram_band_s"] = timed(lambda: sh.sharded_gram("rbf", ts.x, params, ts.noise,
                                                              mesh))
        out["cholesky_s"] = []
        for _ in range(2):
            l, secs = timed(lambda: sh.sharded_cholesky(a.clone(), mesh, block=256))
            out["cholesky_s"].append(secs)
        trsm = {}
        for name in ("addmm", "kernel_L", "left_looking", "left_looking", "kernel_L", "addmm"):
            if name == "left_looking":
                w, secs = timed(lambda: sh.sharded_linv_ll(l, mesh, block=256))
            else:
                w, secs = timed(lambda: sh.sharded_linv(l, mesh, block=256,
                                                        use_kernel=name == "kernel_L"))
            trsm.setdefault(f"linv_{name}_s", []).append(secs)
            del w
        out.update(trsm)
        w = sh.sharded_linv(l, mesh, block=256)
        out["alpha_s"] = [timed(lambda: sh.sharded_alpha_from_linv(w, ts.y, mesh))[1]
                          for _ in range(2)]
        del w, l
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    incore = {}
    for ps in ("xla", "inv", "inv", "xla"):
        g = kg.gram("rbf", ts.x, params, noise=ts.noise)
        l, secs = timed(lambda: cuda_chol.blocked_cholesky(g, 256, panel_solve=ps))
        incore.setdefault(f"incore_cholesky_{ps}_s", []).append(secs)
        w, secs = timed(lambda: cuda_chol.blocked_linv(l, 256, inplace=True, panel_solve=ps))
        incore.setdefault(f"incore_linv_{ps}_s", []).append(secs)
        del g, l, w
    out.update(incore)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
