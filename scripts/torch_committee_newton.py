#!/usr/bin/env python3
"""The committee's Newton step on W = L^{-1}, variant by variant, on one card.

    python3 scripts/torch_committee_newton.py [N=12800] [E=2]

Fits a committee at chip_smoke.py phase 13's configuration (rbf,
lengthscale 1.0, surface noise 1e-4, 64 touch slots, float32) on an
N-point Fibonacci sphere (12,800 points and two experts give phase 13's
B = 7,168), then for expert 0 forms W four ways from the same float32
factor L (Kernels A and B): raw (Kernel C's blocked TRSM), refined by the
JAX package's step with the residual I - L W in float32, refined with the
residual in float64 (the port's `experts._newton_w`), and a float32
triangular solve in place of W.  For each it prints the variance quad's
error at 8,192 grid points against float64 (the Gram factored in float64,
on the same kq), W's largest entry error against L's exact inverse
(relative to max|W|), and the step's milliseconds (CUDA events), with the
card's name and power limit.  One JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import numpy as np
    import torch

    from gpis_tpu_torch.config import ModelConfig
    from gpis_tpu_torch.data import gpis
    from gpis_tpu_torch.gp import experts as ex
    from gpis_tpu_torch.kernels import cuda_query
    from gpis_tpu_torch.kernels import gram as kg
    from gpis_tpu_torch.kernels.cuda_query import exact_fp32
    from gpis_tpu_torch.linalg import cholesky as lin
    from gpis_tpu_torch.surface import grid as grid_mod

    if not torch.cuda.is_available():
        print("FAIL: this script measures the card and needs one", flush=True)
        return 1
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 12800
    e = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    cfg = ModelConfig(kernel="rbf", lengthscale=1.0, noise_surface=1e-4, touch_capacity=64)
    ts = gpis.build_training_set(gpis.fibonacci_sphere(n).astype(np.float32), cfg, device="cuda")
    params = {"lengthscale": 1.0, "signal_variance": 1.0}
    model = ex.fit_experts("rbf", ts.x, ts.y, ts.noise, params, n_experts=e,
                           n_shared_tail=ts.n_internal + ts.n_external, touch_capacity=64)
    b = model.capacity
    x, noise, alpha = model.x[0], model.noise[0], model.alpha[0]
    l = lin.cholesky(kg.gram("rbf", x, params, noise=noise))
    raw = torch.tril(lin.blocked_linv(l, 512 if b % 512 == 0 else b))
    q = grid_mod.make_grid(64, 1.5, device="cuda")[0][:8192].contiguous()
    kq = kg.cross_cov("rbf", q, x, params)
    l64 = torch.linalg.cholesky(kg.gram("rbf", x.double(), params, noise=noise.double()))
    quad64 = torch.sum(torch.linalg.solve_triangular(l64, kq.double().T, upper=False) ** 2, dim=0)
    del l64
    inv64 = torch.linalg.solve_triangular(l.double(), torch.eye(b, dtype=torch.float64,
                                                                device="cuda"), upper=False)

    def newton_f32(out):
        with exact_fp32():
            r = l @ raw
            r.neg_().diagonal().add_(1.0)
            torch.tril(raw + raw @ r, out=out)

    def timed(fn):
        out = torch.empty_like(raw)
        fn(out)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        fn(out)
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    rows = {}
    for name, fn in (("newton_residual_float32", newton_f32),
                     ("newton_residual_float64", lambda out: ex._newton_w(l, raw, out))):
        w, ms = timed(fn)
        rows[name] = {"w": w, "ms": ms}
    rows["raw"] = {"w": raw, "ms": None}
    out = {"card": card, "n": n, "experts": e, "capacity": b, "expert_floor":
           float(torch.finfo(torch.float32).eps) * max(16.0, ex._FLOOR_SCALE * b)}
    wmax = inv64.abs().max().item()
    for name, row in rows.items():
        w = row["w"]
        quad = cuda_query.staged_quad(kq, w, alpha)[1]
        out[name] = {"quad_err": (quad.double() - quad64).abs().max().item(),
                     "w_rel_err": ((w.double() - inv64).abs().max() / wmax).item(),
                     "ms": row["ms"]}
    solve = torch.sum(torch.linalg.solve_triangular(l, kq.T, upper=False) ** 2, dim=0)
    out["solve_float32"] = {"quad_err": (solve.double() - quad64).abs().max().item()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
