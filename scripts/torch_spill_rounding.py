#!/usr/bin/env python3
"""Phase 7's rounding control, on one card: how far the host-spill fit's
posterior moves with the rounding of Kernel H's products.

    python3 scripts/torch_spill_rounding.py

Reruns `chip_smoke.py` phase 7's out-of-core fit (C = 32,768, panel 4,096,
a 1 GB tiered device budget) and its 65,536-point query with the
out-of-core TRSM's NN product (Kernel H, `cuda_chol.gemm_nn_acc_masked`)
taken three ways:

* kernel -- the port's split-TF32 tensor-core kernel;
* twin   -- its plain twin, one float32 cuBLAS product (`addmm` in FP32);
* f64    -- the update in float64, rounded once to float32.

Each on phase 7's training-set order (the Fibonacci sphere as built) and on
three seeded permutations of its rows, and each held, as phase 7 is, to a
float64 plain fit of the same order: the max gaps of mean and variance.
A kernel fault would move its gaps away from the other two routes' on
every order; float32's own edge moves all three together on one order.
The route switch lives here, never in the package.  Prints one JSON line a
(order, route) and a table.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from gpis_tpu_torch import ModelConfig  # noqa: E402
from gpis_tpu_torch.data import gpis  # noqa: E402
from gpis_tpu_torch.kernels import functions as kf  # noqa: E402
from gpis_tpu_torch.linalg import cuda_chol  # noqa: E402
from gpis_tpu_torch.linalg import outofcore as ooc  # noqa: E402

ORDERS = ("fibonacci", 1, 2, 3)  # phase 7's own order, then seeds of a row permutation


def h_float64_once(u, a, b, w: int):
    """U[:, :w] += A B[:, :w] computed in float64 and rounded once."""
    u[:, :w] = (u[:, :w].double() + a.double() @ b[:, :w].double()).to(u.dtype)
    return u


ROUTES = {"kernel": cuda_chol.gemm_nn_acc_masked,
          "twin": cuda_chol.gemm_nn_acc_masked_reference,
          "f64": h_float64_once}


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: this script needs a CUDA card", flush=True)
        return 1
    card = cs.card_line()
    print(card, flush=True)
    cfg = ModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3, n_external=127,
                      n_internal=1, block=128, touch_capacity=0)
    pts = gpis.fibonacci_sphere(cs.SPILL_N).astype(np.float32)
    ts = gpis.build_training_set(pts, cfg, device="cuda")
    params = kf.kernel_params(cfg.lengthscale, cfg.signal_variance)
    q = ts.frame.to_normalized(torch.as_tensor(cs.big_query(torch, pts), device="cuda"))
    table = []
    for order in ORDERS:
        if order == "fibonacci":
            perm = torch.arange(ts.x.shape[0], device="cuda")
        else:
            gen = torch.Generator(device="cuda").manual_seed(order)
            perm = torch.randperm(ts.x.shape[0], generator=gen, device="cuda")
        x, y, noise = ts.x[perm].contiguous(), ts.y[perm].contiguous(), ts.noise[perm]
        rmean, rvar = cs.plain_posterior64(torch, cfg.kernel, x, y, noise, params, q)
        torch.cuda.empty_cache()
        for route, fn in ROUTES.items():
            cuda_chol_h = cuda_chol.gemm_nn_acc_masked
            cuda_chol.gemm_nn_acc_masked = fn
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model = ooc.ooc_fit(cfg.kernel, x, y, noise, params, panel=cs.SPILL_PANEL,
                                    store="tiered", device_budget=cs.SPILL_BUDGET,
                                    pad_noise=cfg.pad_noise)
                torch.cuda.synchronize()
                fit_s = time.perf_counter() - t0
            finally:
                cuda_chol.gemm_nn_acc_masked = cuda_chol_h
            mean, var = (t.cpu().numpy() for t in ooc.ooc_predict(model, q))
            del model
            torch.cuda.empty_cache()
            row = {"order": order, "route": route, "fit_s": fit_s,
                   "gap_mean": float(np.abs(mean - rmean).max()),
                   "gap_var": float(np.abs(var - rvar).max()), "card": card}
            print(json.dumps(row), flush=True)
            table.append(row)
    print("order | route | gap_mean | gap_var | fit_s")
    for r in table:
        print(f"{r['order']} | {r['route']} | {r['gap_mean']:.3e} | {r['gap_var']:.3e} | "
              f"{r['fit_s']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
