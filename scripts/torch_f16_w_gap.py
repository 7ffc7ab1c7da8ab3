#!/usr/bin/env python3
"""How far a float16 W moves the out-of-core variance on `chip_smoke.py`
phase 7's problem, cut to a polar cap: the port against the JAX package.

    JAX_PLATFORMS=cpu python3 scripts/torch_f16_w_gap.py [--sizes 4096 8192] [--perturb 2]
    python3 scripts/torch_f16_w_gap.py --device cuda [--sizes 4096 8192 32768]

Phase 7's training set (32,640 Fibonacci points on the unit sphere, 127
external points, 1 internal; rbf at lengthscale 0.4, surface noise 1e-3)
is built once, in float32, and cut to its first C rows by polar angle: the
cap keeps the sphere's sampling density, lengthscale and noise, so the
system keeps phase 7's local conditioning at a size the CPU can factor
(C = 32,768 is the whole set).  On the cap, `ooc_factor_phase` then two
`ooc_solve_phase` runs, float32 W and `w_dtype=float16` (every W panel
narrowed, resident and spilled, as phase 16(d) runs it), and one query of
16,384 points spread over the cap's bounding box plus a margin.  Printed:
max |mean_f16 - mean_f32| and the max, 99th percentile and root mean
square of |var_f16 - var_f32| for the port and,
on the CPU, for the JAX package on the same arrays (float32, its own
phases), and the two packages' float16 variances against each other.  On
the card only the port runs.  One JSON line a size.  With `--perturb N`,
N more lines a size, the port alone on the cap with its coordinates
scaled by 1 + 1e-7 g (g standard normal, seed k for the k-th): how far
the gap moves when the float32 inputs move by their own rounding.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_SURFACE, N_EXTERNAL = 32640, 127  # phase 7's sphere: C = 32,768 in all
LS, NOISE = 0.4, 1e-3
N_QUERY = 16384


def phase7_set():
    """Phase 7's training set in its normalized frame, as float32 arrays."""
    import torch

    from gpis_tpu_torch import ModelConfig
    from gpis_tpu_torch.data import gpis

    cfg = ModelConfig(kernel="rbf", lengthscale=LS, noise_surface=NOISE,
                      n_external=N_EXTERNAL, n_internal=1, block=128, touch_capacity=0)
    pts = gpis.fibonacci_sphere(N_SURFACE).astype(np.float32)
    ts = gpis.build_training_set(pts, cfg, device="cpu")
    return (ts.x.numpy(), ts.y.numpy(), ts.noise.numpy(), cfg.pad_noise,
            torch.float32)


def cap(x, y, noise, c: int):
    """The first c rows of phase 7's set by polar angle (external points
    in the same cap, the internal point, then surface points), and queries
    over the cap's bounding box plus a 25 % margin."""
    n_s = N_SURFACE
    surf = np.arange(n_s)
    ext = n_s + 1 + np.arange(N_EXTERNAL)
    if c >= x.shape[0]:
        rows = np.arange(x.shape[0])
    else:
        z_cut = x[c - 1, 2]  # Fibonacci points descend in z
        ext_in = ext[x[ext, 2] / np.linalg.norm(x[ext], axis=1) >= z_cut]
        k_s = c - 1 - len(ext_in)
        rows = np.concatenate([surf[:k_s], [n_s], ext_in])
    xs, ys, ns = x[rows], y[rows], noise[rows]
    surf_x = xs[ys == 0] if (ys == 0).any() else xs
    lo, hi = surf_x.min(axis=0), surf_x.max(axis=0)
    pad = 0.25 * (hi - lo)
    q = np.random.default_rng(7).uniform(lo - pad, hi + pad, size=(N_QUERY, 3))
    return xs, ys, ns, q.astype(np.float32)


def port_pair(xs, ys, ns, q, pad_noise, panel, budget, device, root):
    import torch

    from gpis_tpu_torch.kernels import functions as kf
    from gpis_tpu_torch.linalg import outofcore as ooc

    dev = torch.device(device)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    params = kf.kernel_params(LS, 1.0)
    out = {}
    for w in ("float32", "float16"):
        sd = os.path.join(root, f"port_{w}")
        ooc.ooc_factor_phase("rbf", t(xs), t(ys), t(ns), params, panel=panel, spill_dir=sd,
                             device_budget=budget, pad_noise=pad_noise)
        m = ooc.ooc_solve_phase(sd, device_budget=budget, trsm_sweep=2, device=device,
                                w_dtype=torch.float16 if w == "float16" else None)
        out[w] = [v.cpu().numpy().astype(np.float64) for v in ooc.ooc_predict(m, t(q))]
        del m
    return out


def jax_pair(xs, ys, ns, q, pad_noise, panel, budget, root):
    import jax.numpy as jnp

    from gpis_tpu.kernels import functions as jkf
    from gpis_tpu.linalg import outofcore as jooc

    params = jkf.kernel_params(LS, 1.0)
    out = {}
    for w in ("float32", "float16"):
        sd = os.path.join(root, f"jax_{w}")
        jooc.ooc_factor_phase("rbf", jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(ns), params,
                              panel=panel, spill_dir=sd, device_budget=budget,
                              pad_noise=pad_noise)
        m = jooc.ooc_solve_phase(sd, device_budget=budget, trsm_sweep=2,
                                 w_dtype=jnp.float16 if w == "float16" else None)
        out[w] = [np.asarray(v, np.float64) for v in m.predict(jnp.asarray(q), chunk=4096)]
        del m
    return out


def gaps(pair):
    dv = np.abs(pair["float16"][1] - pair["float32"][1])
    return {"mean": float(np.abs(pair["float16"][0] - pair["float32"][0]).max()),
            "var": float(dv.max()), "var_p99": float(np.quantile(dv, 0.99)),
            "var_rms": float(np.sqrt(np.mean(dv**2)))}


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[4096, 8192])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--perturb", type=int, default=0)
    a = ap.parse_args()
    import torch

    torch.set_num_threads(a.threads)
    x, y, noise, pad_noise, _ = phase7_set()
    for c in a.sizes:
        xs, ys, ns, q = cap(x, y, noise, c)
        panel = c // 8  # phase 7's eight panels
        budget = 10 * panel * panel * 4 + panel * c * 4  # W panels 0-3 resident, as phase 7's
        for k in range(-1, a.perturb):
            row = {"C": c, "panel": panel, "device": a.device, "lengthscale": LS,
                   "noise": NOISE}
            xk = xs
            if k >= 0:
                g = np.random.default_rng(k).standard_normal(xs.shape)
                xk = (xs * (1 + 1e-7 * g)).astype(np.float32)
                row["perturb_seed"] = k
            with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as root:
                t0 = time.perf_counter()
                port = port_pair(xk, ys, ns, q, pad_noise, panel, budget, a.device, root)
                row["port"] = gaps(port)
                row["port_s"] = time.perf_counter() - t0
                if a.device == "cpu" and k < 0:
                    t0 = time.perf_counter()
                    jax = jax_pair(xs, ys, ns, q, pad_noise, panel, budget, root)
                    row["jax"] = gaps(jax)
                    row["jax_s"] = time.perf_counter() - t0
                    row["port_vs_jax_f16_var"] = float(
                        np.abs(port["float16"][1] - jax["float16"][1]).max())
                    row["port_vs_jax_f32_var"] = float(
                        np.abs(port["float32"][1] - jax["float32"][1]).max())
                elif a.device != "cpu":
                    row["card"] = card_line()
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
