"""The headline benchmark (port of the root bench.py's in-core path): a GPIS
fit at N = 16,384 training points, then the posterior mean and variance on
a 64^3 grid, one JSON line.

    gpis-torch bench [n_surface] [--device cuda|cpu] [--save-grid PATH]
    python -m gpis_tpu_torch.cli.bench [n_surface] [--device cpu] [--save-grid PATH]

The workload is bench.py's: rbf, lengthscale 0.4, noise 1e-3, 127 external
points and 1 internal point around an `n_surface`-point Fibonacci sphere
(default 16,256, so C = 16,384), float32, padded to the 128 block with pad
noise 1e10.  An untimed warm-up round fits and queries once (its factor is
checked for NaN, and a NaN multiplies every noise below 1 by 10, up to four
attempts); then one timed fit and one timed query, each on the host clock
ending in a synchronize.

The fit keeps peak memory at one C x C matrix: the Gram with its noise
diagonal (Kernel A), factored in place (`linalg.cholesky.cholesky`: Kernel
B on the card), then `gp.regression.model_from_factor`, the step after the
factor of `fit_inference`: when C % 256 == 0, W = L^{-1} in place (Kernel
C) and alpha = W^T (W y); other capacities take cho_solve and `with_linv`.
The route is chosen by C alone, on any device, so a CPU run takes the
card's route.  The grid is queried in
32 chunks of 8,192 points through `gp.regression.predict` (Kernel A's
cross-covariance, then Kernel D).

stdout is one JSON line with bench.py's keys (metric, hbm_peak_gb, value,
unit, vs_baseline, fit_s, query_s, surface_rmse, n_train, n_query, ok) and
the provenance stamp; the recorded BENCH_*.json results are not attached.
`ok` needs a finite time, no NaN on the grid and a marching-tetrahedra
surface whose radius is within 0.02 (root mean square) of 1.  stderr
carries the log lines, the device's name and power limit, and the kernel
launches of the run (`_build.LAUNCHES`).  `--save-grid PATH` also writes
the timed round's mean and variance on the grid to PATH (.npz, float32,
64^3 each).  The exit code is 0 when `ok`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from gpis_tpu_torch import _build
from gpis_tpu_torch.cli import add_device_arg
from gpis_tpu_torch.config import ModelConfig
from gpis_tpu_torch.data import gpis
from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.gp.model import GPModel, round_up
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.kernels import gram as kg
from gpis_tpu_torch.linalg import cholesky as lin
from gpis_tpu_torch.surface import grid as grid_mod
from gpis_tpu_torch.surface import marching
from gpis_tpu_torch.utils.provenance import card_line, provenance

__all__ = ["CONFIG", "workload", "fit_model", "query", "rounds", "run", "main"]

# The float64 NumPy/SciPy oracle on a CPU at N = 10k: fit 85.6 s + 64^3
# query ~3,182 s (BASELINE.md row 5).  vs_baseline = this / value, at the
# larger N = 16,384: a lower bound on the per-work speedup.
ORACLE_CPU_10K_TOTAL_S = 3268.0

CONFIG = ModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3, n_external=127,
                     n_internal=1, block=128, touch_capacity=0)
N_SURFACE = 16256
RES = 64
EXTENT = 1.5
CHUNK = 8192
PAD_NOISE = 1e10
LADDER = 4  # warm-up attempts
RMSE_GATE = 0.02


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return "cpu"
    try:
        return card_line(dev)
    except (OSError, RuntimeError) as e:
        return f"{torch.cuda.get_device_name(dev)}, power limit not read ({e})"


def workload(n_surface: int, *, dtype=torch.float32, device="cuda"):
    """bench.py's training set on `device` in `dtype`, padded to the block
    multiple: (x, y, noise) of C rows, the kernel's params, and n (the
    real rows)."""
    pts = gpis.fibonacci_sphere(n_surface, radius=1.0).astype(np.float32)
    ts = gpis.build_training_set(pts, CONFIG, device=device)
    n = ts.x.shape[0]
    xp, yp, noisep = gpr.pad_training(ts.x, ts.y, ts.noise, round_up(n, CONFIG.block),
                                      PAD_NOISE, dtype)
    return xp, yp, noisep, kf.kernel_params(CONFIG.lengthscale, CONFIG.signal_variance), n


def fit_model(x, y, noise, params, *, check_nan: bool = False) -> GPModel | None:
    """Gram -> in-place factor -> (NaN check) -> `model_from_factor` (in-place
    W -> alpha), at a peak of one C x C matrix; None when check_nan finds a
    NaN factor."""
    l = lin.cholesky(kg.gram(CONFIG.kernel, x, params, noise=noise))
    if check_nan and bool(torch.isnan(l.diagonal()).any()):
        return None
    return gpr.model_from_factor(CONFIG.kernel, x, y, noise, params, l, n0=x.shape[0],
                                 pad_noise=PAD_NOISE)


def query(model: GPModel, coords: torch.Tensor, chunk: int = CHUNK):
    """Posterior (mean, variance) at coords, `chunk` points a predict,
    ending in a synchronize."""
    means, vars_ = [], []
    for q in coords.split(chunk):
        mean, var = gpr.predict(model, q)
        means.append(mean)
        vars_.append(var)
    _sync(coords.device)
    return torch.cat(means), torch.cat(vars_)


def rounds(x, y, noise, params, coords, chunk: int = CHUNK):
    """The untimed warm-up round with its noise ladder, then the timed
    round at the noise the ladder landed on.  Returns the timed round's
    (model, mean, var, fit seconds, query seconds)."""
    dev = x.device
    t0 = time.perf_counter()
    model = None
    for _ in range(LADDER):
        del model  # release before refitting: only one attempt fits in memory
        model = fit_model(x, y, noise, params, check_nan=True)
        if model is not None:
            break
        log("NaN factor; escalating noise x10")
        noise = torch.where(noise < 1.0, noise * 10.0, noise)
    if model is None:
        raise FloatingPointError(f"the factor was NaN in all {LADDER} warm-up attempts")
    _sync(dev)
    mean, var = query(model, coords, chunk)
    log(f"warm-up round: {time.perf_counter() - t0:.1f}s")
    del model, mean, var

    t0 = time.perf_counter()
    model = fit_model(x, y, noise, params)
    _sync(dev)
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    mean, var = query(model, coords, chunk)
    t_query = time.perf_counter() - t0
    return model, mean, var, t_fit, t_query


def run(n_surface: int = N_SURFACE, device="cuda", save_grid: str | None = None) -> dict:
    """The benchmark's result dict (the JSON line's keys); with `save_grid`,
    the timed round's grid is also written there."""
    dev = _build.resolve_device(device)
    log(f"device={dev} ({_card(dev)}) n_surface={n_surface} grid={RES}^3")
    x, y, noise, params, _ = workload(n_surface, device=dev)
    c = x.shape[0]
    log(f"capacity C={c}")
    coords, axis = grid_mod.make_grid(RES, EXTENT, dtype=torch.float32, device=dev)
    _, mean, var, t_fit, t_query = rounds(x, y, noise, params, coords)
    total = t_fit + t_query

    # The gate: the isosurface of the fitted sphere (host, untimed).
    field = mean.reshape(RES, RES, RES).cpu().numpy()
    if save_grid:
        np.savez(save_grid, mean=field, var=var.reshape(RES, RES, RES).cpu().numpy())
    verts, _ = marching.marching_tetrahedra(field, axis.cpu().numpy())
    r = np.linalg.norm(verts, axis=1)
    rmse = float(np.sqrt(np.mean((r - 1.0) ** 2))) if len(verts) else float("nan")
    nan_frac = float(np.isnan(field).mean())
    ok = bool(np.isfinite(total) and nan_frac == 0.0 and rmse < RMSE_GATE)
    hbm_peak = round(torch.cuda.max_memory_allocated(dev) / 1e9, 2) if dev.type == "cuda" else None
    log("launches " + json.dumps(dict(_build.LAUNCHES)))
    result = {
        "metric": f"gpis fit+64^3 grid query wall-clock, N={c} on one {dev.type} device "
                  "(speedup vs measured CPU oracle at N=10k)",
        "hbm_peak_gb": hbm_peak,
        "value": round(total, 3),
        "unit": "s",
        "vs_baseline": round(ORACLE_CPU_10K_TOTAL_S / total, 1) if ok else 0.0,
        "fit_s": round(t_fit, 3),
        "query_s": round(t_query, 3),
        "surface_rmse": round(rmse, 5),
        "n_train": int(c),
        "n_query": int(coords.shape[0]),
        "ok": ok,
    }
    result.update(provenance())
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gpis-torch bench", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n_surface", nargs="?", type=int, default=N_SURFACE)
    ap.add_argument("--save-grid", metavar="PATH",
                    help="also write the timed round's 64^3 mean and variance to PATH (.npz)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    result = run(args.n_surface, args.device, args.save_grid)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
