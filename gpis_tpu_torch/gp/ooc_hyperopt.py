"""Full-data hyperparameter optimization of OUT-OF-CORE fits, config 3
beyond one matrix on the card (port of gpis_tpu/gp/ooc_hyperopt.py).

One objective evaluation is one out-of-core factor and TRSM at theta
(`linalg.outofcore`: Kernels A band or E, G, I, B, H), and the exact
gradient identity

    d MLL / d theta = 1/2 (alpha^T dK alpha - tr(K^{-1} dK)),  K^{-1} = W^T W,

assembled from pieces that fall out of that pipeline:

* the MLL: u = L^{-1} y and sum(log diag L), captured while the factor's
  bands are on the card (`ooc_cholesky(stats=...)`); y.alpha = ||u||^2;
* the lengthscale: the trace tr(W dK W^T) and the quad alpha^T dK alpha,
  one (q, sweep) band at a time while each sweep's W rows are on the card
  (`ooc_trsm(on_panel=...)`: no second W stream); dK's row band q is a
  `torch.func.jvp` of the band assembly (`kernels.gram._gram_band_rows`, or
  the joint twin `cuda_joint.joint_rows_reference`), its products plain
  `torch.matmul` (the JAX package leaves them to XLA);
* the noise scale: dK is diagonal, tr = diag(K^{-1}).dn with
  diag(K^{-1})_i = ||W[:, i]||^2, column norms summed on the same pass;
* the signal variance, free: dK/d(log sv) = K - D for every built-in
  kernel (linear in sv): alpha^T (K - D) alpha = y.alpha - sum(alpha^2 n)
  and tr(K^{-1} (K - D)) = C - diag(K^{-1}).n.

`ooc_mll_and_grad_solve_phase` is the same objective split at the factor:
it reattaches the L store of an `ooc_factor_phase(defer_alpha=True)` and
rides the column norms and the trace on its TRSM; alpha is summed on the
same pass, so the quad takes one W-free band sweep after it
(`_band_quad_only`).  `optimize_ooc` / `optimize_ooc_joint` run the shared
Adam ascent (`sharded_hyperopt._mll_ascent`).
"""

from __future__ import annotations

import math
import os

import torch

from gpis_tpu_torch._build import resolve_device
from gpis_tpu_torch.kernels import cuda_joint
from gpis_tpu_torch.kernels import gram as kg
from gpis_tpu_torch.linalg import outofcore as ooc

__all__ = ["ooc_mll_and_grad", "optimize_ooc", "ooc_mll_and_grad_solve_phase",
           "ooc_joint_mll_and_grad", "optimize_ooc_joint"]

# Columns of the joint dK band formed at once: its jvp holds (panel, this, 3)
# temporaries, not (panel, J, 3).
_JOINT_COL_CHUNK = 4096


def _ls_tangent(band_fn, log_ls: torch.Tensor) -> torch.Tensor:
    """dK band / d(log lengthscale) by one forward-mode jvp."""
    return torch.func.jvp(band_fn, (log_ls,), (torch.ones_like(log_ls),))[1]


def _value_band_tangent(name, cols, log_ls, sv, q0: int, rows: int) -> torch.Tensor:
    """Rows [q0, q0 + rows) of dK / d(log ls) for value columns (C, 3); the
    noise diagonal is theta-independent and the pinned k(0) = sv has zero
    tangent."""
    xq = cols[q0:q0 + rows]

    def band(lls):
        return kg._gram_band_rows(name, xq, cols, {"lengthscale": torch.exp(lls),
                                                   "signal_variance": sv}, None, q0)

    return _ls_tangent(band, log_ls)


def _joint_band_tangent(name, meta, log_ls, sv, q0: int, rows: int, s0: int,
                        width: int) -> torch.Tensor:
    """Block [q0, q0 + rows) x [s0, s0 + width) of dK / d(log ls) for packed
    joint metadata (J, 7): the blended joint twin, whose gradient-block
    diagonals do depend on the lengthscale."""
    rmeta = ooc._meta_triple(meta[q0:q0 + rows])
    cmeta = ooc._meta_triple(meta[s0:s0 + width])

    def band(lls):
        return cuda_joint.joint_rows_reference(name, rmeta, cmeta, {
            "lengthscale": torch.exp(lls), "signal_variance": sv})

    return _ls_tangent(band, log_ls)


class _GradPass:
    """The lengthscale trace and quad and the column norms of W, summed
    sweep by sweep on `ooc_trsm`'s on_panel hook."""

    def __init__(self, name, cols, params, alpha, panel: int):
        dt, dev = cols.dtype, cols.device
        self.name, self.cols, self.alpha, self.panel = name, cols, alpha, panel
        self.log_ls = torch.log(torch.as_tensor(params["lengthscale"], dtype=dt, device=dev))
        self.sv = torch.as_tensor(params["signal_variance"], dtype=dt, device=dev)
        self.colnorms = torch.zeros_like(alpha)
        self.tr = torch.zeros((), dtype=dt, device=dev)
        self.quad = torch.zeros((), dtype=dt, device=dev)

    def _band(self, q0: int):
        """(q-band of dK) @ alpha and a function w -> dK_q w^T (the band's
        products, by column chunks for the joint layout)."""
        b, j = self.panel, self.cols.shape[0]
        if self.cols.shape[1] != 7:
            kdot = _value_band_tangent(self.name, self.cols, self.log_ls, self.sv, q0, b)
            return kdot @ self.alpha, lambda w: kdot @ w.T
        chunks = [(s0, min(_JOINT_COL_CHUNK, j - s0)) for s0 in range(0, j, _JOINT_COL_CHUNK)]
        kd = [_joint_band_tangent(self.name, self.cols, self.log_ls, self.sv, q0, b, s0, wd)
              for s0, wd in chunks]
        ka = sum(k @ self.alpha[s0:s0 + wd] for k, (s0, wd) in zip(kd, chunks))
        return ka, lambda w: sum(k @ w[:, s0:s0 + wd].T for k, (s0, wd) in zip(kd, chunks))

    def __call__(self, j0: int, w: torch.Tensor) -> None:
        """W rows [j0, j0 + R) (R, C), zero past column j0 + R: only the dK
        bands q < (j0 + R) / panel meet them.  Each band's quad share is
        taken once, at the sweep that holds its rows."""
        b = self.panel
        self.colnorms += torch.sum(w * w, dim=0)
        for q in range((j0 + w.shape[0]) // b):
            q0 = q * b
            ka, times = self._band(q0)
            self.tr += torch.sum(times(w).T * w[:, q0:q0 + b])
            if q0 >= j0:
                self.quad += self.alpha[q0:q0 + b] @ ka


def _objective(kernel, cols, y, noise_eff, dn, params, *, panel, block, store, budget, jitter,
               pad_rows, sweep, trsm_sweep, width_quant, max_jitter_retries):
    """The MLL and its (log ls, log noise scale, log sv) gradient of the
    system K(cols) + diag(noise_eff), dn = d noise / d(log noise scale),
    pad_rows the mask of rows whose 0.5 log(2 pi noise) constant comes out."""
    st, u, logdet, extra = ooc._factor_with_jitter(
        kernel, cols, noise_eff, params, budget, panel=panel, block=block, store=store, y=y,
        jitter=jitter, width_quant=width_quant, sweep=sweep,
        max_jitter_retries=max_jitter_retries)
    n_tot = noise_eff + extra  # the diagonal the factor represents
    alpha = ooc.ooc_alpha_backward(st, u, panel=panel)
    grad = _GradPass(kernel, cols, params, alpha, panel)
    wstore = ooc._make_store(store, budget, cols.device)
    try:
        ooc.ooc_trsm(st, wstore, y, panel=panel, block=block, accumulate_alpha=False,
                     width_quant=width_quant, sweep=ooc._trsm_sweep(sweep, trsm_sweep),
                     on_panel=grad, store_final=False)
    finally:
        wstore.clear()
        st.clear()
    j = y.shape[0]
    ya = y @ alpha
    mll = (-0.5 * ya - logdet - 0.5 * j * math.log(2.0 * math.pi)
           + torch.sum(torch.where(pad_rows, 0.5 * torch.log(2.0 * math.pi * n_tot), 0.0)))
    a2 = alpha * alpha
    g_ns = 0.5 * (a2 @ dn - grad.colnorms @ dn)
    g_sv = 0.5 * ((ya - a2 @ n_tot) - (j - grad.colnorms @ n_tot))
    g_ls = 0.5 * (grad.quad - grad.tr)
    return mll, {"log_ls": g_ls, "log_noise_scale": g_ns, "log_sv": g_sv}


def ooc_mll_and_grad(kernel, x, y, noise, params, *, panel: int, block: int = 256,
                     noise_scale=1.0, pad_noise: float = 1e10, store: str = "tiered",
                     sweep: int = 2, trsm_sweep: int | None = None, width_quant: int = 2,
                     device_budget: int | None = None,
                     max_jitter_retries: int = ooc.MAX_JITTER_RETRIES, dtype=None):
    """Exact MLL and gradients w.r.t. (log lengthscale, log noise scale, log
    signal variance) of the out-of-core system K(x) + diag(noise * scale on
    the real rows), from the RAW (unpadded) problem, padded as `ooc_fit`
    pads it (in `dtype`, with its sweep and width knobs): one factor with
    its jitter ladder, alpha, and one TRSM with the gradient pass on its
    sweeps.  The stores are cleared before returning.
    Returns (mll, {"log_ls", "log_noise_scale", "log_sv"}), 0-d tensors."""
    xp, yp, np_, params, c, n, jitter = ooc._pad_problem(kernel, x, y, noise, params,
                                                         panel=panel, pad_noise=pad_noise,
                                                         dtype=dtype)
    real = torch.arange(c, device=xp.device) < n
    scale = torch.as_tensor(noise_scale, dtype=xp.dtype, device=xp.device)
    noise_eff = torch.where(real, np_ * scale, np_)
    tsw = ooc._trsm_sweep(sweep, trsm_sweep)
    budget = ooc._fit_budget(device_budget, panel, c, xp, max(sweep, tsw + 1))
    return _objective(kernel, xp, yp, noise_eff, real * np_ * scale, params, panel=panel,
                      block=block, store=store, budget=budget, jitter=jitter, pad_rows=~real,
                      sweep=sweep, trsm_sweep=trsm_sweep, width_quant=width_quant,
                      max_jitter_retries=max_jitter_retries)


def ooc_joint_mll_and_grad(kernel, x, y, normals, noise_f, noise_g, params, *, panel: int,
                           block: int = 256, noise_scale=1.0, pad_noise: float = 1e10,
                           store: str = "tiered", sweep: int = 2, trsm_sweep: int | None = None,
                           width_quant: int = 2, device_budget: int | None = None,
                           max_jitter_retries: int = ooc.MAX_JITTER_RETRIES, dtype=None):
    """The same for the JOINT (value + gradient) system, J = 4C rows in the
    dimension-major layout [f | d1 | d2 | d3]: the noise scale multiplies
    the value noise of the real rows only (the gradient family stays fixed),
    and the dK bands are the joint twin's."""
    (xp, yj, meta, _nrm, nf, ng, params, c, n,
     jitter) = ooc._pad_joint_problem(kernel, x, y, normals, noise_f, noise_g, params,
                                      panel=panel, pad_noise=pad_noise, dtype=dtype)
    j_tot = 4 * c
    real = torch.arange(c, device=xp.device) < n
    scale = torch.as_tensor(noise_scale, dtype=xp.dtype, device=xp.device)
    noisej = cuda_joint.joint_noise(c, torch.where(real, nf * scale, nf), ng, None, xp)
    dn = torch.cat([real * nf * scale, torch.zeros((3 * c,), dtype=xp.dtype, device=xp.device)])
    tsw = ooc._trsm_sweep(sweep, trsm_sweep)
    budget = ooc._fit_budget(device_budget, panel, j_tot, xp, max(sweep, tsw + 1))
    return _objective(kernel, meta, yj, noisej, dn, params, panel=panel, block=block,
                      store=store, budget=budget, jitter=jitter, pad_rows=~real.repeat(4),
                      sweep=sweep, trsm_sweep=trsm_sweep, width_quant=width_quant,
                      max_jitter_retries=max_jitter_retries)


def _band_quad_only(name, cols, log_ls, sv, alpha, q0: int, rows: int) -> torch.Tensor:
    """alpha_q . (dK_q alpha) of one value column band q: the W-free half
    of the lengthscale gradient, run after a TRSM whose alpha was summed on
    the same pass (and so was not known while the W bands were on the
    card)."""
    kdot = _value_band_tangent(name, cols, log_ls, sv, q0, rows)
    return alpha[q0:q0 + rows] @ (kdot @ alpha)


def ooc_mll_and_grad_solve_phase(spill_dir: str, *, noise_base, noise_scale=1.0,
                                 trsm_sweep: int = 1, device_budget: int | None = None,
                                 w_dtype=None, device="cuda"):
    """The second phase of a split stream-objective step: reattach the L
    store that `ooc_factor_phase(..., defer_alpha=True)` persisted under
    `spill_dir` and give the exact (mll, grads) of `ooc_mll_and_grad`, in
    whatever process the caller runs it.  The column norms and the
    lengthscale trace ride the TRSM (`ooc_trsm(on_panel=...)`), alpha is
    summed on the same pass, and the quad takes one W-free band sweep
    after it.  `noise_base` is the raw (unpadded, unscaled, jitter-free)
    noise of the problem, for d noise / d(log scale): the state keeps only
    the effective diagonal.  The stores are cleared before returning.
    Returns (mll, {"log_ls", "log_noise_scale", "log_sv"})."""
    dev = resolve_device(device)
    d = ooc._load_state(spill_dir)
    if "logdiag_sum" not in d:
        raise ValueError("the factor phase predates the log-diagonal sum; run it again")
    kernel, panel, block = str(d["kernel"]), int(d["panel"]), int(d["block"])
    n = int(d["n_real"])
    xp, yp = (torch.as_tensor(d[k], device=dev) for k in ("x", "y"))
    n_tot = torch.as_tensor(d["noise"], device=dev)  # scaled noise + the fit's jitter
    logdet = float(d["logdiag_sum"])
    params = {k[len("param_"):]: float(d[k]) for k in d if k.startswith("param_")}
    dt = xp.dtype
    c = xp.shape[0]
    budget = ooc._fit_budget(device_budget, panel, c, xp, trsm_sweep + 1)
    lst = ooc.TieredPanelStore.open_dir(budget, os.path.join(spill_dir, "L"), device=dev)
    wstore = ooc._make_store("tiered", budget, dev, spill_dtype=w_dtype, device_dtype=w_dtype)
    # The pass's quad term needs alpha, which this TRSM is still summing: a
    # zero alpha leaves it out, and `_band_quad_only` takes it after.
    grad = _GradPass(kernel, xp, params, torch.zeros((c,), dtype=dt, device=dev), panel)
    try:
        alpha = ooc.ooc_trsm(lst, wstore, yp, panel=panel, block=block, accumulate_alpha=True,
                             width_quant=int(d["width_quant"]), sweep=trsm_sweep,
                             on_panel=grad, store_final=True)
        quad_ls = sum(_band_quad_only(kernel, xp, grad.log_ls, grad.sv, alpha, q * panel, panel)
                      for q in range(c // panel))
    finally:
        wstore.clear()
        lst.clear()
    real = torch.arange(c, device=dev) < n
    ya = yp @ alpha
    mll = (-0.5 * ya - logdet - 0.5 * c * math.log(2.0 * math.pi)
           + torch.sum(torch.where(real, 0.0, 0.5 * torch.log(2.0 * math.pi * n_tot))))
    scale = torch.as_tensor(noise_scale, dtype=dt, device=dev)
    nb_pad = torch.zeros((c,), dtype=dt, device=dev)
    nb_pad[:n] = torch.as_tensor(noise_base, dtype=dt, device=dev)[:n]
    dn = real * nb_pad * scale
    a2 = alpha * alpha
    g_ns = 0.5 * (a2 @ dn - grad.colnorms @ dn)
    g_sv = 0.5 * ((ya - a2 @ n_tot) - (c - grad.colnorms @ n_tot))
    g_ls = 0.5 * (quad_ls - grad.tr)
    return mll, {"log_ls": g_ls, "log_noise_scale": g_ns, "log_sv": g_sv}


def optimize_ooc(kernel, x, y, noise, init_params, *, panel: int, block: int = 256,
                 steps: int = 25, learning_rate: float = 0.1, learn_noise: bool = True,
                 learn_signal: bool = False, **ooc_kw):
    """Full-data MLL ascent on the out-of-core system, one factor + TRSM +
    gradient pass a step.  Returns a dict: params (the best), noise_scale,
    mll, history."""
    from gpis_tpu_torch.gp.sharded_hyperopt import _mll_ascent

    def eval_fn(prm, scale):
        return ooc_mll_and_grad(kernel, x, y, noise, prm, panel=panel, block=block,
                                noise_scale=scale, **ooc_kw)

    return _mll_ascent(eval_fn, kernel, init_params, torch.as_tensor(x).dtype, steps=steps,
                       learning_rate=learning_rate, learn_noise=learn_noise,
                       learn_signal=learn_signal)


def optimize_ooc_joint(kernel, x, y, normals, noise_f, noise_g, init_params, *, panel: int,
                       block: int = 256, steps: int = 25, learning_rate: float = 0.1,
                       learn_noise: bool = True, learn_signal: bool = False, **ooc_kw):
    """Full-data joint MLL ascent out of core (config 3 on config 2)."""
    from gpis_tpu_torch.gp.sharded_hyperopt import _mll_ascent

    def eval_fn(prm, scale):
        return ooc_joint_mll_and_grad(kernel, x, y, normals, noise_f, noise_g, prm, panel=panel,
                                      block=block, noise_scale=scale, **ooc_kw)

    return _mll_ascent(eval_fn, kernel, init_params, torch.as_tensor(x).dtype, steps=steps,
                       learning_rate=learning_rate, learn_noise=learn_noise,
                       learn_signal=learn_signal)
