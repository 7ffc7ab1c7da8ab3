"""Gram and cross-covariance assembly (port of gpis_tpu/kernels/gram.py).

`gram` and `cross_cov` go through Kernel A (`cuda_gram.cov`): on a CUDA
tensor the kernel runs, on a CPU tensor its plain twin.  Unlike the JAX
package, nothing here catches a failed kernel and quietly takes the plain
form instead: a kernel error raises.  A registered kernel
(`functions.register_kernel`) has no CUDA body and takes the twin on any
device, as the JAX package keeps it off Pallas.

`gram_ad` is the Gram of the marginal likelihood: a `torch.autograd.Function`
whose primal is `gram` (Kernel A on a card) and whose pullback runs band by
band in plain PyTorch, as the JAX package's custom VJP runs outside any
Pallas kernel.
"""

from __future__ import annotations

import torch

from gpis_tpu_torch.kernels import cuda_gram
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.kernels.cuda_gram import pairwise_r2

__all__ = ["pairwise_r2", "gram", "gram_reference", "gram_ad", "cross_cov", "add_noise_diag"]


def _noise_vector(noise, n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(noise, dtype=like.dtype, device=like.device).broadcast_to((n,)).contiguous()


def gram(name: str, x: torch.Tensor, params, noise=None) -> torch.Tensor:
    """Symmetric Gram K(X,X) [+ diag(noise)]; noise is a scalar or (N,)."""
    if noise is not None:
        noise = _noise_vector(noise, x.shape[0], x)
    if name not in kf.KERNEL_NAMES:
        return cuda_gram.cov_reference(name, x, x, params, noise=noise, sym=True)
    return cuda_gram.cov(name, x, x, params, noise=noise, sym=True)


def _gram_band_rows(name: str, x_band, x, params, noise_band, row0: int) -> torch.Tensor:
    """Rows [row0, row0 + B) of `gram_reference`: k(r2) with the exact k(0)
    (plus noise_band, when given) where the global row meets its column.
    Differentiable in x and in the params (the jvp target of `gram_ad`'s
    pullback: (B, C, 3) temporaries instead of (C, C, 3))."""
    b, c = x_band.shape[0], x.shape[0]
    k = kf.k_r2(name, pairwise_r2(x_band, x), params)
    rows = row0 + torch.arange(b, device=x.device)[:, None]
    diag = torch.arange(c, device=x.device)[None, :] == rows
    k0 = torch.as_tensor(kf.k_diag0(name, params), dtype=k.dtype, device=k.device)
    k = torch.where(diag, k0, k)
    if noise_band is not None:
        k = torch.where(diag, k + noise_band[:, None], k)
    return k


def gram_reference(name: str, x: torch.Tensor, params, noise=None) -> torch.Tensor:
    """Plain-PyTorch Gram on any device (exact k(0) on the diagonal),
    differentiable in x, the params and the noise."""
    if noise is not None:
        noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device).broadcast_to(
            (x.shape[0],))
    return _gram_band_rows(name, x, x, params, noise, 0)


class _GramAD(torch.autograd.Function):
    """K(x) + diag(noise) with the band-by-band pullback of the JAX
    package's `_gram_ad_fn` (gpis_tpu/kernels/gram.py:85-140).  apply takes
    tensors only: the params come flattened by sorted key."""

    @staticmethod
    def forward(ctx, x, noise, name, band, keys, *values):
        ctx.name, ctx.band, ctx.keys = name, band, keys
        ctx.noise_is_scalar = noise.ndim == 0
        ctx.save_for_backward(x, noise, *values)
        return gram(name, x, {k: float(v) for k, v in zip(keys, values)}, noise)

    @staticmethod
    def backward(ctx, kbar):
        x, noise, *values = ctx.saved_tensors
        name, band, keys = ctx.name, ctx.band, ctx.keys
        c = x.shape[0]
        params = dict(zip(keys, values))
        noise_v = noise.broadcast_to((c,))
        want_x = ctx.needs_input_grad[0]
        want_p = [ctx.needs_input_grad[5 + i] for i in range(len(keys))]
        gx = torch.zeros_like(x) if want_x else None
        gp = [torch.zeros((), dtype=x.dtype, device=x.device) for _ in keys]
        for r0 in range(0, c, band):
            xb = x[r0:r0 + band]
            kb = kbar[r0:r0 + band]
            if want_x:
                # <dK, Kbar> over both triangles: dK_ij/dx_i = 2 dk/dr2 (x_i - x_j);
                # the pinned diagonal is x-independent and its diff is 0.
                sym = kb + kbar[:, r0:r0 + band].T
                d = xb[:, None, :] - x[None, :, :]
                dk = kf.dk_dr2(name, torch.sum(d * d, dim=-1), params)
                gx[r0:r0 + band] = torch.einsum("bc,bcd->bd", sym * dk * 2.0, d)
                del sym, d, dk
            nb = noise_v[r0:r0 + band]

            def band_of(*vals):
                return _gram_band_rows(name, xb, x, dict(zip(keys, vals)), nb, r0)

            # One jvp per parameter key: registered kernels need no hand
            # derivative, and no (C, C, 3) temporary is ever held.
            for i, key in enumerate(keys):
                if not want_p[i]:
                    continue
                tang = tuple(torch.ones_like(v) if k == key else torch.zeros_like(v)
                             for k, v in zip(keys, values))
                _, dkp = torch.func.jvp(band_of, tuple(values), tang)
                gp[i] = gp[i] + torch.sum(kb * dkp)
        g_noise = None
        if ctx.needs_input_grad[1]:
            g_noise = kbar.diagonal().clone()
            if ctx.noise_is_scalar:
                g_noise = g_noise.sum()
        return (gx, g_noise, None, None, None,
                *(g.to(v.dtype) if w else None for g, v, w in zip(gp, values, want_p)))


def gram_ad(name: str, x: torch.Tensor, params, noise, *, band: int = 1024) -> torch.Tensor:
    """Differentiable Gram with an O(band x C) pullback.  The primal is
    `gram` (Kernel A on a card); the pullback builds the x cotangent from
    dk/dr2 in closed form, each parameter's by a jvp of the band assembly,
    and the noise's as diag(Kbar) (summed for a scalar noise), a band of
    `band` rows at a time (all C rows when band does not tile C).  No
    (C, C, 3) temporary enters the graph: only x, the noise and the
    parameters are saved."""
    c = x.shape[0]
    b = band if c % band == 0 else c
    keys = tuple(sorted(params))
    values = [torch.as_tensor(params[k], dtype=x.dtype, device=x.device) for k in keys]
    noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device)
    return _GramAD.apply(x, noise, name, b, keys, *values)


def cross_cov(name: str, q: torch.Tensor, x: torch.Tensor, params) -> torch.Tensor:
    """Cross-covariance K(Q, X): q (M,3) queries against x (N,3)."""
    if name not in kf.KERNEL_NAMES:
        return cuda_gram.cov_reference(name, q, x, params)
    return cuda_gram.cov(name, q, x, params)


def add_noise_diag(k: torch.Tensor, noise) -> torch.Tensor:
    return k + torch.diag(_noise_vector(noise, k.shape[0], k))
