"""Kernel E, the joint (value + gradient) covariance tile (csrc/joint.cu),
and the joint query (port of gpis_tpu/kernels/pallas_joint.py:67-402).

Every index of the joint system carries metadata -- coordinates p (3), a
gradient direction u (3, zero for a value) and a value flag f -- laid out
dimension-major as [f(1..C) | d1(1..C) | d2(1..C) | d3(1..C) | touch f(1..T)]
(`joint_meta`), J = 4C + T.  One blended formula gives the covariance of
any (row, column) pair:

    K[r, c] = f_r f_c k + 2 dk (u_r.diff f_c - u_c.diff f_r - u_r.u_c)
              - 4 d2k (u_r.diff)(u_c.diff),       diff = p_r - p_c

* `joint_rows(name, rmeta, cmeta, params, noise_col=None, row0=0)` -- Kernel
  E, replacing `joint_rows_pallas` (pallas_joint.py:215), beside its plain
  twin `joint_rows_reference` (`joint_rows_ref`, :106).  noise_col is added
  where the global row row0 + r equals the column; without it no noise is
  added anywhere.
* `joint_gram_fused` (the J x J Gram) and `joint_cross_value` (value-query
  rows against the joint columns) are its two callers.
* `fused_joint_query` -- the joint query: staged (Kernel E, then Kernel D)
  or on the fly (Kernel F's joint generator), routed as the value query is
  (`cuda_query.want_staged`).
"""

from __future__ import annotations

import torch

from gpis_tpu_torch import _build
from gpis_tpu_torch.kernels import cuda_query
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.kernels.cuda_gram import KERNEL_IDS

__all__ = ["joint_meta", "value_meta", "pack_meta", "joint_noise", "joint_rows_reference",
           "joint_rows", "joint_gram_fused", "joint_cross_value", "fused_joint_query"]

_MAX_BLOCKS = 2**31 - 1


def joint_meta(x: torch.Tensor, touch_x: torch.Tensor | None = None):
    """(coords (J, 3), dirs (J, 3), flag (J,)) of the dimension-major joint
    index space of x (C, 3) and the optional value-only touch slots."""
    c, dt, dev = x.shape[0], x.dtype, x.device
    eye = torch.eye(3, dtype=dt, device=dev)
    coords = [x, x, x, x]
    dirs = [torch.zeros((c, 3), dtype=dt, device=dev)] + [eye[d].expand(c, 3) for d in range(3)]
    flag = [torch.ones((c,), dtype=dt, device=dev), torch.zeros((3 * c,), dtype=dt, device=dev)]
    if touch_x is not None:
        t = touch_x.shape[0]
        coords.append(touch_x.to(dt))
        dirs.append(torch.zeros((t, 3), dtype=dt, device=dev))
        flag.append(torch.ones((t,), dtype=dt, device=dev))
    return torch.cat(coords), torch.cat(dirs), torch.cat(flag)


def value_meta(q: torch.Tensor):
    """Metadata of value-query rows: (q, zero directions, flag 1)."""
    m, dt, dev = q.shape[0], q.dtype, q.device
    return q, torch.zeros((m, 3), dtype=dt, device=dev), torch.ones((m,), dtype=dt, device=dev)


def pack_meta(meta) -> torch.Tensor:
    """(coords, dirs, flag) -> one contiguous (J, 7) array, the kernels' layout."""
    coords, dirs, flag = meta
    return torch.cat([coords, dirs, flag[:, None]], dim=1).contiguous()


def joint_noise(c: int, noise_f, noise_g, touch_noise, like: torch.Tensor) -> torch.Tensor:
    """The (J,) diagonal noise [noise_f | noise_g x 3 | touch_noise]."""
    def vec(v, n):
        return torch.as_tensor(v, dtype=like.dtype, device=like.device).broadcast_to((n,))

    parts = [vec(noise_f, c)] + [vec(noise_g, c)] * 3
    if touch_noise is not None:
        parts.append(vec(touch_noise, touch_noise.shape[0]))
    return torch.cat(parts)


def _joint_tile(d0, d1, d2, ud, vd, uv, fr, fc, name, params):
    """The blended joint covariance (pallas_joint._joint_tile)."""
    r2 = d0 * d0 + d1 * d1 + d2 * d2
    zero = r2 <= 1e-24
    # Exact k(0) where points coincide; d2k (singular at r = 0 for the thin
    # plate) multiplies diff factors that vanish there: mask the product.
    k = torch.where(zero, torch.as_tensor(kf.k_diag0(name, params), dtype=r2.dtype,
                                          device=r2.device), kf.k_r2(name, r2, params))
    dk = kf.dk_dr2(name, r2, params)
    outer = torch.where(zero, torch.zeros_like(r2), kf.d2k_dr2(name, r2, params) * ud * vd)
    return fr * fc * k + 2.0 * dk * (ud * fc - vd * fr - uv) - 4.0 * outer


def _check_derivs(what: str, name: str) -> None:
    if not kf.supports_derivatives(name):
        raise ValueError(f"{what}: kernel {name!r} does not support derivative observations")


def joint_rows_reference(name: str, rmeta, cmeta, params, noise_col=None, row0: int = 0):
    """Plain twin of Kernel E: materializes an (R, S, 3) difference tensor."""
    _check_derivs("joint_rows", name)
    rc, rd, rf = rmeta
    cc, cd, cf = cmeta
    diff = rc[:, None, :] - cc[None, :, :]
    ud = torch.einsum("rd,rsd->rs", rd, diff)
    vd = torch.einsum("sd,rsd->rs", cd, diff)
    out = _joint_tile(diff[..., 0], diff[..., 1], diff[..., 2], ud, vd, rd @ cd.T,
                      rf[:, None], cf[None, :], name, params)
    if noise_col is not None:
        r, s = out.shape
        rows = row0 + torch.arange(r, device=out.device)[:, None]
        cols = torch.arange(s, device=out.device)[None, :]
        out = torch.where(rows == cols, out + noise_col[None, :], out)
    return out


def joint_rows(name: str, rmeta, cmeta, params, noise_col=None, row0: int = 0) -> torch.Tensor:
    """K[rows, cols] (R, S) of the joint operator for any row and column
    metadata; noise_col (S,) lands where row0 + r == c."""
    r, s = rmeta[0].shape[0], cmeta[0].shape[0]
    if noise_col is not None and noise_col.shape != (s,):
        raise ValueError(f"joint_rows: noise_col must be ({s},), got {tuple(noise_col.shape)}")
    if rmeta[0].device.type == "cpu":
        return joint_rows_reference(name, rmeta, cmeta, params, noise_col, row0)
    _check_derivs("joint_rows", name)
    rm, cm = pack_meta(rmeta), pack_meta(cmeta)
    tensors = (rm, cm) if noise_col is None else (rm, cm, noise_col.contiguous())
    _build.check_cuda_args("joint_rows", *tensors)
    if -(-r // 256) * -(-s // 128) > _MAX_BLOCKS:  # joint.cu's 256 x 128 tiles
        raise ValueError(f"joint_rows: {r} x {s} exceeds one launch")
    out = torch.empty((r, s), dtype=rm.dtype, device=rm.device)
    _build.call("gpis_joint_cov", rm, rm.data_ptr(), r, cm.data_ptr(), s,
                None if noise_col is None else tensors[2].data_ptr(), int(row0),
                KERNEL_IDS[name], float(params["lengthscale"]), float(params["signal_variance"]),
                out.data_ptr())
    _build.LAUNCHES["joint_cov"] += 1
    return out


def joint_gram_fused(name: str, x: torch.Tensor, params, noise_f, noise_g, touch_x=None,
                     touch_noise=None) -> torch.Tensor:
    """The full (J, J) joint Gram with its noise diagonal, one launch."""
    meta = joint_meta(x, touch_x)
    if touch_x is not None and touch_noise is None:
        touch_noise = torch.zeros((touch_x.shape[0],), dtype=x.dtype, device=x.device)
    noise = joint_noise(x.shape[0], noise_f, noise_g, touch_noise, x)
    return joint_rows(name, meta, meta, params, noise_col=noise)


def joint_cross_value(name: str, q: torch.Tensor, x: torch.Tensor, params,
                      touch_x=None) -> torch.Tensor:
    """cov(f(q), joint observations): (M, J), value-query rows, no noise."""
    return joint_rows(name, value_meta(q), joint_meta(x, touch_x), params)


def fused_joint_query(name: str, q: torch.Tensor, x: torch.Tensor, params, alpha: torch.Tensor,
                      w: torch.Tensor, touch_x=None, staged: bool | None = None):
    """(mean, quad) of f at queries q (M, 3) for a joint model: W = joint
    L^{-1} (J, J), alpha (J,).  Staged: Kernel E writes kq, Kernel D reads
    it.  On the fly: Kernel F's joint generator.  staged=None routes by the
    staged kq's size, as `cuda_query.fused_query` does."""
    meta = joint_meta(x, touch_x)
    if meta[0].shape[0] != w.shape[0]:
        raise ValueError(f"fused_joint_query: joint size {meta[0].shape[0]} does not match "
                         f"W {tuple(w.shape)}")
    if cuda_query.want_staged(q.shape[0], w.shape[0], q.element_size(), staged):
        kq = joint_rows(name, value_meta(q), meta, params)
        return cuda_query.staged_quad(kq, w, alpha)
    return cuda_query.fused_quad("joint", name, q.contiguous(), pack_meta(meta), params, alpha, w)
