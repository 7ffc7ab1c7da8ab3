"""Kernel A, the covariance tile (csrc/cov.cu), and its plain PyTorch twin.

Replaces the Pallas calls `gram_pallas` (gpis_tpu/kernels/pallas_gram.py:197),
`cross_cov_pallas` (:109) and `_stage_kq` (gpis_tpu/kernels/pallas_query.py
:294), which share one body, and in band mode `gram_band_pallas`
(pallas_gram.py:173): the (R, C) row band of the Gram at global rows
[row0, row0 + R), the out-of-core factor's row band.  The kernel is
write-bound (one store per element): a CTA writes a tile of up to 64 rows
by 128 columns, each thread 4 columns of a row as one 16-byte store where
N % 4 == 0 (scalars otherwise), the covariance a template parameter and the
diagonal tested only in tiles it crosses; csrc/cov.cu says why, and why r2
is formed per dimension.

`cov(name, a, b, params, noise=..., sym=..., row0=...)` takes a CPU tensor to
the twin `cov_reference` and a CUDA tensor to the kernel; anything the
kernel does not take raises (a grid of more than 2^31 - 1 tiles is refused
by the launch itself).  There is no fallback from one to the other.
A launch counts as "gram_band" in band mode (row0 given), else as "cov".
"""

from __future__ import annotations

import torch

from gpis_tpu_torch import _build
from gpis_tpu_torch.kernels import functions as kf

__all__ = ["KERNEL_IDS", "pairwise_r2", "cov_reference", "cov"]

# csrc/common.cuh `KernelId`.
KERNEL_IDS = {"rbf": 0, "laplace": 1, "inverse_multiquadric": 2, "thin_plate": 3}


def pairwise_r2(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances, x (N,3), z (M,3) -> (N,M), per dimension
    (no |x|^2 - 2 x.z cancellation)."""
    d = x[:, None, :] - z[None, :, :]
    return torch.sum(d * d, dim=-1)


def cov_reference(name: str, a, b, params, *, noise=None, sym: bool = False, row0: int = 0):
    """Plain twin of the kernel: k(|a_i - b_j|^2); with sym, where
    row0 + i == j, the exact k(0) plus noise[i] (noise may be None)."""
    k = kf.k_r2(name, pairwise_r2(a, b), params)
    if sym:
        diag = torch.full((a.shape[0],), float(kf.k_diag0(name, params)),
                          dtype=k.dtype, device=k.device)
        if noise is not None:
            diag = diag + noise
        k[:, row0:row0 + a.shape[0]].diagonal().copy_(diag)
    return k


def cov(name: str, a: torch.Tensor, b: torch.Tensor, params, *, noise=None,
        sym: bool = False, row0: int | None = None) -> torch.Tensor:
    """K(a, b) (M, N).  sym=True is the Gram mode: b is a, diagonal k(0) +
    noise.  With row0, the band mode: a is rows [row0, row0 + M) of b, and
    k(0) + noise[i] lands at column row0 + i."""
    if a.ndim != 2 or a.shape[1] != 3 or b.ndim != 2 or b.shape[1] != 3:
        raise ValueError(f"cov: expected (M,3) and (N,3), got {tuple(a.shape)}, {tuple(b.shape)}")
    band = row0 is not None
    if band and (not sym or not 0 <= row0 <= b.shape[0] - a.shape[0]):
        raise ValueError(f"cov: a band of {a.shape[0]} rows at row0={row0} needs sym=True "
                         f"and must lie inside {b.shape[0]} rows")
    if sym and not band and a.shape[0] != b.shape[0]:
        raise ValueError("cov: sym=True needs a square Gram (a and b of one length)")
    if noise is not None and noise.shape != (a.shape[0],):
        raise ValueError(f"cov: noise must be ({a.shape[0]},), got {tuple(noise.shape)}")
    row0 = int(row0 or 0)
    if a.device.type == "cpu":
        return cov_reference(name, a, b, params, noise=noise, sym=sym, row0=row0)
    if name not in KERNEL_IDS:
        raise ValueError(f"cov: no CUDA kernel for covariance {name!r}")
    tensors = (a, b) if noise is None else (a, b, noise)
    _build.check_cuda_args("cov", *tensors)
    m, n = a.shape[0], b.shape[0]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    _build.call(
        "gpis_cov", a, a.data_ptr(), m, b.data_ptr(), n,
        None if noise is None else noise.data_ptr(), int(sym), row0, KERNEL_IDS[name],
        float(params["lengthscale"]), float(params["signal_variance"]), out.data_ptr(),
    )
    _build.LAUNCHES["gram_band" if band else "cov"] += 1
    return out

