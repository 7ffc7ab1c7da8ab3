"""GPModel: the exact-GP state (port of gpis_tpu/gp/model.py).

All arrays share a capacity C.  Rows [0, n0) hold the initial training set;
rows past the data are padding at the origin with target 0 and observation
noise `pad_noise` (~1e10), whose effect on the posterior is O(k^2 /
pad_noise) -- the padded model is numerically the unpadded one.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["GPModel", "round_up", "align_capacity"]


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def align_capacity(total: int, *, align: int = 1024, floor: int = 4096) -> int:
    """Round a capacity of at least `floor` up to a multiple of `align`
    (the JAX package's rule, kept so both packages pad a cloud to the same
    capacity); smaller capacities keep their exact padding."""
    if total < floor:
        return total
    return round_up(total, align)


@dataclasses.dataclass(frozen=True)
class GPModel:
    """Exact-GP state on one device.  `params` holds Python floats."""

    x: torch.Tensor  # (C, 3) training positions (normalized frame)
    y: torch.Tensor  # (C,) GPIS targets
    noise: torch.Tensor  # (C,) per-point observation variance
    params: dict  # {"lengthscale", "signal_variance"}
    chol: torch.Tensor  # (C, C) lower factor of K + diag(noise); W for fit_inference
    alpha: torch.Tensor  # (C,) (K + diag(noise))^{-1} y
    n_touch: int
    kernel: str
    n0: int  # initial-point boundary
    pad_noise: float = 1e10
    # Optional (K + diag(noise))^{-1}: the two-GEMM variance path.
    kinv: torch.Tensor | None = None
    # Optional W = L^{-1}: the dense-grid variance path (preferred).
    linv: torch.Tensor | None = None

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.x.dtype

    @property
    def device(self) -> torch.device:
        return self.x.device
