"""Kernel D, the staged variance quad and mean (csrc/query.cu), and the
two-stage dense-grid query built on it (port of
gpis_tpu/kernels/pallas_query.py:250-401).

* `stage_kq` -- stage A: kq = K(Q, X) into device memory, through Kernel A
  in cross mode (replaces `_stage_kq`, pallas_query.py:294).
* `staged_quad(kq, w, alpha)` -- stage B, Kernel D (replaces
  `staged_query_from_kq`, pallas_query.py:319): mean = kq @ alpha and
  quad = colsum((W kq^T)^2); the caller takes var = k(0) - quad.
* `fused_query` -- stage A then stage B.

The port always stages kq.  The TPU's `_want_staged` crossover was derived
on the TPU and is not carried over; the on-the-fly kernel
(`fused_query_pallas`), which never writes kq, is the next query port.
Until then a query whose staging buffer would exceed `KQ_STAGE_MAX` bytes
raises rather than quietly taking the plain path: callers chunk their
queries (`surface.grid.evaluate_points_chunked` does).
"""

from __future__ import annotations

import torch

from gpis_tpu_torch import _build
from gpis_tpu_torch.kernels.gram import cross_cov

__all__ = ["KQ_STAGE_MAX", "stage_kq", "staged_quad", "staged_quad_reference", "fused_query"]

# Largest staged kq, in bytes: 4 x the 512 MiB of one 8,192-query chunk at
# C = 16,384 in float32, a quarter of the memory the one C x C W of a
# C ~ 65k model already needs.
KQ_STAGE_MAX = 2 << 30

_TILE = 64  # csrc/common.cuh TILE


# Stage A: kq = K(Q, X) (M, C), written once -- the cross-covariance itself.
stage_kq = cross_cov


def staged_quad_reference(kq: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor):
    """Plain twin of Kernel D: (kq @ alpha, colsum((W kq^T)^2))."""
    v = w @ kq.T
    return kq @ alpha, torch.sum(v * v, dim=0)


def staged_quad(kq: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor):
    """(mean (M,), quad (M,)) from a staged kq (M, C), W (C, C) LOWER
    triangular (the kernel skips its zero upper half) and alpha (C,)."""
    m, c = kq.shape
    if w.shape != (c, c) or alpha.shape != (c,):
        raise ValueError(f"staged_quad: kq {tuple(kq.shape)}, W {tuple(w.shape)}, "
                         f"alpha {tuple(alpha.shape)} do not agree")
    if kq.device.type == "cpu":
        return staged_quad_reference(kq, w, alpha)
    _build.check_cuda_args("staged_quad", kq, w, alpha)
    tiles = -(-c // _TILE)
    if tiles * -(-m // _TILE) > 2**31 - 1:
        raise ValueError(f"staged_quad: {m} queries x capacity {c} exceed one launch")
    partial = torch.empty((tiles, m), dtype=kq.dtype, device=kq.device)
    mean = torch.empty((m,), dtype=kq.dtype, device=kq.device)
    quad = torch.empty((m,), dtype=kq.dtype, device=kq.device)
    _build.call("gpis_staged_quad", kq, kq.data_ptr(), m, w.data_ptr(), alpha.data_ptr(), c,
                partial.data_ptr(), mean.data_ptr(), quad.data_ptr())
    _build.LAUNCHES["staged_quad"] += 1
    return mean, quad


def fused_query(name: str, q: torch.Tensor, x: torch.Tensor, params, alpha: torch.Tensor,
                w: torch.Tensor):
    """(mean, quad) at queries q (M,3) against training points x (C,3),
    W = L^{-1} (C,C) and alpha (C,): stage A, then stage B."""
    nbytes = q.shape[0] * x.shape[0] * q.element_size()
    if nbytes > KQ_STAGE_MAX:
        raise ValueError(
            f"fused_query: the staged kq would take {nbytes} bytes (> KQ_STAGE_MAX = "
            f"{KQ_STAGE_MAX}); query in chunks -- the on-the-fly kernel that never "
            "stages kq (fused_query_pallas) is the next query port"
        )
    kq = cross_cov(name, q, x, params)
    return staged_quad(kq, w, alpha)
