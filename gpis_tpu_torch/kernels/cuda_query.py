"""The dense-grid query kernels and the query built on them (port of
gpis_tpu/kernels/pallas_query.py:250-437).

* `stage_kq` -- stage A: kq = K(Q, X) into device memory, through Kernel A
  in cross mode (replaces `_stage_kq`, pallas_query.py:294).
* `staged_quad(kq, w, alpha)` -- stage B, Kernel D (csrc/query.cu; replaces
  `staged_query_from_kq`, pallas_query.py:319): mean = kq @ alpha and
  quad = colsum((W kq^T)^2); the caller takes var = k(0) - quad.
* `fused_quad(gen, name, q, cols, params, alpha, w)` -- Kernel F
  (csrc/fused_query.cu): the same (mean, quad) with each kq tile generated
  on chip from coordinates, so kq never reaches device memory.  Its value
  generator replaces `fused_query_pallas` (pallas_query.py:404); its joint
  generator, `fused_joint_query_pallas` (pallas_joint.py:367).
* `quad_band(gen, name, q, cols, params, w_band, row0)` -- Kernel F in band
  mode: colsum((W_band kq^T)^2) for a row band of W at global rows
  [row0, row0 + R), no mean.  Its value generator replaces
  `fused_quad_band_pallas` (pallas_query.py:241); its joint generator,
  `fused_joint_quad_band_pallas` (pallas_joint.py:500).  The out-of-core
  query (`linalg.outofcore.ooc_predict`) adds it up panel by panel.
* `fused_query` -- the value query: staged (A then D) or on the fly (F).
* `exact_fp32` -- a block whose plain PyTorch products run in full FP32
  (TF32 off): the `precision=` route of the predict functions, which takes
  the plain twins in place of the split-TF32 tile.

D and F are the split-TF32 tensor-core tile (csrc/tc_nn.cuh, NT layout,
QUAD epilogue; F with kq generated into the tile's shared memory), float32
only: the plan (`cuda_chol._tc_plan`, upper "rows", never split) runs each
128-row tile of W over k up to its last global row, and TMA reads W (and
D's kq), so each such view must start on 16 bytes with rows a multiple of
4 floats (`cuda_chol._check_tma`: a view that is not raises).  A CPU query
takes their plain twins (`_build.takes_kernel`); a float64 one on the card
raises.

Routing.  A query takes the staged route unless its staged kq would exceed
`KQ_STAGE_MAX` bytes; then it takes Kernel F, which needs O(M) memory.
That is the second clause of the JAX package's `_want_staged`.  Its first
clause priced kq regeneration against the TPU's matrix unit and is not
carried over: on the H100 staging costs a fraction of a millisecond next to
the quad kernel, so the staged route is kept wherever it fits (PERF.md
records both routes' times at one shape).
"""

from __future__ import annotations

import contextlib

import torch

from gpis_tpu_torch import _build
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.kernels.cuda_gram import KERNEL_IDS, pairwise_r2
from gpis_tpu_torch.kernels.gram import cross_cov
from gpis_tpu_torch.linalg import cuda_chol

__all__ = ["KQ_STAGE_MAX", "stage_kq", "staged_quad", "staged_quad_reference", "generated_kq",
           "fused_quad", "fused_quad_reference", "quad_band", "quad_band_reference",
           "want_staged", "fused_query", "exact_fp32"]

# Largest staged kq, in bytes: 4 x the 512 MiB of one 8,192-query chunk at
# C = 16,384 in float32, a quarter of the memory the one C x C W of a
# C ~ 65k model already needs.
KQ_STAGE_MAX = 2 << 30

_MAX_BLOCKS = 2**31 - 1
# Column metadata width of each Kernel F generator (csrc/fused_query.cu).
_GEN_STRIDE = {"value": 3, "joint": 7}


# Stage A: kq = K(Q, X) (M, C), written once -- the cross-covariance itself.
stage_kq = cross_cov


@contextlib.contextmanager
def exact_fp32():
    """Inside the block, float32 matrix products on the card are exact FP32
    (torch.backends.cuda.matmul.allow_tf32 off); the flag is restored
    after.  The package turns TF32 off at import, so this matters only to a
    caller who turned it back on since."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def staged_quad_reference(kq: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor):
    """Plain twin of Kernel D: (kq @ alpha, colsum((W kq^T)^2))."""
    v = w @ kq.T
    return kq @ alpha, torch.sum(v * v, dim=0)


def _check_launch(what: str, m: int, c: int) -> int:
    """W's row tiles of the tensor-core tile (the partials' rows)."""
    tiles = -(-c // cuda_chol.TC_TILE)
    if tiles * -(-m // cuda_chol.TC_TILE) > _MAX_BLOCKS:
        raise ValueError(f"{what}: {m} queries x capacity {c} exceed one launch")
    return tiles


def staged_quad(kq: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor):
    """(mean (M,), quad (M,)) from a staged kq (M, C), W (C, C) LOWER
    triangular (the kernel skips its zero upper half) and alpha (C,)."""
    m, c = kq.shape
    if w.shape != (c, c) or alpha.shape != (c,):
        raise ValueError(f"staged_quad: kq {tuple(kq.shape)}, W {tuple(w.shape)}, "
                         f"alpha {tuple(alpha.shape)} do not agree")
    if not _build.takes_kernel("staged_quad", kq):
        return staged_quad_reference(kq, w, alpha)
    _build.check_cuda_args("staged_quad", kq, w, alpha)
    tiles = _check_launch("staged_quad", m, c)
    partial = torch.empty((tiles, m), dtype=kq.dtype, device=kq.device)
    mean = torch.empty((m,), dtype=kq.dtype, device=kq.device)
    quad = torch.empty((m,), dtype=kq.dtype, device=kq.device)
    # A = W (C x C), B = kq (M x C), each W row tile over k < its last row + 1.
    plan, _keep = cuda_chol._tc_launch_args("staged_quad", w, kq, c, m, c, upper="rows",
                                            whole=True)
    _build.call("gpis_staged_quad", kq, kq.data_ptr(), m, w.data_ptr(), alpha.data_ptr(), c,
                partial.data_ptr(), mean.data_ptr(), quad.data_ptr(), *plan)
    _build.LAUNCHES["staged_quad"] += 1
    return mean, quad


def generated_kq(gen: str, name: str, q: torch.Tensor, cols: torch.Tensor, params):
    """The (M, C) kq tile of Kernel F's generator, in plain PyTorch: k(r2)
    against value columns x (C, 3), or f_c k(r2) - 2 dk(r2) (u_c . diff)
    against packed joint columns (coords, dirs, flag) (J, 7)."""
    if gen == "value":
        return kf.k_r2(name, pairwise_r2(q, cols), params)
    diff = q[:, None, :] - cols[None, :, :3]
    r2 = torch.sum(diff * diff, dim=-1)
    vd = torch.sum(diff * cols[None, :, 3:6], dim=-1)
    return cols[None, :, 6] * kf.k_r2(name, r2, params) - 2.0 * kf.dk_dr2(name, r2, params) * vd


def fused_quad_reference(gen: str, name: str, q, cols, params, alpha, w):
    """Plain twin of Kernel F: form kq, then the plain product."""
    return staged_quad_reference(generated_kq(gen, name, q, cols, params), w, alpha)


def fused_quad(gen: str, name: str, q: torch.Tensor, cols: torch.Tensor, params,
               alpha: torch.Tensor, w: torch.Tensor):
    """(mean (M,), quad (M,)) at queries q (M, 3) with kq generated on chip:
    gen "value" takes columns x (C, 3), gen "joint" packed joint columns
    (J, 7); W (C, C) lower-triangular, alpha (C,)."""
    if gen not in _GEN_STRIDE:
        raise ValueError(f"fused_quad: unknown generator {gen!r}")
    m, c = q.shape[0], cols.shape[0]
    if (q.ndim != 2 or q.shape[1] != 3 or cols.shape != (c, _GEN_STRIDE[gen])
            or w.shape != (c, c) or alpha.shape != (c,)):
        raise ValueError(f"fused_quad: q {tuple(q.shape)}, columns {tuple(cols.shape)}, "
                         f"W {tuple(w.shape)}, alpha {tuple(alpha.shape)} do not agree")
    if not _build.takes_kernel("fused_quad", q):
        return fused_quad_reference(gen, name, q, cols, params, alpha, w)
    if name not in KERNEL_IDS or (gen == "joint" and not kf.supports_derivatives(name)):
        raise ValueError(f"fused_quad: no CUDA {gen} generator for covariance {name!r}")
    _build.check_cuda_args("fused_quad", q, cols, w, alpha)
    tiles = _check_launch("fused_quad", m, c)
    partial = torch.empty((tiles, m), dtype=q.dtype, device=q.device)
    mean = torch.empty((m,), dtype=q.dtype, device=q.device)
    quad = torch.empty((m,), dtype=q.dtype, device=q.device)
    # A = W, B generated (no B operand read), as D's plan.
    plan, _keep = cuda_chol._tc_launch_args("fused_quad", w, None, c, m, c, upper="rows",
                                            whole=True)
    _build.call("gpis_fused_quad", q, q.data_ptr(), m, cols.data_ptr(), c, int(gen == "joint"),
                w.data_ptr(), alpha.data_ptr(), KERNEL_IDS[name], float(params["lengthscale"]),
                float(params["signal_variance"]), partial.data_ptr(), mean.data_ptr(),
                quad.data_ptr(), *plan)
    _build.LAUNCHES["fused_quad"] += 1
    return mean, quad


def quad_band_reference(gen: str, name: str, q, cols, params, w_band, row0: int):
    """Plain twin of Kernel F's band mode: kq against the band's columns,
    then the plain product (W's columns past the band's last row are zero)."""
    del row0  # the zeros of W carry the offset here
    kq = generated_kq(gen, name, q, cols[:w_band.shape[1]], params)
    v = w_band @ kq.T
    return torch.sum(v * v, dim=0)


def quad_band(gen: str, name: str, q: torch.Tensor, cols: torch.Tensor, params,
              w_band: torch.Tensor, row0: int) -> torch.Tensor:
    """quad (M,) = colsum((W_band kq^T)^2) for W_band (R, width), rows
    [row0, row0 + R) of a lower-triangular W, stored trimmed to
    width >= row0 + R columns (a row-major view); queries q (M, 3) and
    columns cols (value (C, 3) or packed joint (J, 7)) as for `fused_quad`."""
    if gen not in _GEN_STRIDE:
        raise ValueError(f"quad_band: unknown generator {gen!r}")
    m, c = q.shape[0], cols.shape[0]
    r, width = w_band.shape
    if (q.ndim != 2 or q.shape[1] != 3 or cols.shape != (c, _GEN_STRIDE[gen])
            or not 0 <= row0 <= row0 + r <= width <= c):
        raise ValueError(f"quad_band: q {tuple(q.shape)}, columns {tuple(cols.shape)}, "
                         f"W band {tuple(w_band.shape)} at row {row0} do not agree")
    if not _build.takes_kernel("quad_band", q):
        return quad_band_reference(gen, name, q, cols, params, w_band, row0)
    if name not in KERNEL_IDS or (gen == "joint" and not kf.supports_derivatives(name)):
        raise ValueError(f"quad_band: no CUDA {gen} generator for covariance {name!r}")
    _build.check_cuda_args("quad_band", q, cols)
    _build.check_cuda_rows("quad_band", w_band)
    tiles = _check_launch("quad_band", m, r)
    partial = torch.empty((tiles, m), dtype=q.dtype, device=q.device)
    quad = torch.empty((m,), dtype=q.dtype, device=q.device)
    if m == 0 or r == 0:
        return quad.zero_()
    # A = the band (R x width), B generated; the band's tile at row r0 is
    # live for k < row0 + r0 + 128.
    plan, _keep = cuda_chol._tc_launch_args("quad_band", w_band, None, r, m, width,
                                            upper="rows", k_offset=int(row0), whole=True)
    _build.call("gpis_quad_band", q, q.data_ptr(), m, cols.data_ptr(), c, int(gen == "joint"),
                w_band.data_ptr(), w_band.stride(0), r, width, int(row0), KERNEL_IDS[name],
                float(params["lengthscale"]), float(params["signal_variance"]),
                partial.data_ptr(), quad.data_ptr(), *plan)
    _build.LAUNCHES["quad_band"] += 1
    return quad


def want_staged(m: int, c: int, itemsize: int, staged: bool | None) -> bool:
    """The route of an (M, C) query: `staged` when given, else staged while
    the staged kq fits in KQ_STAGE_MAX bytes."""
    return m * c * itemsize <= KQ_STAGE_MAX if staged is None else bool(staged)


def fused_query(name: str, q: torch.Tensor, x: torch.Tensor, params, alpha: torch.Tensor,
                w: torch.Tensor, staged: bool | None = None):
    """(mean, quad) at queries q (M,3) against training points x (C,3),
    W = L^{-1} (C,C) and alpha (C,).  staged=None routes by the size of the
    staged kq (module note); True or False forces a route."""
    if want_staged(q.shape[0], x.shape[0], q.element_size(), staged):
        return staged_quad(cross_cov(name, q, x, params), w, alpha)
    return fused_quad("value", name, q.contiguous(), x.contiguous(), params, alpha, w)
