"""Row-band-sharded Gram, blocked Cholesky, solves, W = L^{-1} and query
over a torch.distributed row mesh (port of gpis_tpu/linalg/sharded.py,
BASELINE config 5).

Layout as in the JAX package: capacity C = P * rows_per; rank p owns the
contiguous row band [p C / P, (p + 1) C / P) of the Gram, of its factor L
and of W; the owner of block row j is rank j B // (C / P).  Each function
takes and returns this rank's band (a (C / P, C) tensor), and replicated
vectors whole.  Every rank runs the same loop and calls the same
collectives in the same order with the same shapes; an owner-only step
(its rows of a block, its diagonal solve) is followed by a broadcast that
every other rank receives.  The JAX package's collectives map to
torch.distributed: `_bcast_from` (a psum of a masked value) is
`dist.broadcast(src=owner)`, `psum` is `all_reduce`, and the query ring's
`ppermute` is `dist.batch_isend_irecv` to the next rank.

Tracing (`utils.profiling`, recorded only while a profiler runs): device
spans `shard.gram`, `shard.factor` and `shard.linv` around the band Gram,
the factor and W; `shard.hop` around each ring hop's band quad; device
spans `comm.bcast`, `comm.all_reduce`, `comm.all_gather` and `comm.ring`
around each collective (on a card the span's time is the stream's in the
collective, waits on slower ranks included); counters `shard.panels` (the
factor's block columns), `shard.hops` and `comm.bytes`, the payload this
rank puts into the collectives (a broadcast's tensor on its source, its own
tensor of an all-reduce or all-gather, what it sends along the ring); host
waits `wait.shard.potrf` (the factor's `int(info)` a block column) and
`wait.shard.ring` (the ring's request waits).

The kernels: the band Gram is Kernel A's band mode; the factor's panel
update is Kernel G (`gemm_nt_masked`) on the rows of the band at or below
the panel -- G computes S - A[:, :k0] B[:, :k0]^T on strided views, which is
the band's update against the broadcast block row, where Kernel B reads
its row panel from its own square buffer and so cannot take a band whose
panel row lives on another rank; the right-looking TRSM's trailing update
is Kernel L (`band_trail`) when asked for, else its plain masked product;
the query is Kernel A for the mean and Kernel F's band mode for each ring
hop's quad (Kernel E and F's joint generator for the joint layout of
`gp.sharded_joint`); the tactile update's tail rows are Kernel A.  The B x B potrf
and the triangular solves stay library calls, as the JAX package leaves
them to XLA.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gpis_tpu_torch.kernels import cuda_gram, cuda_query
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.kernels import gram as kg
from gpis_tpu_torch.linalg import cholesky as lin
from gpis_tpu_torch.linalg import cuda_chol
from gpis_tpu_torch.parallel.mesh import RowMesh
from gpis_tpu_torch.utils import profiling

__all__ = ["sharded_gram", "sharded_cholesky", "sharded_solve_lower_vec",
           "sharded_solve_lower_t_vec", "sharded_cho_solve_vec", "sharded_linv",
           "sharded_linv_ll", "sharded_alpha_from_linv", "sharded_update_tail",
           "sharded_predict_linv", "any_nan_diagonal"]


def _sent(t: torch.Tensor) -> None:
    profiling.count("comm.bytes", t.numel() * t.element_size())


def _bcast_from(t: torch.Tensor, owner: int) -> torch.Tensor:
    """Broadcast the owner's t to every rank, in place (t is contiguous)."""
    with profiling.span("comm.bcast", device=t.device):
        dist.broadcast(t, src=owner)
    if dist.get_rank() == owner:
        _sent(t)
    return t


def _psum(t: torch.Tensor) -> torch.Tensor:
    with profiling.span("comm.all_reduce", device=t.device):
        dist.all_reduce(t)
    _sent(t)
    return t


def _all_gather(t: torch.Tensor, p: int) -> list[torch.Tensor]:
    """Every rank's t (the same shape on each), in rank order."""
    parts = [torch.empty_like(t) for _ in range(p)]
    t = t.contiguous()
    with profiling.span("comm.all_gather", device=t.device):
        dist.all_gather(parts, t)
    _sent(t)
    return parts


def _block_layout(c: int, mesh: RowMesh, block: int) -> tuple[int, int]:
    row0, rows_per = mesh.band(c)
    if rows_per % block or c % block:
        raise ValueError(f"capacity {c} must tile into {mesh.size} ranks x {block} blocks")
    return row0, rows_per


def _clip(v: int, hi: int) -> int:
    return min(max(v, 0), hi)


def sharded_gram(name: str, x: torch.Tensor, params, noise, mesh: RowMesh) -> torch.Tensor:
    """This rank's (C / P, C) band of K(X, X) + diag(noise), from the
    replicated coordinates: Kernel A in band mode, no communication."""
    c = x.shape[0]
    row0, rows_per = mesh.band(c)
    noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device).broadcast_to((c,))
    band = slice(row0, row0 + rows_per)
    with profiling.span("shard.gram", device=x.device):
        return cuda_gram.cov(name, x[band].contiguous(), x.contiguous(), params,
                             noise=noise[band].contiguous(), sym=True, row0=row0)


def sharded_cholesky(a_loc: torch.Tensor, mesh: RowMesh, *, block: int = 256) -> torch.Tensor:
    """Lower Cholesky factor of the row-band-sharded SPD matrix whose band
    is a_loc, IN PLACE (left-looking, as in the JAX package):

        for block column j (owner o):
          o broadcasts its finished block row j (columns < j0)
          every rank: panel rows >= j0 -= L[rows, :j0] @ row_j^T   (G)
          o broadcasts the diagonal block S; every rank factors Ljj = chol(S)
          every rank: rows >= j0 + B of the panel = panel @ Ljj^{-T}

    The panel update is `cuda_chol.gemm_nt_masked` (G, or its twin on a
    CPU band).  A block that is not positive definite leaves the
    diagonal NaN on every rank (every rank factors the same broadcast S, so
    all stop at the same block and no collective is left unmatched)."""
    rows_per, c = a_loc.shape
    row0, _ = _block_layout(c, mesh, block)
    if rows_per * mesh.size != c:
        raise ValueError(f"band {tuple(a_loc.shape)} is not 1/{mesh.size} of a square matrix")
    dt, dev = a_loc.dtype, a_loc.device
    with profiling.span("shard.factor", device=dev):
        for j0 in range(0, c, block):
            profiling.count("shard.panels")
            j1 = j0 + block
            owner, lrow = divmod(j0, rows_per)
            mine = owner == mesh.rank
            r_s = _clip(j0 - row0, rows_per)  # first local row at global row >= j0
            if j0:
                row_j = (a_loc[lrow:lrow + block, :j0].contiguous() if mine
                         else torch.empty((block, j0), dtype=dt, device=dev))
                _bcast_from(row_j, owner)
                if r_s < rows_per:
                    panel = a_loc[r_s:, j0:j1]
                    panel.copy_(cuda_chol.gemm_nt_masked(a_loc[r_s:], row_j, panel, j0))
            s = (a_loc[lrow:lrow + block, j0:j1].contiguous() if mine
                 else torch.empty((block, block), dtype=dt, device=dev))
            _bcast_from(s, owner)
            ljj, info = torch.linalg.cholesky_ex(s)
            with profiling.wait("shard.potrf"):
                bad = int(info)
            if bad:
                a_loc[:, row0:row0 + rows_per].diagonal().fill_(float("nan"))
                return a_loc
            r_b = _clip(j1 - row0, rows_per)  # first local row at global row >= j1
            if r_b < rows_per:
                a_loc[r_b:, j0:j1] = torch.linalg.solve_triangular(ljj.T, a_loc[r_b:, j0:j1],
                                                                   upper=True, left=False)
            if mine:
                a_loc[lrow:lrow + block, j0:j1] = ljj
            a_loc[:r_s, j0:j1] = 0.0  # the strict upper triangle
        return a_loc


def any_nan_diagonal(l_loc: torch.Tensor, mesh: RowMesh) -> bool:
    """Whether the sharded factor's diagonal holds a NaN anywhere, agreed
    across ranks (the jitter ladder's test)."""
    row0, rows_per = mesh.band(l_loc.shape[1])
    flag = torch.isnan(l_loc[:, row0:row0 + rows_per].diagonal()).any().to(l_loc.dtype)
    return bool(_psum(flag.reshape(1)).item() > 0)


def sharded_solve_lower_vec(l_loc: torch.Tensor, b: torch.Tensor, mesh: RowMesh, *,
                            block: int = 256) -> torch.Tensor:
    """y with L y = b, L row-band-sharded, b and y replicated.  Block by
    block: the owner substitutes its block, then broadcasts it."""
    rows_per, c = l_loc.shape
    _block_layout(c, mesh, block)
    y = torch.zeros((c,), dtype=l_loc.dtype, device=l_loc.device)
    for j0 in range(0, c, block):
        j1 = j0 + block
        owner, lrow = divmod(j0, rows_per)
        if owner == mesh.rank:
            row_block = l_loc[lrow:lrow + block]
            rhs = b[j0:j1] - row_block[:, :j0] @ y[:j0]
            yj = torch.linalg.solve_triangular(row_block[:, j0:j1], rhs[:, None],
                                               upper=False)[:, 0].contiguous()
        else:
            yj = torch.empty((block,), dtype=y.dtype, device=y.device)
        y[j0:j1] = _bcast_from(yj, owner)
    return y


def sharded_solve_lower_t_vec(l_loc: torch.Tensor, b: torch.Tensor, mesh: RowMesh, *,
                              block: int = 256) -> torch.Tensor:
    """y with L^T y = b (L row-band-sharded, b replicated).  Step j, last
    block first: each rank sums its rows below the block of column panel j
    against y, an all-reduce adds the ranks, the owner substitutes."""
    rows_per, c = l_loc.shape
    row0, _ = _block_layout(c, mesh, block)
    y = torch.zeros((c,), dtype=l_loc.dtype, device=l_loc.device)
    for j0 in reversed(range(0, c, block)):
        j1 = j0 + block
        owner, lrow = divmod(j0, rows_per)
        r_b = _clip(j1 - row0, rows_per)
        contrib = _psum(l_loc[r_b:, j0:j1].T @ y[row0 + r_b:row0 + rows_per])
        if owner == mesh.rank:
            ljj = l_loc[lrow:lrow + block, j0:j1]
            yj = torch.linalg.solve_triangular(ljj.T, (b[j0:j1] - contrib)[:, None],
                                               upper=True)[:, 0].contiguous()
        else:
            yj = torch.empty((block,), dtype=y.dtype, device=y.device)
        y[j0:j1] = _bcast_from(yj, owner)
    return y


def sharded_cho_solve_vec(l_loc: torch.Tensor, b: torch.Tensor, mesh: RowMesh, *,
                          block: int = 256) -> torch.Tensor:
    y = sharded_solve_lower_vec(l_loc, b, mesh, block=block)
    return sharded_solve_lower_t_vec(l_loc, y, mesh, block=block)


def sharded_linv(l_loc: torch.Tensor, mesh: RowMesh, *, block: int = 256,
                 use_kernel: bool = False) -> torch.Tensor:
    """This rank's band of W = L^{-1}, by the right-looking distributed TRSM:

        S_loc := I[rows_loc, :]
        for block row j:  owner solves W_j = Ljj^{-1} S[j, :]; broadcast W_j
                          every rank: S_loc -= L_loc[:, j] W_j  (rows below j)

    The trailing update is Kernel L with use_kernel, else its plain masked
    product (the JAX package's default, `use_pallas=False`)."""
    rows_per, c = l_loc.shape
    row0, _ = _block_layout(c, mesh, block)
    dt, dev = l_loc.dtype, l_loc.device
    s = torch.zeros((rows_per, c), dtype=dt, device=dev)
    s[:, row0:row0 + rows_per].diagonal().fill_(1.0)
    trail = cuda_chol.band_trail if use_kernel else cuda_chol.band_trail_reference
    with profiling.span("shard.linv", device=dev):
        for j0 in range(0, c, block):
            j1 = j0 + block
            owner, lrow = divmod(j0, rows_per)
            mine = owner == mesh.rank
            wj = (torch.linalg.solve_triangular(l_loc[lrow:lrow + block, j0:j1],
                                                s[lrow:lrow + block], upper=False).contiguous()
                  if mine else torch.empty((block, c), dtype=dt, device=dev))
            _bcast_from(wj, owner)
            trail(s, l_loc[:, j0:j1], wj, j0, row0)
            if mine:
                s[lrow:lrow + block] = wj
    return s


def sharded_linv_ll(l_loc: torch.Tensor, mesh: RowMesh, *, block: int = 256) -> torch.Tensor:
    """This rank's band of W = L^{-1}, by the LEFT-looking distributed TRSM:

        for block row j (owner o):
          o broadcasts L's row panel j                  (columns < j0 + B)
          every rank: partial = Lrow[:, my rows < j0] @ W[my rows < j0, :]
          all-reduce -> upd; o writes W_j = Ljj^{-1} (I_j - upd)"""
    rows_per, c = l_loc.shape
    row0, _ = _block_layout(c, mesh, block)
    dt, dev = l_loc.dtype, l_loc.device
    w = torch.zeros((rows_per, c), dtype=dt, device=dev)
    for j0 in range(0, c, block):
        j1 = j0 + block
        owner, lrow = divmod(j0, rows_per)
        mine = owner == mesh.rank
        l_row = (l_loc[lrow:lrow + block, :j1].contiguous() if mine
                 else torch.empty((block, j1), dtype=dt, device=dev))
        _bcast_from(l_row, owner)
        k_hi = _clip(j0 - row0, rows_per)  # my band's finished rows
        upd = _psum(l_row[:, row0:row0 + k_hi] @ w[:k_hi])
        if mine:
            rhs = -upd
            rhs[:, j0:j1] += torch.eye(block, dtype=dt, device=dev)
            w[lrow:lrow + block] = torch.linalg.solve_triangular(l_row[:, j0:j1], rhs,
                                                                 upper=False)
    return w


def sharded_alpha_from_linv(w_loc: torch.Tensor, y: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """alpha = K^{-1} y = W^T (W y), W row-sharded, y and alpha replicated."""
    return _psum(w_loc.T @ (w_loc @ y))


def sharded_update_tail(name: str, params, x: torch.Tensor, noise, l_loc: torch.Tensor,
                        w_loc: torch.Tensor, mesh: RowMesh):
    """Re-form the LAST row band [rest, C) of the sharded factor and of W
    after its training rows changed (the touch slots live there); the
    leading rows are untouched.  With W11 = L11^{-1}, the unchanged leading
    block of W, the bordering is products alone:

        L21 = K21 W11^T         (each rank's columns from its W band,
                                 all-gathered into the tail rows)
        L22 = chol(K22 - L21 L21^T)
        W21 = -L22^{-1} (L21 W11)   (an all-reduce of the band partials)
        W22 = L22^{-1}

    x and noise are replicated (C,); returns this rank's (l_loc, w_loc),
    the last rank's re-formed, the others' as given.  At P = 1 the last
    band is the whole matrix (rest = 0)."""
    c = x.shape[0]
    band = c // mesh.size
    rest = c - band
    dt, dev = l_loc.dtype, l_loc.device
    x_tail = x[rest:]
    if mesh.rank == mesh.size - 1:  # its columns of L21 are zero: W11 has none of its rows
        l21_cols = torch.zeros((band, w_loc.shape[0]), dtype=dt, device=dev)
        part = torch.zeros((band, c), dtype=dt, device=dev)
    else:
        l21_cols = kg.cross_cov(name, x_tail, x, params) @ w_loc.T  # this rank's columns of L21
        part = l21_cols @ w_loc
    parts = _all_gather(l21_cols, mesh.size)
    t = _psum(part)  # L21 W, (band, C)
    if mesh.rank != mesh.size - 1:
        return l_loc, w_loc
    l21 = torch.cat(parts, dim=1)  # (band, C)
    noise = torch.as_tensor(noise, dtype=dt, device=dev).broadcast_to((c,))
    l22 = lin.cholesky(kg.gram(name, x_tail, params, noise=noise[rest:]) - l21 @ l21.T)
    # Row-major, as the query's band kernel reads W (a solve returns its
    # result column-major).
    w_tail = (-torch.linalg.solve_triangular(l22, t, upper=False)).contiguous()
    w_tail[:, rest:] = torch.linalg.solve_triangular(
        l22, torch.eye(band, dtype=dt, device=dev), upper=False)
    l21[:, rest:] = l22
    return l21, w_tail


def _ring_shift(q: torch.Tensor, quad: torch.Tensor, mesh: RowMesh):
    """Send (q, quad) to the next rank and receive the previous rank's."""
    out = torch.cat([q, quad[:, None]], dim=1)
    got = torch.empty_like(out)
    ops = [dist.P2POp(dist.isend, out, (mesh.rank + 1) % mesh.size),
           dist.P2POp(dist.irecv, got, (mesh.rank - 1) % mesh.size)]
    with profiling.span("comm.ring", device=out.device):
        reqs = dist.batch_isend_irecv(ops)
        with profiling.wait("shard.ring"):
            for req in reqs:
                req.wait()
    _sent(out)
    return got[:, :3].contiguous(), got[:, 3].contiguous()


def sharded_predict_linv(name: str, q: torch.Tensor, x: torch.Tensor, params,
                         alpha: torch.Tensor, w_loc: torch.Tensor, mesh: RowMesh, *,
                         precision=None, cross_fn=None, band=None):
    """Posterior (mean, variance) at this rank's shard of the replicated
    queries q (M, 3), M a multiple of P: rows [r M / P, (r + 1) M / P).  The
    mean is kq @ alpha (kq through Kernel A); the variance's ||W kq^T||^2
    pairs every W band with every query shard, so the shards ride a ring
    and each hop adds this band's partial quad (Kernel F's band mode, kq
    generated on chip against the band's live columns).  After P hops every
    shard is home with all P bands' share.

    `cross_fn(name, q, x, params)` replaces the value cross-covariance for
    another column layout (the joint model's, `gp.sharded_joint.
    joint_cross`) and comes with `band = (generator, columns)`, what Kernel
    F's band mode needs for that layout (`gp.sharded_joint.joint_band`):
    one without the other raises TypeError.  precision other than None
    takes each hop's kq through `cross_fn` (or Kernel A) and its product as
    exact FP32 plain PyTorch (`cuda_query.exact_fp32`; slow, for checking
    the fast route)."""
    if (cross_fn is None) != (band is None):
        raise TypeError("sharded_predict_linv: cross_fn and band go together")
    m = q.shape[0]
    if m % mesh.size:
        raise ValueError(f"query count {m} not divisible by mesh size {mesh.size}")
    per = m // mesh.size
    q_loc = q[mesh.rank * per:(mesh.rank + 1) * per].contiguous()
    row0 = mesh.band(w_loc.shape[1])[0]
    cross = cross_fn or kg.cross_cov
    gen, cols = band or ("value", x)
    mean = cross(name, q_loc, x, params) @ alpha
    quad = torch.zeros((per,), dtype=q.dtype, device=q.device)
    qv = q_loc
    for _ in range(mesh.size):
        profiling.count("shard.hops")
        with profiling.span("shard.hop"):
            if precision is None:
                quad = quad + cuda_query.quad_band(gen, name, qv, cols, params, w_loc, row0)
            else:
                with cuda_query.exact_fp32():
                    v = w_loc @ cross(name, qv, x, params).T
                quad = quad + torch.sum(v * v, dim=0)
        if mesh.size > 1:
            qv, quad = _ring_shift(qv, quad, mesh)
    return mean, float(kf.k_diag0(name, params)) - quad
