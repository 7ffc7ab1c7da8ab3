"""Out-of-core GP fit and query on one card (port of gpis_tpu/linalg/outofcore.py).

The single-device path for clouds whose one-matrix factor does not fit on the
card: the Cholesky factor L and then W = L^{-1} live OUT OF CORE as trimmed
row panels (panel j = rows [jB, (j+1)B) x columns [0, w_j), w_j >= (j+1)B,
the only structurally nonzero part) in a panel store:

* `DevicePanelStore` -- every panel in device memory (~0.56 C^2 floats
  instead of C^2, and W_j takes L_j's place as the TRSM consumes L);
* `HostPanelStore` -- every panel in pinned host RAM, streamed per use;
* `TieredPanelStore` -- device memory up to a byte budget (`DeviceBudget`,
  shared by the L and W stores of one fit), host RAM beyond it;
  `promote` pins spilled panels back on the card for serving.

Cholesky (`ooc_cholesky`) -- row-panel bordering.  A sweep of r row panels
is one (rB, C) band `cur`, filled with the Gram rows (Kernel A band mode, or
Kernel E for a joint factor):

    for k < j:  S_k = cur[:, kB:(k+1)B] - cur[:, :kB] L_k[:, :kB]^T   (Kernel G)
                cur[:, kB:(k+1)B] = S_k L_kk^{-T}                      (Kernel I)
    S_jj = cur[:, jB:] - cur[:, :jB] cur[:, :jB]^T ;  L_jj = potrf(S_jj)

with the forward substitution u = L^{-1} y taken inline from each band, and
with `stats` the running sum(log diag L) (the L panels are consumed by the
TRSM, so this is the one moment the diagonal is on the card): with u it
gives the exact marginal likelihood for free (`OOCModel.log_marginal_likelihood`).
alpha = L^{-T} u streams the L panels once backwards (`ooc_alpha_backward`).

TRSM (`ooc_trsm`) -- left-looking W = L^{-1} by row panels:

    U   = sum_{k<j} L_j[:, kB:(k+1)B] W_k       (Kernel H, output columns < (k+1)B)
    W_j = L_jj^{-1} [-U | I]                     (Kernels I and H, triangular solves)

Step j consumes L panel j, so W_j takes its place in the budget.  With
`accumulate_alpha` it sums alpha = W^T (W y) sweep by sweep; `on_panel(j0,
rows)` hands a consumer each sweep's full-width W rows while they are on
the card (the streamed MLL gradient of `gp.ooc_hyperopt` rides on it).

Query (`ooc_predict`) -- mean = K(Q, X) alpha per chunk; the variance
streams each W panel once in total (the panel loop is outermost) through
Kernel F's band mode, adding ||W_j kq^T||^2 into every chunk's quad, then
clamps to [0, k0] as the JAX package does.

Tactile updates (`ooc_update`) border the factor without rewriting a panel:
L_full = [[L, 0], [V^T, Lt]] with V = W K(X, X_tail) and
Lt = chol(K_tail + diag(noise) - V^T V).  The tail block lives on the card
(V and A = W^T V, (C, T); Lt, (T, T)); one pass over the W panels a batch
forms the new columns of V and A, and a query adds the tail's mean and its
share of the quad from the mean's own kq (`_posterior_chunk`).

What differs from the JAX package, and why:
* Operands are views with a leading dimension.  The JAX package padded
  every panel to full width and sliced with `lax.dynamic_slice` so that one
  compiled kernel served every panel; here each kernel takes its row-major
  views as they are (a stripe of `cur`, a trimmed panel), so no (R, C)
  copy and no zero padding appears on the card.
* Host and device overlap through CUDA streams, not threads: a copy stream
  prefetches the next panel (`_Prefetcher`) and a writer stream moves
  spilled panels to pinned host RAM (`_AsyncWriter`).  Each transfer ends
  in an event that the consuming stream waits on, and each buffer used on
  a second stream is marked with `record_stream`, so the caching allocator
  never hands out memory that a copy still reads or writes.
* The tunnel machinery is not ported: the link accounting, the 16 MB h2d
  slices and the CPU-device d2h staging.  `TRAFFIC` counts the bytes moved
  each way, nothing more.

Not in this slice (each raises NotImplementedError naming its ROADMAP.md
§1 item 15): the disk spill, the f16 W spill, the int16 L codec with
`ooc_residual_check`, the process-split phases and `plan_sweeps`.

Functions take tensors and work on the device the tensors are on; on the
CPU every kernel call takes its plain twin.
"""

from __future__ import annotations

import collections
import dataclasses
import math

import torch

from gpis_tpu_torch._build import not_ported
from gpis_tpu_torch.gp.model import round_up
from gpis_tpu_torch.kernels import cuda_gram, cuda_joint, cuda_query
from gpis_tpu_torch.kernels import derivative as kd
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.kernels import gram as kg
from gpis_tpu_torch.linalg import cholesky as lin
from gpis_tpu_torch.linalg import cuda_chol

__all__ = ["TRAFFIC", "DeviceBudget", "HostPanelStore", "DevicePanelStore", "TieredPanelStore",
           "ooc_cholesky", "ooc_alpha_backward", "ooc_trsm", "ooc_predict", "ooc_predict_mean",
           "ooc_fit", "ooc_fit_joint", "OOCModel", "OOCJointModel", "ooc_update",
           "tail_cross", "ooc_residual_check", "ooc_factor_phase", "ooc_solve_phase", "plan_sweeps"]

# Bytes moved between host RAM and the card by the panel stores, each way
# ("h2d_bytes", "d2h_bytes").
TRAFFIC: collections.Counter = collections.Counter()

# A stored panel's width is its true width rounded up to a multiple of
# WIDTH_QUANT panels (the JAX package's default, so both store the same shapes).
WIDTH_QUANT = 2
# Row panels per band in the factor (SWEEP) and per outer step of the TRSM.
SWEEP = 2
TRSM_SWEEP = 2
# Retries of the NaN-escalation jitter ladder before a fit gives up.
MAX_JITTER_RETRIES = 3


# ------------------------------------------------------------ panel stores


class DeviceBudget:
    """Device-memory byte budget shared by the L and W tiered stores of one
    fit: the TRSM frees L panels while W panels grow, so one pot keeps their
    sum bounded."""

    def __init__(self, limit_bytes: int):
        self.limit = int(limit_bytes)
        self._used = 0

    def take(self, n: int) -> bool:
        if self._used + n <= self.limit:
            self._used += n
            return True
        return False

    def give(self, n: int) -> None:
        self._used -= n


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _compact_copy(arr: torch.Tensor) -> torch.Tensor:
    """A compact copy: a stored panel must not keep its band alive."""
    return arr.clone(memory_format=torch.contiguous_format)


def _d2h(arr: torch.Tensor, stream):
    """Host copy of a panel.  From a card, into pinned memory, enqueued on
    `stream` after the work already on the current stream; returns (host,
    event), the copy complete when the event is.  Without a stream the copy
    is synchronous; on the CPU it is a plain copy.  Either way no event."""
    if arr.device.type != "cuda":
        return _compact_copy(arr), None
    TRAFFIC["d2h_bytes"] += _nbytes(arr)
    host = torch.empty(arr.shape, dtype=arr.dtype, pin_memory=True)
    if stream is None:
        return host.copy_(arr), None
    stream.wait_stream(torch.cuda.current_stream(arr.device))
    with torch.cuda.stream(stream):
        host.copy_(arr, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    arr.record_stream(stream)  # arr's memory stays out of reuse until the copy ends
    return host, done


class _PanelStore:
    """Trimmed panels by index.  `ready_event(j)` is the event a host panel's
    pending device-to-host copy completes at (None once known complete)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._p: dict[int, torch.Tensor] = {}
        self._ready: dict[int, object] = {}

    def _store(self, j: int, arr: torch.Tensor, stream) -> torch.Tensor:
        raise NotImplementedError

    def put(self, j: int, arr: torch.Tensor, stream=None) -> None:
        self._p[j] = self._store(j, arr, stream)

    def get(self, j: int) -> torch.Tensor:
        return self._p[j]

    def ready_event(self, j: int):
        return self._ready.get(j)

    def free(self, j: int) -> None:
        self._p.pop(j, None)
        self._ready.pop(j, None)

    def clear(self) -> None:
        for j in list(self._p):
            self.free(j)

    def __contains__(self, j) -> bool:
        return j in self._p


class HostPanelStore(_PanelStore):
    """Every panel in (pinned) host RAM."""

    def _store(self, j, arr, stream):
        host, self._ready[j] = _d2h(arr, stream)
        return host


class DevicePanelStore(_PanelStore):
    """Every panel in device memory."""

    def _store(self, j, arr, stream):
        return _compact_copy(arr)


class TieredPanelStore(_PanelStore):
    """Panels stay on the card while the shared budget lasts, then spill to
    pinned host RAM (budget first: the earliest panels, which the
    left-looking loops read most, stay resident)."""

    def __init__(self, budget: DeviceBudget, device):
        super().__init__(device)
        self._budget = budget
        self._meta: dict[int, tuple[bool, int]] = {}  # j -> (on the card, bytes)

    def _store(self, j, arr, stream):
        size = _nbytes(arr)
        on_dev = self._budget.take(size)
        self._meta[j] = (on_dev, size)
        if on_dev:
            return _compact_copy(arr)
        host, self._ready[j] = _d2h(arr, stream)
        return host

    def free(self, j: int) -> None:
        on_dev, size = self._meta.pop(j, (False, 0))
        if on_dev:
            self._budget.give(size)
        super().free(j)

    def spilled(self) -> list[int]:
        """Indices of the panels held in host RAM."""
        return sorted(j for j, (on_dev, _) in self._meta.items() if not on_dev)

    def promote(self, limit_bonus: int = 0) -> int:
        """Move spilled panels back onto the card (serving mode), in
        ascending order, until the budget (raised by `limit_bonus`) refuses;
        returns the bytes promoted.  After a fit its working set is gone, and
        a session that queries again and again would otherwise stream every
        spilled panel on every query."""
        self._budget.limit += int(limit_bonus)
        promoted = 0
        for j in self.spilled():
            size = self._meta[j][1]
            if not self._budget.take(size):
                break
            done = self._ready.pop(j, None)
            if done is not None:
                done.synchronize()
            self._p[j] = self._p[j].to(self.device)
            if self.device.type == "cuda":
                TRAFFIC["h2d_bytes"] += size
            self._meta[j] = (True, size)
            promoted += size
        return promoted

    @classmethod
    def open_dir(cls, *args, **kwargs):
        not_ported("TieredPanelStore.open_dir (the disk spill)", 15, "out-of-core")


def _make_store(kind: str, budget: DeviceBudget, device):
    if kind == "host":
        return HostPanelStore(device)
    if kind == "device":
        return DevicePanelStore(device)
    if kind == "tiered":
        return TieredPanelStore(budget, device)
    raise ValueError(f"unknown panel store kind {kind!r}")


# ------------------------------------------------------- pipeline helpers


def _fetch(store: _PanelStore, j: int, stream=None):
    """Stored panel j on the store's device, at its trimmed width, and the
    event its copy ends at (None when no copy was made, or the copy was
    synchronous).  A host panel is copied on `stream` when one is given,
    after its own device-to-host copy, if still pending, has ended."""
    v = store.get(j)
    dev = store.device
    if v.device == dev:
        return v, None
    TRAFFIC["h2d_bytes"] += _nbytes(v)
    pending = store.ready_event(j)
    if stream is None:
        if pending is not None:
            pending.synchronize()
        return v.to(dev), None
    with torch.cuda.stream(stream):
        if pending is not None:
            stream.wait_event(pending)
        out = v.to(dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return out, done


class _Prefetcher:
    """Panels of `order` in turn, each fetched one step ahead: the
    host-to-device copy of the next panel runs on a copy stream while the
    current stream computes on this one.  Before it starts the next copy it
    waits for the work already queued on the previous panel, so at most two
    fetched panels are alive."""

    def __init__(self, store: _PanelStore, order):
        self._store = store
        self._order = list(order)
        self._cuda = store.device.type == "cuda"
        self._stream = torch.cuda.Stream(store.device) if self._cuda else None
        self._i = 0
        self._next = _fetch(store, self._order[0], self._stream) if self._order else None

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= len(self._order):
            raise StopIteration
        current = torch.cuda.current_stream(self._store.device) if self._cuda else None
        if self._cuda and self._i:
            current.synchronize()  # the previous panel's work is done: its buffer is free
        arr, done = self._next
        if done is not None:
            current.wait_event(done)
            arr.record_stream(current)
        k = self._order[self._i]
        self._i += 1
        self._next = (_fetch(self._store, self._order[self._i], self._stream)
                      if self._i < len(self._order) else None)
        return k, arr


class _AsyncWriter:
    """Puts finished panels into a store.  A panel that spills to host RAM
    is copied on a writer stream, so the copy overlaps the next band's
    compute; one such copy is in flight at a time."""

    def __init__(self, store: _PanelStore):
        self._store = store
        self._stream = torch.cuda.Stream(store.device) if store.device.type == "cuda" else None

    def put(self, j: int, arr: torch.Tensor) -> None:
        self.drain()
        self._store.put(j, arr, self._stream)

    def drain(self) -> None:
        if self._stream is not None:
            self._stream.synchronize()


# ------------------------------------------------------------ device steps


def _meta_triple(m: torch.Tensor):
    """(J, 7) packed joint metadata -> (coords, dirs, flag) views."""
    return m[:, :3], m[:, 3:6], m[:, 6]


def _gram_band(name: str, cols: torch.Tensor, noise: torch.Tensor, params, row0: int,
               rows: int) -> torch.Tensor:
    """(rows, C) band of K(cols) + diag(noise) at global rows [row0, row0+rows).
    cols with 7 columns is packed joint metadata: the band is joint
    covariance rows (Kernel E), and the factor, TRSM and query above are
    the same for both layouts.  Value columns (C, 3) take Kernel A's band
    mode."""
    band = cols[row0:row0 + rows]
    if cols.shape[1] == 7:
        noise_col = torch.zeros((cols.shape[0],), dtype=cols.dtype, device=cols.device)
        noise_col[row0:row0 + rows] = noise[row0:row0 + rows]
        return cuda_joint.joint_rows(name, _meta_triple(band), _meta_triple(cols), params,
                                     noise_col=noise_col, row0=row0)
    return cuda_gram.cov(name, band, cols, params, noise=noise[row0:row0 + rows], sym=True,
                         row0=row0)


def _potrf(a: torch.Tensor, block: int) -> torch.Tensor:
    """Lower factor of a (R, R) block, in place; a NaN diagonal where it is
    not positive definite (the signal `_diag_nan` reads)."""
    if a.shape[0] % block == 0:
        return cuda_chol.blocked_cholesky(a, block)
    l, info = torch.linalg.cholesky_ex(a)
    if int(info):
        l.diagonal().fill_(float("nan"))
    return l


def _trsm_right_blocked(s: torch.Tensor, l: torch.Tensor, *, block: int) -> torch.Tensor:
    """X with X L^T = S, L (P, P) lower-triangular, IN PLACE on s (R, P):
    block-right-looking, Kernel G for the updates, a triangular solve on
    each diagonal block (the JAX package's choice: an explicit inverse's
    rounding is amplified by cond(L))."""
    p = s.shape[1]
    if p % block:
        s.copy_(torch.linalg.solve_triangular(l.T, s, upper=True, left=False))
        return s
    for c0 in range(0, p, block):
        sc = cuda_chol.gemm_nt_masked(s, l[c0:c0 + block], s[:, c0:c0 + block], c0)
        s[:, c0:c0 + block] = torch.linalg.solve_triangular(
            l[c0:c0 + block, c0:c0 + block].T, sc, upper=True, left=False)
    return s


def _chol_kstep(cur: torch.Tensor, lk: torch.Tensor, k0: int, *, block: int) -> None:
    """One bordering step of the band against stored panel k (lk, trimmed):
    cur[:, k0:k0+B] <- (cur[:, k0:k0+B] - cur[:, :k0] lk[:, :k0]^T) L_kk^{-T}."""
    p = lk.shape[0]
    s = cuda_chol.gemm_nt_masked(cur, lk, cur[:, k0:k0 + p], k0)
    cuda_chol.stripe_write(cur, _trsm_right_blocked(s, lk[:, k0:k0 + p], block=block), k0)


def _chol_diag(cur: torch.Tensor, j0: int, *, block: int) -> None:
    """Finish the band: factor its (R, R) diagonal block in place."""
    r = cur.shape[0]
    s = cuda_chol.gemm_nt_masked(cur, cur, cur[:, j0:j0 + r], j0)
    cuda_chol.stripe_write(cur, _potrf(s, block), j0)


def _mask_cols(a: torch.Tensor, limit: int) -> None:
    """Zero the columns at or beyond `limit`: stored panels are exact zeros
    past their true width, which the substitutions and the TRSM rely on."""
    a[:, limit:] = 0.0


def _diag_nan(cur: torch.Tensor, j0: int) -> bool:
    """NaN check of the just-factored diagonal block."""
    r = cur.shape[0]
    return bool(torch.isnan(cur[:, j0:j0 + r].diagonal()).any())


def _band_logdiag(cur: torch.Tensor, j0: int) -> float:
    """sum(log diag L) over the band's diagonal block: local row t of the
    band is global row j0 + t, its diagonal entry cur[t, j0 + t]."""
    r = cur.shape[0]
    return float(torch.sum(torch.log(cur[:, j0:j0 + r].diagonal())))


def _fwd_sub_step(u: torch.Tensor, lj: torch.Tensor, y: torch.Tensor, j0: int) -> None:
    """u[j0:j0+b] = L_jj^{-1} (y_j - L_j u), in place, for the b rows of lj
    (trimmed): u[j0:] is still zero, so the whole row product needs no mask."""
    b, w = lj.shape
    yj = y[j0:j0 + b] - lj @ u[:w]
    u[j0:j0 + b] = torch.linalg.solve_triangular(lj[:, j0:j0 + b], yj[:, None],
                                                 upper=False)[:, 0]


def _bwd_sub_step(alpha: torch.Tensor, acc: torch.Tensor, lj: torch.Tensor, u: torch.Tensor,
                  j0: int) -> None:
    """Descending pass of alpha = L^{-T} u, in place: solve alpha_j from the
    accumulated tail contributions, then push panel j's columns onto acc
    (its diagonal block's share lands on acc[j0:j0+b], never read again)."""
    b, w = lj.shape
    rhs = u[j0:j0 + b] - acc[j0:j0 + b]
    aj = torch.linalg.solve_triangular(lj[:, j0:j0 + b].T, rhs[:, None], upper=True)[:, 0]
    alpha[j0:j0 + b] = aj
    acc[:w] += aj @ lj


def _trsm_kstep(u: torch.Tensor, lj: torch.Tensor, wk: torch.Tensor, k0: int,
                width: int) -> None:
    """U += L_j[:, k0:k0+B] W_k over output columns < width (Kernel H)."""
    p = wk.shape[0]
    cuda_chol.gemm_nn_acc_masked(u, lj[:, k0:k0 + p], wk, width)


def _trsm_finish(ljj: torch.Tensor, u: torch.Tensor, j0: int, *, block: int) -> None:
    """W rows = L_dd^{-1} [-U | I | 0], IN PLACE on u (R, C): I at columns
    [j0, j0+R), zeros beyond (u's columns >= j0 are zero by construction).
    A left-blocked solve: block r contracts the solved rows above r0
    (Kernel H, k running over rows < r0 only, so the launch never reads the
    rows it writes) and then solves its diagonal block."""
    rows = ljj.shape[0]
    u.neg_()
    cuda_chol.stripe_write(u, torch.eye(rows, dtype=u.dtype, device=u.device), j0)
    width = j0 + rows
    for r0 in range(0, rows, block):
        xr = u[r0:r0 + block, :width]
        cuda_chol.gemm_nn_acc_masked(xr, -ljj[r0:r0 + block, :r0], u[:r0], width)
        xr.copy_(torch.linalg.solve_triangular(ljj[r0:r0 + block, r0:r0 + block], xr,
                                               upper=False))


def _store_width(j: int, panel: int, c: int) -> int:
    """Trimmed width of stored panel j: its true width (j+1)B rounded up to
    a multiple of WIDTH_QUANT panels, at most C."""
    return min(((j + WIDTH_QUANT) // WIDTH_QUANT) * WIDTH_QUANT * panel, c)


# ----------------------------------------------------------------- phases


def ooc_cholesky(kernel: str, cols: torch.Tensor, noise: torch.Tensor, params, store, *,
                 panel: int, block: int = 256, sweep: int = 1, y: torch.Tensor | None = None,
                 logdiag0: float = 0.0, stats: dict | None = None):
    """Row-panel bordering Cholesky of K(cols) + diag(noise) into `store`
    (trimmed panels, zero past their true width).  cols is (C, 3) points or
    (J, 7) packed joint metadata.  Returns (ok, u): ok False if the factor
    came back NaN (the caller escalates jitter); with y, u = L^{-1} y, taken
    inline from each band while it is on the card.  `sweep` row panels form
    one band, so each stored panel is fetched once a sweep.  With `stats`,
    stats["logdiag_sum"] holds logdiag0 + sum(log diag L) over the panels
    factored so far, after every sweep."""
    c = cols.shape[0]
    if c % panel:
        raise ValueError(f"capacity {c} must be a multiple of panel {panel}")
    nb = c // panel
    writer = _AsyncWriter(store)
    u = None if y is None else torch.zeros_like(y)
    logdiag = float(logdiag0)
    j = 0
    while j < nb:
        r = min(max(int(sweep), 1), nb - j)
        j0, rows = j * panel, r * panel
        cur = _gram_band(kernel, cols, noise, params, j0, rows)
        for k, lk in _Prefetcher(store, range(j)):
            _chol_kstep(cur, lk, k * panel, block=block)
        _chol_diag(cur, j0, block=block)
        if _diag_nan(cur, j0):
            writer.drain()
            return False, None
        _mask_cols(cur, j0 + rows)
        if stats is not None:
            logdiag += _band_logdiag(cur, j0)
            stats["logdiag_sum"] = logdiag
        if u is not None:
            _fwd_sub_step(u, cur, y, j0)
        for rr in range(r):
            w = _store_width(j + rr, panel, c)
            writer.put(j + rr, cur[rr * panel:(rr + 1) * panel, :w])
        j += r
    writer.drain()
    return True, u


def ooc_alpha_backward(lstore, u: torch.Tensor, *, panel: int) -> torch.Tensor:
    """alpha = L^{-T} u by backward substitution: one descending pass over
    the stored L panels (the forward half runs inline in ooc_cholesky)."""
    nb = u.shape[0] // panel
    alpha = torch.zeros_like(u)
    acc = torch.zeros_like(u)
    for j, lj in _Prefetcher(lstore, range(nb - 1, -1, -1)):
        _bwd_sub_step(alpha, acc, lj, u, j * panel)
    return alpha


def ooc_trsm(lstore, wstore, y: torch.Tensor, *, panel: int, block: int = 256,
             accumulate_alpha: bool = True, sweep: int = 1, on_panel=None,
             store_final: bool = True):
    """W = L^{-1} by left-looking row panels into `wstore`, consuming the L
    panels as it goes (L panel j is freed before W panel j is stored, so W_j
    takes its budget).  `sweep` W row panels are solved per outer step, so
    each earlier W panel is fetched once a sweep.  y (C,) sets the size;
    returns alpha = W^T (W y) accumulated sweep by sweep, or None without
    `accumulate_alpha` (the fits take alpha by substitution against L).
    `on_panel(j0, rows)` is called with each sweep's (R, C) W rows, zero
    past column j0 + R, while they are on the card.  store_final=False
    leaves the last sweep's panels out of `wstore`: the TRSM never reads
    them again, so a caller whose consumer rode on `on_panel` saves their
    write."""
    if panel % block:
        raise ValueError(f"panel ({panel}) must be a multiple of block ({block})")
    c = y.shape[0]
    nb = c // panel
    alpha = torch.zeros_like(y) if accumulate_alpha else None
    dev = lstore.device
    writer = _AsyncWriter(wstore)
    j = 0
    while j < nb:
        r = min(max(int(sweep), 1), nb - j)
        j0, rows = j * panel, r * panel
        parts = [_fetch(lstore, j + rr)[0] for rr in range(r)]
        if r == 1:
            lj = parts[0]
        else:  # the sweep's rows, padded to the widest panel of the group
            lj = torch.zeros((rows, max(p.shape[1] for p in parts)), dtype=parts[0].dtype,
                             device=dev)
            for rr, part in enumerate(parts):
                lj[rr * panel:(rr + 1) * panel, :part.shape[1]] = part
        del parts
        u = torch.zeros((rows, c), dtype=lj.dtype, device=dev)
        for k, wk in _Prefetcher(wstore, range(j)):
            _trsm_kstep(u, lj, wk, k * panel, (k + 1) * panel)
        ljj = lj[:, j0:j0 + rows].clone()  # only the diagonal block survives
        del lj
        for rr in range(r):
            lstore.free(j + rr)
        _trsm_finish(ljj, u, j0, block=block)
        del ljj
        if accumulate_alpha:
            alpha += (u @ y) @ u
        if on_panel is not None:
            on_panel(j0, u)
        if store_final or j + r < nb:
            for rr in range(r):
                w = _store_width(j + rr, panel, c)
                writer.put(j + rr, u[rr * panel:(rr + 1) * panel, :w])
        del u
        j += r
    writer.drain()
    return alpha


def _factor_cols(model) -> torch.Tensor:
    """The factor's columns: packed joint metadata for a joint model, the
    coordinates for a value model."""
    meta = getattr(model, "meta", None)
    return model.x if meta is None else meta


def _value_cross(name: str, q: torch.Tensor, cols: torch.Tensor, params) -> torch.Tensor:
    """cov(f(q), factor columns) for value (C, 3) or packed joint (J, 7)
    columns: Kernel A or Kernel E."""
    if cols.shape[1] == 7:
        return cuda_joint.joint_rows(name, cuda_joint.value_meta(q), _meta_triple(cols), params)
    return cuda_gram.cov(name, q, cols, params)


def tail_cross(model, q, *, grad: bool = False) -> torch.Tensor:
    """K(q, touch tail) (M, T), or with `grad` its gradient in q (3M, T,
    dimension-major), with the unused slots' columns zeroed: the one place
    the tail's live slots are masked."""
    cross = kd.cross_cov_grad_value if grad else kg.cross_cov
    live = (torch.arange(model.tail_x.shape[0], device=q.device) < model.n_tail).to(q.dtype)
    return cross(model.kernel, q, model.tail_x, model.params) * live


def _posterior_chunk(model, q, cols, quad: bool):
    """(mean, tail quad) of one query chunk; the tail quad is None unless
    `quad`, and zero before any update.  The core kq is formed once for the
    mean and for s = kq A, the tail's share of the quad: the bordered
    factor's tail rows act on a query column as Lt^{-1} (kq2 - V^T W kq1),
    and V^T W kq1 = A^T kq1, so no second W stream is needed.  Unused slots
    are inert: zero kq2 columns, zero A columns and Lt's identity rows."""
    kq = _value_cross(model.kernel, q, cols, model.params)
    mean = kq @ model.alpha
    if not model.n_tail:
        return mean, (torch.zeros_like(mean) if quad else None)
    kq2 = tail_cross(model, q)
    mean = mean + kq2 @ model.tail_alpha
    if not quad:
        return mean, None
    tv = torch.linalg.solve_triangular(model.tail_chol, (kq2 - kq @ model.tail_a).T,
                                       upper=False)
    return mean, torch.sum(tv * tv, dim=0)


def _quad_band(name: str, q, cols, params, w_band, row0: int) -> torch.Tensor:
    """One panel's share ||W_j kq^T||^2 of every query's quad (Kernel F band
    mode, kq generated in-tile)."""
    gen = "joint" if cols.shape[1] == 7 else "value"
    return cuda_query.quad_band(gen, name, q, cols, params, w_band, row0)


def _chunks(q: torch.Tensor, chunk: int):
    return [q[i:i + chunk] for i in range(0, q.shape[0], chunk)]


def ooc_predict_mean(model: "OOCModel", q: torch.Tensor, *, chunk: int = 8192) -> torch.Tensor:
    """Posterior mean at q (M, 3), chunked: K(q, X) alpha, plus the touch
    tail's K(q, X_tail) alpha_tail after updates; no panel read."""
    q = q.to(model.dtype).contiguous()
    cols = _factor_cols(model)
    if q.shape[0] == 0:
        return q.new_zeros((0,))
    return torch.cat([_posterior_chunk(model, ch, cols, quad=False)[0]
                      for ch in _chunks(q, chunk)])


def ooc_predict(model: "OOCModel", q: torch.Tensor, *, chunk: int = 8192):
    """Posterior (mean, variance) at q (M, 3), chunked.  The W panels stream
    once in total: the panel loop is outermost and every chunk's quad adds
    the panel's share (after updates each chunk's quad starts at the touch
    tail's share).  The variance is clamped to [0, k0], as in the JAX
    package (W's rounding concentrates where the true variance is ~0)."""
    q = q.to(model.dtype).contiguous()
    if q.shape[0] == 0:
        return q.new_zeros((0,)), q.new_zeros((0,))
    cols = _factor_cols(model)
    chunks = _chunks(q, chunk)
    mean, quads = zip(*(_posterior_chunk(model, ch, cols, quad=True) for ch in chunks))
    mean = torch.cat(mean)
    nb = cols.shape[0] // model.panel
    for j, wj in _Prefetcher(model.wstore, range(nb)):
        for quad, ch in zip(quads, chunks):
            quad += _quad_band(model.kernel, ch, cols, model.params, wj, j * model.panel)
    k0 = float(kf.k_diag0(model.kernel, model.params))
    return mean, torch.clamp(k0 - torch.cat(quads), 0.0, k0)


# ----------------------------------------------------------------- models


@dataclasses.dataclass
class OOCModel:
    """Query handle of an out-of-core fit: the small state on the card, the
    W = L^{-1} panels in `wstore`.  `u` = L^{-1} y, kept from the fit, is
    what a tactile update needs, and with `logdiag_sum` what the marginal
    likelihood needs; the tail fields hold the updates' bordered block
    (`ooc_update`), in-core, with `alpha0` the fit's alpha."""

    kernel: str
    x: torch.Tensor  # (C, 3)
    y: torch.Tensor  # (C,)
    noise: torch.Tensor  # (C,), with the jitter the factor needed
    params: dict  # Python floats
    alpha: torch.Tensor  # (C,)
    wstore: object  # panel store of W's trimmed row panels
    panel: int
    n_real: int
    u: torch.Tensor | None = None  # L^{-1} y from the fit
    logdiag_sum: float | None = None  # sum(log diag L), from the fit
    alpha0: torch.Tensor | None = None  # the core alpha before the first update
    n_tail: int = 0
    tail_x: torch.Tensor | None = None  # (T, 3)
    tail_y: torch.Tensor | None = None  # (T,)
    tail_noise: torch.Tensor | None = None  # (T,)
    tail_v: torch.Tensor | None = None  # V = W K(X, X_tail), (C, T)
    tail_a: torch.Tensor | None = None  # A = W^T V = K^{-1} K(X, X_tail), (C, T)
    tail_chol: torch.Tensor | None = None  # Lt, identity on unused slots
    tail_alpha: torch.Tensor | None = None  # (T,)

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.x.dtype

    @property
    def device(self) -> torch.device:
        return self.x.device

    def predict(self, q, *, chunk: int = 8192):
        return ooc_predict(self, q, chunk=chunk)

    def update(self, new_x, new_y, new_noise, *, tail_capacity: int = 256):
        return ooc_update(self, new_x, new_y, new_noise, tail_capacity=tail_capacity)

    def log_marginal_likelihood(self) -> float:
        """Exact log p(y | X, theta) of the factored system from the fit's
        byproducts, ||u||^2 and sum(log diag L), plus the in-core touch
        tail's bordered block: O(C) work, no panel read.  The padding rows'
        0.5 log(2 pi noise) constants are taken out, as the dense MLL's
        n_real does; the stored noise includes the jitter the factor needed."""
        if self.u is None or self.logdiag_sum is None:
            raise ValueError(
                "this out-of-core fit predates the factorization MLL "
                "byproducts (u / logdiag_sum); refit with ooc_fit or "
                "ooc_factor_phase to enable log_marginal_likelihood"
            )
        u = self.u
        mll = (-0.5 * float(u @ u) - float(self.logdiag_sum)
               - 0.5 * u.shape[0] * math.log(2.0 * math.pi))
        mll += self._mll_pad_correction()
        if self.n_tail:
            # Bordered factor [[L, 0], [V^T, Lt]]: the tail adds
            # -0.5 ||u_t||^2 - sum(log diag Lt) - 0.5 T log 2 pi, with
            # u_t = Lt^T tail_alpha (unused slots: identity rows, zero alpha).
            ut = self.tail_chol.T @ self.tail_alpha
            mll += (-0.5 * float(ut @ ut)
                    - float(torch.sum(torch.log(torch.diagonal(self.tail_chol))))
                    - 0.5 * self.n_tail * math.log(2.0 * math.pi))
        return mll

    def _mll_pad_correction(self) -> float:
        """The padding rows' 0.5 log(2 pi noise) constants (rows [n_real, C))."""
        return float(torch.sum(0.5 * torch.log(2.0 * math.pi * self.noise[self.n_real:])))

    def promote_for_serving(self, *, reserve_bytes: int | None = None) -> int:
        """Pin spilled W panels into the device memory the finished fit freed
        and return the bytes promoted; `reserve_bytes` is kept free for the
        query working set (default two full-width panels and 1 GB).  No-op
        for a store without a spill tier."""
        if not isinstance(self.wstore, TieredPanelStore):
            return 0
        if reserve_bytes is None:
            # alpha's length is the factor size in both layouts (C, or J = 4C).
            reserve_bytes = 2 * self.panel * _nbytes(self.alpha) + 1_000_000_000
        budget = self.wstore._budget
        bonus = max(0, _device_limit(self.device) - int(reserve_bytes) - budget.limit)
        return self.wstore.promote(limit_bonus=bonus)


@dataclasses.dataclass
class OOCJointModel(OOCModel):
    """Out-of-core joint (value + gradient) model: config 2 beyond one
    matrix on the card.  The factor, TRSM and query are the value model's;
    only the columns differ.  Fields as in the JAX package:

        x (C, 3) core coordinates;  y (J,) joint targets [f | d1 | d2 | d3];
        noise (C,) value noise;  meta (J, 7) packed factor-row metadata.
    """

    meta: torch.Tensor | None = None  # (J, 7)
    normals: torch.Tensor | None = None  # (C, 3) unit normals (zero pad rows)
    noise_g: torch.Tensor | None = None  # (C,) gradient noise
    n0: int = 0  # core capacity C

    def _mll_pad_correction(self) -> float:
        """A padded point is one value row and three gradient rows: all four
        constants come out."""
        return float(torch.sum(0.5 * torch.log(2.0 * math.pi * self.noise[self.n_real:]))
                     + 3.0 * torch.sum(0.5 * torch.log(2.0 * math.pi
                                                       * self.noise_g[self.n_real:])))


def ooc_update(model: OOCModel, new_x, new_y, new_noise, *,
               tail_capacity: int = 256) -> OOCModel:
    """Tactile bordering update of an out-of-core fit; the panel store is
    never rewritten.  The bordered factor is [[L, 0], [V^T, Lt]] with
    V = W K(X, X_new) and Lt = chol(K_new + diag(noise) - V^T V) (bordered
    in turn against the earlier batches' slots).  One pass over the W panels
    forms V's new columns and A = W^T V's, each panel at its own trimmed
    width.  Then, with u = L^{-1} y from the fit,

        u_t = Lt^{-1} (y_tail - V^T u),  alpha_t = Lt^{-T} u_t,
        alpha = alpha0 - A alpha_t.

    The noise is floored at 4 eps C k(0); the tail holds `tail_capacity`
    slots (fixed by the first update) and overflow raises.  Returns a new
    model."""
    if model.u is None:
        raise ValueError(
            "this out-of-core fit predates the stored forward-substitution "
            "vector u; refit (ooc_fit / ooc_factor_phase) to enable updates"
        )
    dt, dev = model.dtype, model.device
    new_x = torch.as_tensor(new_x).to(dtype=dt, device=dev).contiguous()
    t = new_x.shape[0]
    new_y = torch.as_tensor(new_y, dtype=dt, device=dev).broadcast_to((t,))
    # Floored like every other update: a touch that repeats an observation
    # leaves a Schur complement of ~ noise + O(eps), and below the floor
    # the tail's Cholesky fails in float32.
    floor = (4.0 * torch.finfo(dt).eps * model.alpha.shape[0]
             * abs(float(kf.k_diag0(model.kernel, model.params))))
    new_noise = torch.clamp(torch.as_tensor(new_noise, dtype=dt, device=dev).broadcast_to((t,)),
                            min=floor)
    # The JAX package refuses here a W store with spill-compressed (f16)
    # panels, whose rounding the mean's correction would amplify.  The port
    # has no such store: ooc_fit refuses w_dtype (ROADMAP.md §1 item 15).
    occ = int(model.n_tail)
    cap = int(tail_capacity if model.tail_v is None else model.tail_v.shape[1])
    if occ + t > cap:
        raise ValueError(
            f"touch tail is full ({occ}+{t} > capacity {cap}); fold the "
            f"tail into a refit (session.update does this automatically "
            f"for in-core models) or raise tail_capacity"
        )
    cols = _factor_cols(model)
    c = cols.shape[0]
    if model.tail_v is None:
        tail_x = torch.zeros((cap, 3), dtype=dt, device=dev)
        tail_y = torch.zeros((cap,), dtype=dt, device=dev)
        tail_noise = torch.ones((cap,), dtype=dt, device=dev)
        tail_v = torch.zeros((c, cap), dtype=dt, device=dev)
        tail_a = torch.zeros((c, cap), dtype=dt, device=dev)
        tail_chol = torch.eye(cap, dtype=dt, device=dev)
    else:
        tail_x, tail_y, tail_noise = (model.tail_x.clone(), model.tail_y.clone(),
                                      model.tail_noise.clone())
        tail_v, tail_a, tail_chol = (model.tail_v.clone(), model.tail_a.clone(),
                                     model.tail_chol.clone())
    alpha0 = model.alpha0 if model.alpha0 is not None else model.alpha

    # One pass over the W panels.  The factor rows' cross K(rows, x_new) is
    # the value query's cross transposed, for value and joint columns alike.
    k_n = _value_cross(model.kernel, new_x, cols, model.params).T  # (C, t)
    v_new = torch.zeros((c, t), dtype=dt, device=dev)
    a_new = torch.zeros((c, t), dtype=dt, device=dev)
    for j, wj in _Prefetcher(model.wstore, range(c // model.panel)):
        w = wj.shape[1]  # the stored panel's own width: columns beyond it are zero
        g = wj @ k_n[:w]  # (panel, t)
        v_new[j * model.panel:(j + 1) * model.panel] = g
        a_new[:w] += wj.T @ g

    # The tail's Schur bordering, over the occupied slots only.
    s22 = kg.gram_reference(model.kernel, new_x, model.params, noise=new_noise) - v_new.T @ v_new
    if occ:
        s21 = (kg.cross_cov(model.kernel, new_x, tail_x[:occ], model.params)
               - v_new.T @ tail_v[:, :occ])
        b21 = torch.linalg.solve_triangular(tail_chol[:occ, :occ], s21.T, upper=False).T
        s22 = s22 - b21 @ b21.T
        tail_chol[occ:occ + t, :occ] = b21
    l22 = lin.cholesky(s22)
    if bool(torch.isnan(l22).any()):
        raise FloatingPointError(
            "tail bordering Cholesky produced NaN — touch noise too small "
            "for this dtype; raise noise_touch"
        )
    occ2 = occ + t
    tail_chol[occ:occ2, occ:occ2] = l22
    tail_x[occ:occ2] = new_x
    tail_y[occ:occ2] = new_y
    tail_noise[occ:occ2] = new_noise
    tail_v[:, occ:occ2] = v_new
    tail_a[:, occ:occ2] = a_new

    # The posterior weights of the bordered factor.
    lt = tail_chol[:occ2, :occ2]
    u_t = torch.linalg.solve_triangular(
        lt, (tail_y[:occ2] - tail_v[:, :occ2].T @ model.u)[:, None], upper=False)
    z = torch.linalg.solve_triangular(lt.T, u_t, upper=True)[:, 0]
    tail_alpha = torch.zeros((cap,), dtype=dt, device=dev)
    tail_alpha[:occ2] = z
    return dataclasses.replace(
        model, alpha=alpha0 - tail_a[:, :occ2] @ z, alpha0=alpha0, n_tail=occ2, tail_x=tail_x,
        tail_y=tail_y, tail_noise=tail_noise, tail_v=tail_v, tail_a=tail_a,
        tail_chol=tail_chol, tail_alpha=tail_alpha)


def ooc_residual_check(model, **kwargs):
    not_ported("ooc_residual_check (the int16 L codec's guard)", 15, "out-of-core")


def ooc_factor_phase(*args, **kwargs):
    not_ported("ooc_factor_phase (the process-split fit)", 15, "out-of-core")


def ooc_solve_phase(*args, **kwargs):
    not_ported("ooc_solve_phase (the process-split fit)", 15, "out-of-core")


def plan_sweeps(*args, **kwargs):
    not_ported("plan_sweeps", 15, "out-of-core")


# ------------------------------------------------------------------- fits


def _device_limit(device, default: int = 15_500_000_000) -> int:
    """Bytes this process's allocator can hold on the card: what is free
    plus what it has cached.  `default` off the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return default
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device)


def _hbm_budget(panel: int, c: int, itemsize: int, device) -> int:
    """Device bytes left to the tiered stores: the limit minus the row-band
    working set -- the widest (sweep B, C) band of the factor or the TRSM's
    (its band and U), two prefetched panels, the transients of a step -- and
    0.5 GB (the JAX package's reserve)."""
    sweep = max(SWEEP, TRSM_SWEEP + 1)
    reserve = int((sweep + 4.5) * panel * c * itemsize) + 500_000_000
    return max(_device_limit(device) - reserve, 0)


def _padded(v, fill: float, shape, like: torch.Tensor) -> torch.Tensor:
    out = torch.full(shape, fill, dtype=like.dtype, device=like.device)
    n = like.shape[0]
    out[:n] = torch.as_tensor(v, dtype=like.dtype, device=like.device).broadcast_to(
        (n,) + tuple(shape[1:]))
    return out


def _pad_problem(kernel: str, x, y, noise, params, *, panel: int, pad_noise: float):
    """Pad (x, y, noise) to a panel multiple with inert high-noise rows at
    the origin; returns (xp, yp, noisep, params, c, n, jitter)."""
    n = x.shape[0]
    c = round_up(n, panel)
    params = {k: float(v) for k, v in params.items()}
    jitter = 4.0 * torch.finfo(x.dtype).eps * c * abs(float(kf.k_diag0(kernel, params)))
    return (_padded(x, 0.0, (c, 3), x), _padded(y, 0.0, (c,), x),
            _padded(noise, pad_noise, (c,), x), params, c, n, jitter)


def _pad_joint_problem(kernel: str, x, y, normals, noise_f, noise_g, params, *, panel: int,
                       pad_noise: float):
    """Pad a problem with normals so that J = 4C is a panel multiple (C to a
    multiple of panel / 4) and pack its factor metadata.  Returns
    (xp, yj, meta, nrm, nf, ng, params, c, n, jitter)."""
    if not kf.supports_derivatives(kernel):
        raise ValueError(f"kernel {kernel!r} does not support derivative observations")
    if panel % 4:
        raise ValueError(f"joint out-of-core needs panel % 4 == 0 (J = 4C must be a "
                         f"panel multiple), got {panel}")
    n = x.shape[0]
    c = round_up(n, max(panel // 4, 1))
    xp = _padded(x, 0.0, (c, 3), x)
    yp = _padded(y, 0.0, (c,), x)
    nrm = _padded(normals, 0.0, (c, 3), x)
    nf = _padded(noise_f, pad_noise, (c,), x)
    ng = _padded(noise_g, pad_noise, (c,), x)
    params = {k: float(v) for k, v in params.items()}
    meta = cuda_joint.pack_meta(cuda_joint.joint_meta(xp))
    jitter = 4.0 * torch.finfo(x.dtype).eps * 4 * c * abs(float(kf.k_diag0(kernel, params)))
    return xp, kd.joint_targets(yp, nrm), meta, nrm, nf, ng, params, c, n, jitter


def _factor_with_jitter(kernel, cols, noise, params, budget, *, panel, block, store, y,
                        jitter):
    """The NaN-escalation jitter ladder around `ooc_cholesky`.  Returns
    (store, u, logdiag_sum, extra), extra the jitter added to the factor's
    diagonal, which the caller folds into its stored noises."""
    extra = 0.0
    for _ in range(MAX_JITTER_RETRIES + 1):
        st = _make_store(store, budget, cols.device)
        stats: dict = {}
        ok, u = ooc_cholesky(kernel, cols, noise + extra, params, st, panel=panel, block=block,
                             sweep=SWEEP, y=y, stats=stats)
        if ok:
            return st, u, stats["logdiag_sum"], extra
        st.clear()
        del st
        extra = max(extra * 10.0, jitter)
    raise FloatingPointError(f"out-of-core Cholesky failed even with jitter {extra:.2e}")


def _refuse_unported_spill(w_dtype, spill_dir, l_codec) -> None:
    if w_dtype is not None:
        not_ported("w_dtype (the f16 W spill)", 15, "out-of-core")
    if spill_dir is not None:
        not_ported("spill_dir (the disk spill)", 15, "out-of-core")
    if l_codec is not None:
        not_ported("l_codec (the int16 L codec)", 15, "out-of-core")


def _fit_budget(device_budget, panel: int, j: int, x: torch.Tensor) -> DeviceBudget:
    if device_budget is not None:
        return DeviceBudget(device_budget)
    return DeviceBudget(_hbm_budget(panel, j, x.element_size(), x.device))


def ooc_fit(kernel: str, x, y, noise, params, *, panel: int, block: int = 256,
            store: str = "tiered", pad_noise: float = 1e10, device_budget: int | None = None,
            w_dtype=None, spill_dir: str | None = None, l_codec: str | None = None) -> OOCModel:
    """Out-of-core GP fit in x's dtype on x's device: pad to a panel
    multiple, factor with the NaN-escalation jitter ladder, alpha by
    substitution against L, then the TRSM.  `store` = "tiered" (the card up
    to `device_budget` bytes, by default all the card can spare, then host
    RAM), "host" or "device"."""
    _refuse_unported_spill(w_dtype, spill_dir, l_codec)
    xp, yp, noisep, params, c, n, jitter = _pad_problem(kernel, x, y, noise, params,
                                                        panel=panel, pad_noise=pad_noise)
    budget = _fit_budget(device_budget, panel, c, xp)
    st, u, logdiag, extra = _factor_with_jitter(kernel, xp, noisep, params, budget, panel=panel,
                                                block=block, store=store, y=yp, jitter=jitter)
    alpha = ooc_alpha_backward(st, u, panel=panel)
    wstore = _make_store(store, budget, xp.device)
    ooc_trsm(st, wstore, yp, panel=panel, block=block, accumulate_alpha=False, sweep=TRSM_SWEEP)
    return OOCModel(kernel=kernel, x=xp, y=yp, noise=noisep + extra, params=params, alpha=alpha,
                    wstore=wstore, panel=panel, n_real=n, u=u, logdiag_sum=logdiag)


def ooc_fit_joint(kernel: str, x, y, normals, noise_f, noise_g, params, *, panel: int,
                  block: int = 256, store: str = "tiered", pad_noise: float = 1e10,
                  device_budget: int | None = None, w_dtype=None, spill_dir: str | None = None,
                  l_codec: str | None = None) -> OOCJointModel:
    """Out-of-core joint (value + gradient) fit: J = 4C factor rows for C
    padded points, in the dimension-major layout [f | d1 | d2 | d3]; the
    same factor, TRSM and alpha as `ooc_fit`, on packed joint metadata."""
    _refuse_unported_spill(w_dtype, spill_dir, l_codec)
    (xp, yj, meta, nrm, nf, ng, params, c, n,
     jitter) = _pad_joint_problem(kernel, x, y, normals, noise_f, noise_g, params, panel=panel,
                                  pad_noise=pad_noise)
    j_tot = 4 * c
    budget = _fit_budget(device_budget, panel, j_tot, xp)
    noisej = cuda_joint.joint_noise(c, nf, ng, None, xp)
    st, u, logdiag, extra = _factor_with_jitter(kernel, meta, noisej, params, budget,
                                                panel=panel, block=block, store=store, y=yj,
                                                jitter=jitter)
    alpha = ooc_alpha_backward(st, u, panel=panel)
    wstore = _make_store(store, budget, xp.device)
    ooc_trsm(st, wstore, yj, panel=panel, block=block, accumulate_alpha=False, sweep=TRSM_SWEEP)
    return OOCJointModel(kernel=kernel, x=xp, y=yj, noise=nf + extra, params=params,
                         alpha=alpha, wstore=wstore, panel=panel, n_real=n, u=u,
                         logdiag_sum=logdiag, meta=meta, normals=nrm, noise_g=ng + extra, n0=c)
