"""Out-of-core GP fit and query on one card (port of gpis_tpu/linalg/outofcore.py).

The single-device path for clouds whose one-matrix factor does not fit on the
card: the Cholesky factor L and then W = L^{-1} live OUT OF CORE as trimmed
row panels (panel j = rows [jB, (j+1)B) x columns [0, w_j), w_j >= (j+1)B,
the only structurally nonzero part) in a panel store:

* `DevicePanelStore` -- every panel in device memory (~0.56 C^2 floats
  instead of C^2, and W_j takes L_j's place as the TRSM consumes L);
* `HostPanelStore` -- every panel in pinned host RAM, streamed per use;
* `TieredPanelStore` -- device memory up to a byte budget (`DeviceBudget`,
  shared by the L and W stores of one fit), host RAM beyond it, or with
  `spill_dir` files on disk (`_DiskPanel`, read back through a memmap);
  `promote` pins spilled panels back on the card for serving.  A store on
  disk persists through `save_manifest` and reattaches in another process
  through `open_dir`: `utils.checkpoint` writes an out-of-core model's W
  this way (`put_host`, a zero-budget store) under `path + ".w/"`.  Its
  options: a float16 W (`spill_dtype`, `device_dtype`; `ooc_update`
  refuses such a model), the blockwise int16 L codec (`spill_codec`,
  guarded by `ooc_residual_check`) and the `write_through` mirror.

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
  slices, the CPU-device d2h staging and the warm-up of the link's first
  d2h.  `TRAFFIC` counts the bytes moved each way, nothing more.

Two phases (`ooc_factor_phase`, `ooc_solve_phase`) split a fit at the
factor: each runs in its own process if the caller wants, and each resumes
after a crash from its last stored sweep (the factor from a progress
checkpoint over a write-through L store, the TRSM from its W prefix).  The
solve phase can fuse a grid query into the TRSM (Kernel F's band mode on
each W band while it is on the card).  `plan_sweeps` picks the sweeps that
minimize the modelled refetch traffic.

Functions take tensors and work on the device the tensors are on; on the
CPU every kernel call takes its plain twin.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import math
import os

import numpy as np
import torch

from gpis_tpu_torch._build import resolve_device
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
           "tail_cross", "ooc_solve_alpha", "ooc_residual_check", "ooc_factor_phase",
           "ooc_solve_phase", "plan_sweeps"]

# Bytes moved between host RAM and the card by the panel stores, each way
# ("h2d_bytes", "d2h_bytes").
TRAFFIC: collections.Counter = collections.Counter()

# Retries of the NaN-escalation jitter ladder before a fit gives up.
MAX_JITTER_RETRIES = 3


# ------------------------------------------------- int16 panel codec
#
# Stored L panels are most of an out-of-core fit's host traffic (each is
# fetched once a sweep by the factor, once more by the TRSM).  float16 is
# unsafe for L: its RELATIVE rounding (~5e-4) feeds later Schur complements,
# amplified by cond(K), and the JAX package measured it breaking the
# posterior mean.  Blockwise int16 moves the same 2 bytes an element with
# an ABSOLUTE bound: q = round(x / s), one float32 scale s per (row,
# 512-column block), so |L~ - L| <= blockmax * 2^-15.  Every consumer reads
# the panels through the store, so the factor in play is one consistent
# perturbed L~; `ooc_residual_check` guards the fits that use it.

_QBLOCK = 512


def _qpack(arr: torch.Tensor, *, block: int = _QBLOCK):
    """(B, W) float -> (q int16 (B, W padded to a block multiple), scales
    float32 (B, ceil(W / block))), on arr's device, so the device-to-host
    copy already moves 2-byte elements."""
    b, w = arr.shape
    nb = -(-w // block)
    ap = torch.nn.functional.pad(arr, (0, nb * block - w)).reshape(b, nb, block)
    amax = ap.abs().amax(dim=2)
    scale = torch.clamp(amax, min=torch.finfo(arr.dtype).tiny) / 32767.0
    q = torch.round(ap / scale[:, :, None]).to(torch.int16)
    return q.reshape(b, nb * block), scale.to(torch.float32)


def _qunpack(q: torch.Tensor, scale: torch.Tensor, *, w: int, dtype) -> torch.Tensor:
    """The inverse of `_qpack`, on q's device after the 2-byte copy."""
    b, wp = q.shape
    nb = scale.shape[1]
    x = q.to(dtype).reshape(b, nb, wp // nb) * scale[:, :, None].to(dtype)
    return x.reshape(b, wp)[:, :w]


class _QuantDisk:
    """An int16-coded panel on disk: `path` holds q (int16, the width padded
    to a _QBLOCK multiple), `path + ".scale"` the float32 scales.  Its
    `dtype` is int16, which `has_compressed_panels` counts."""

    __slots__ = ("path", "shape", "scale_shape", "width", "orig_dtype")
    codec = "int16"

    def __init__(self, path: str, shape, scale_shape, width: int, orig_dtype):
        self.path, self.shape, self.scale_shape = path, tuple(shape), tuple(scale_shape)
        self.width, self.orig_dtype = int(width), np.dtype(orig_dtype)

    @property
    def dtype(self):
        return np.dtype(np.int16)

    def read(self):
        q = np.memmap(self.path, dtype=np.int16, mode="r", shape=self.shape)
        s = np.memmap(self.path + ".scale", dtype=np.float32, mode="r", shape=self.scale_shape)
        return q, s


class _QuantHost:
    """Host-RAM twin of `_QuantDisk` (a tiered store without a spill_dir)."""

    __slots__ = ("q", "scale", "width", "orig_dtype")
    codec = "int16"

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, width: int, orig_dtype):
        self.q, self.scale, self.width = q, scale, int(width)
        self.orig_dtype = orig_dtype

    @property
    def dtype(self):
        return np.dtype(np.int16)

    def read(self):
        return self.q, self.scale


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


class _DiskPanel:
    """A panel in a file of a store's spill directory, read back through a
    memmap: file-backed pages sit in the page cache, evictable, not in the
    process's anonymous memory."""

    __slots__ = ("path", "shape", "dtype")

    def __init__(self, path: str, shape, dtype):
        self.path, self.shape, self.dtype = path, tuple(shape), np.dtype(dtype)

    def read(self) -> np.memmap:
        return np.memmap(self.path, dtype=self.dtype, mode="r", shape=self.shape)

    def tensor(self) -> torch.Tensor:
        """The panel as a CPU tensor over a private (copy-on-write) mapping
        of its file."""
        return torch.from_numpy(np.memmap(self.path, dtype=self.dtype, mode="c",
                                          shape=self.shape))


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


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


def _np_dtype(dtype) -> np.dtype:
    """NumPy dtype of a torch dtype, a NumPy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).removeprefix("torch."))
    return np.dtype(dtype)


def _torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, _np_dtype(dtype).name)


def _unlink_panel(path: str) -> None:
    """A panel file and its codec scales, where there are."""
    _unlink(path)
    _unlink(path + ".scale")


class TieredPanelStore(_PanelStore):
    """Panels stay on the card while the shared budget lasts, then spill to
    pinned host RAM, or with `spill_dir` to one file a panel,
    `spill_dir/panel_<j>.bin` (budget first: the earliest panels, which the
    left-looking loops read most, stay resident).  `tag` names the problem
    the panels belong to; the manifest keeps it, and `open_dir` can demand
    it.

    * `spill_dtype` (float16) narrows SPILLED panels, on the card before
      their copy; `device_dtype` narrows the resident ones.  For W only:
      the narrowing touches the variance quad, which `ooc_fit` keeps away
      from the mean by solving alpha against L.  Never for L: its relative
      rounding is amplified by cond(K) through later Schur complements.
    * `spill_codec="int16"` spills panels in the blockwise int16 codec
      (`_qpack`, the measured-safe 2-byte form for L).
    * `write_through` mirrors every panel, resident ones included, to its
      file when it is stored, so that the store is durable at any moment
      (the resumable factor and solve phases checkpoint on it); a resident
      panel costs one more device-to-host copy.

    A fetch (`_fetch`) widens a narrowed panel back to `compute_dtype` and
    decodes a coded one."""

    def __init__(self, budget: DeviceBudget, device="cuda", *, spill_dtype=None,
                 device_dtype=None, spill_dir: str | None = None, write_through: bool = False,
                 tag: str | None = None, spill_codec: str | None = None):
        super().__init__(device)
        if spill_codec not in (None, "int16"):
            raise ValueError(f"unknown spill_codec {spill_codec!r}")
        if spill_codec is not None and spill_dtype is not None:
            raise ValueError("spill_codec and spill_dtype are exclusive")
        self._budget = budget
        self._spill_dir = spill_dir
        self._spill_dtype = None if spill_dtype is None else _torch_dtype(spill_dtype)
        self._device_dtype = None if device_dtype is None else _torch_dtype(device_dtype)
        self._spill_codec = spill_codec
        self._write_through = bool(write_through and spill_dir)
        self.tag = tag
        self.compute_dtype: torch.dtype | None = None
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
        self._meta: dict[int, tuple[bool, int]] = {}  # j -> (on the card, bytes)

    def _panel_path(self, j: int) -> str:
        return os.path.join(self._spill_dir, f"panel_{j}.bin")

    def _coded(self, arr: torch.Tensor) -> bool:
        return self._spill_codec == "int16" and arr.is_floating_point()

    def _narrow(self, arr: torch.Tensor) -> torch.Tensor:
        sd = self._spill_dtype
        return arr.to(sd) if sd is not None and arr.dtype != sd else arr

    def _to_disk(self, j: int, arr: torch.Tensor):
        """Write panel j to its file, coded or narrowed on the card first."""
        if self._coded(arr):
            q, sc = _qpack(arr)
            qh, sh = _d2h(q, None)[0].numpy(), _d2h(sc, None)[0].numpy()
            path = self._panel_path(j)
            _write_file(path, qh)
            _write_file(path + ".scale", sh)
            return _QuantDisk(path, qh.shape, sh.shape, arr.shape[1], _np_dtype(arr.dtype))
        return self._write(j, _d2h(self._narrow(arr), None)[0].numpy())

    def _store(self, j, arr, stream):
        self.compute_dtype = arr.dtype
        if self._device_dtype is not None and arr.dtype != self._device_dtype:
            arr = arr.to(self._device_dtype)
        size = _nbytes(arr)
        on_dev = self._budget.take(size)
        self._meta[j] = (on_dev, size)
        if on_dev:
            if self._write_through:
                self._to_disk(j, arr)
            return _compact_copy(arr)
        if self._spill_dir is not None:
            return self._to_disk(j, arr)
        if self._coded(arr):
            q, sc = _qpack(arr)
            return _QuantHost(_d2h(q, None)[0], _d2h(sc, None)[0], arr.shape[1], arr.dtype)
        host, self._ready[j] = _d2h(self._narrow(arr), stream)
        return host

    def _write(self, j: int, arr: np.ndarray) -> _DiskPanel:
        path = self._panel_path(j)
        _write_file(path, arr)
        return _DiskPanel(path, arr.shape, arr.dtype)

    def put_host(self, j: int, arr) -> None:
        """Write a host array (NumPy, or a CPU tensor) straight to the disk
        tier at its own dtype, no device round trip: the checkpoint writer
        persists W this way, leaving the file layout and the manifest to
        this class."""
        if self._spill_dir is None:
            raise ValueError("put_host needs a spill_dir-backed store")
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        self.free(j)
        self._p[j] = self._write(j, np.asarray(arr))
        self._meta[j] = (False, 0)

    def free(self, j: int) -> None:
        """Drop panel j; a panel on disk, or a resident one mirrored there,
        loses its file."""
        on_dev, size = self._meta.pop(j, (False, 0))
        if on_dev:
            self._budget.give(size)
        v = self._p.get(j)
        if isinstance(v, (_DiskPanel, _QuantDisk)):
            _unlink_panel(v.path)
        elif on_dev and self._write_through:
            _unlink_panel(self._panel_path(j))
        super().free(j)

    def clear(self) -> None:
        """Free every panel and the manifest: a manifest left behind would
        make a later `open_dir` claim panels whose files are gone."""
        super().clear()
        if self._spill_dir is not None:
            _unlink(os.path.join(self._spill_dir, "manifest.json"))

    def has_compressed_panels(self) -> bool:
        """Whether a stored panel is narrower than the compute dtype: the
        configured spill dtype is not enough, since a store reattached by
        `open_dir` serves whatever its manifest holds, and `promote` pins
        panels at their stored dtype (`ooc_update` refuses both)."""
        if self.compute_dtype is None:
            return False
        width = torch.finfo(self.compute_dtype).bits // 8
        return any(np.dtype(v.dtype).itemsize < width if not isinstance(v, torch.Tensor)
                   else v.element_size() < width for v in self._p.values())

    def _mirror(self, j: int, arr: torch.Tensor):
        """The disk handle of resident panel j's write-through file."""
        path = self._panel_path(j)
        if self._coded(arr):
            b, w = arr.shape
            nblk = -(-w // _QBLOCK)
            return _QuantDisk(path, (b, nblk * _QBLOCK), (b, nblk), w, _np_dtype(arr.dtype))
        return _DiskPanel(path, arr.shape, _np_dtype(self._narrow(arr[:0]).dtype))

    def evict_all(self) -> None:
        """Move every resident panel to the spill tier (its file when the
        store has a spill_dir), so that the store persists across a process
        boundary (`save_manifest`, `open_dir`).  A write-through panel's
        file exists already: only its handle changes."""
        keys = [j for j, (on_dev, _) in self._meta.items() if on_dev]
        old_limit, self._budget.limit = self._budget.limit, 0
        cd = self.compute_dtype
        try:
            for j in keys:
                arr = self._p.pop(j)
                self._budget.give(self._meta.pop(j)[1])
                if self._write_through:
                    self._p[j] = self._mirror(j, arr)
                    self._meta[j] = (False, 0)
                else:
                    self.put(j, arr)  # limit 0: to the spill tier, synchronously
                    self.compute_dtype = cd  # put() read a narrowed panel's dtype
                del arr
        finally:
            self._budget.limit = old_limit

    def save_manifest(self) -> None:
        """Write the panels' shapes and dtypes (and a coded panel's codec
        entry), the compute dtype and the tag beside the panel files, so
        that `open_dir` reattaches the store in another process.  Every
        panel must be on disk, or mirrored there by write_through.  The
        manifest is replaced atomically: a kill mid-write leaves the old one
        whole."""
        meta = {}
        for j, v in self._p.items():
            if self._write_through and self._meta.get(j, (False, 0))[0]:
                v = self._mirror(j, v)
            if isinstance(v, _QuantDisk):
                meta[str(j)] = [list(v.shape), "int16", {
                    "codec": "int16", "scale_shape": list(v.scale_shape), "width": v.width,
                    "orig_dtype": str(v.orig_dtype)}]
            elif isinstance(v, _DiskPanel):
                meta[str(j)] = [list(v.shape), str(v.dtype)]
            else:
                raise ValueError(f"panel {j} is not on disk")
        # The dtype's NumPy name ("float32"), which the JAX package writes.
        doc = {"panels": meta, "compute_dtype": str(_np_dtype(self.compute_dtype))}
        if self.tag is not None:
            doc["tag"] = self.tag
        path = os.path.join(self._spill_dir, "manifest.json")
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)

    def spilled(self) -> list[int]:
        """Indices of the panels held off the card (host RAM or disk)."""
        return sorted(j for j, (on_dev, _) in self._meta.items() if not on_dev)

    def promote(self, limit_bonus: int = 0) -> int:
        """Move spilled panels back onto the card (serving mode), in
        ascending order, until the budget (raised by `limit_bonus`) refuses;
        returns the bytes promoted.  After a fit its working set is gone, and
        a session that queries again and again would otherwise stream every
        spilled panel on every query.  Panels keep their stored dtype (a
        narrowed W stays narrow on the card, widened at each fetch); coded
        panels, an L-store form that no serving model holds, stay put."""
        self._budget.limit += int(limit_bonus)
        promoted = 0
        for j in self.spilled():
            v = self._p[j]
            if isinstance(v, (_QuantDisk, _QuantHost)):
                continue
            disk = isinstance(v, _DiskPanel)
            size = int(np.prod(v.shape)) * v.dtype.itemsize if disk else _nbytes(v)
            if not self._budget.take(size):
                break
            done = self._ready.pop(j, None)
            if done is not None:
                done.synchronize()
            # A panel on disk is copied off its file, which stays: the
            # files of a store reopened from a checkpoint are the checkpoint.
            self._p[j] = v.tensor().to(self.device, copy=True) if disk else v.to(self.device)
            if self.device.type == "cuda":
                TRAFFIC["h2d_bytes"] += size
            self._meta[j] = (True, size)
            if not disk and self._write_through:
                self._write(j, v.numpy())
            promoted += size
        return promoted

    @classmethod
    def open_dir(cls, budget: DeviceBudget, spill_dir: str, expect_tag: str | None = None,
                 **kw):
        """Reattach a store that `save_manifest` persisted (a fresh process;
        `kw` go to the constructor, `device` among them).  Entries whose
        panel file (or a coded panel's scales) is missing are skipped:
        `free` and `clear` unlink files, and a manifest written before
        cannot serve what is gone.  With `expect_tag`, a manifest of another
        tag raises ValueError: those panels belong to another problem."""
        st = cls(budget, spill_dir=spill_dir, **kw)
        with open(os.path.join(spill_dir, "manifest.json")) as f:
            doc = json.load(f)
        if expect_tag is not None and doc.get("tag") != expect_tag:
            raise ValueError(f"panel store at {spill_dir} was written for a different problem "
                             f"(tag {doc.get('tag')!r} != expected {expect_tag!r})")
        st.tag = doc.get("tag")
        st.compute_dtype = getattr(torch, doc["compute_dtype"])
        for j, entry in doc["panels"].items():
            shape, dt = entry[0], entry[1]
            path = st._panel_path(int(j))
            if not os.path.exists(path):
                continue
            if len(entry) > 2 and entry[2].get("codec") == "int16":
                if not os.path.exists(path + ".scale"):
                    continue
                q = entry[2]
                st._p[int(j)] = _QuantDisk(path, shape, q["scale_shape"], q["width"],
                                           q["orig_dtype"])
            else:
                st._p[int(j)] = _DiskPanel(path, shape, dt)
            st._meta[int(j)] = (False, 0)
        return st


def _write_file(path: str, arr: np.ndarray) -> None:
    mm = np.memmap(path, dtype=arr.dtype, mode="w+", shape=arr.shape)
    mm[:] = arr
    mm.flush()
    del mm


def _make_store(kind: str, budget: DeviceBudget, device, spill_dir: str | None = None, *,
                spill_dtype=None, device_dtype=None, spill_codec: str | None = None):
    if kind == "host":
        return HostPanelStore(device)
    if kind == "device":
        return DevicePanelStore(device)
    if kind == "tiered":
        return TieredPanelStore(budget, device, spill_dir=spill_dir, spill_dtype=spill_dtype,
                                device_dtype=device_dtype, spill_codec=spill_codec)
    raise ValueError(f"unknown panel store kind {kind!r}")


# ------------------------------------------------------- pipeline helpers


def _fetch(store: _PanelStore, j: int, stream=None):
    """Stored panel j on the store's device, at its trimmed width and the
    store's compute dtype (a narrowed panel widened, a coded one decoded,
    both on the card after the narrow copy), and the event its copy ends at
    (None when no copy was made, or the copy was synchronous).  A host panel
    is copied on `stream` when one is given, after its own device-to-host
    copy, if still pending, has ended."""
    v = store.get(j)
    cd = getattr(store, "compute_dtype", None)
    dev = store.device
    if isinstance(v, (_QuantDisk, _QuantHost)):
        q, sc = v.read()
        parts = [a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
                 for a in (q, sc)]
        width, dtype = v.width, cd or _torch_dtype(v.orig_dtype)
    else:
        parts = [v.tensor() if isinstance(v, _DiskPanel) else v]
        width, dtype = None, cd

    def finish(ts):
        out = _qunpack(*ts, w=width, dtype=dtype) if width is not None else ts[0]
        return out if dtype is None or out.dtype == dtype else out.to(dtype)

    if parts[0].device == dev:
        return finish(parts), None
    TRAFFIC["h2d_bytes"] += sum(_nbytes(t) for t in parts)
    pending = store.ready_event(j)
    if stream is None:
        if pending is not None:
            pending.synchronize()
        return finish([t.to(dev) for t in parts]), None
    with torch.cuda.stream(stream):
        if pending is not None:
            stream.wait_event(pending)
        out = finish([t.to(dev, non_blocking=True) for t in parts])
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


def _store_width(j: int, panel: int, c: int, quant: int = 2) -> int:
    """Trimmed width of stored panel j: its true width (j+1)B rounded up to
    a multiple of `quant` panels, at most C (the JAX package's rule, so both
    store the same shapes)."""
    return min(((j + quant) // quant) * quant * panel, c)


# ----------------------------------------------------------------- phases


def ooc_cholesky(kernel: str, x: torch.Tensor, noisep: torch.Tensor, params, store, *,
                 panel: int, block: int = 256, width_quant: int = 2, sweep: int = 1,
                 y: torch.Tensor | None = None, start_panel: int = 0, u0=None, progress_cb=None,
                 end_panel: int | None = None, logdiag0: float = 0.0,
                 stats: dict | None = None):
    """Row-panel bordering Cholesky of K(x) + diag(noisep) into `store`
    (trimmed panels at widths quantized to `width_quant` panels, zero past
    their true width).  x is (C, 3) points or (J, 7) packed joint metadata.
    Returns (ok, u): ok False if the factor came back NaN (the caller
    escalates jitter); with y, u = L^{-1} y, taken inline from each band
    while it is on the card.  `sweep` row panels form one band, so each
    stored panel is fetched once a sweep.  With `stats`,
    stats["logdiag_sum"] holds logdiag0 + sum(log diag L) over the panels
    factored so far, after every sweep.

    Resumable: `start_panel` and `u0` continue a factor whose panels
    [0, start_panel) are in the store already (a write-through store
    reattached by `open_dir`); `progress_cb(next_j, u)` is called after each
    sweep once its panels are stored, for the caller to checkpoint;
    `end_panel` stops after panels [start_panel, end_panel), and u then
    covers the rows below end_panel * panel only."""
    c = x.shape[0]
    if c % panel:
        raise ValueError(f"capacity {c} must be a multiple of panel {panel}")
    nb = c // panel
    nb_stop = nb if end_panel is None else min(int(end_panel), nb)
    writer = _AsyncWriter(store)
    if u0 is not None:
        u = torch.as_tensor(u0, dtype=x.dtype, device=x.device).clone()
    else:
        u = None if y is None else torch.zeros_like(y)
    logdiag = float(logdiag0)
    j = int(start_panel)
    while j < nb_stop:
        r = min(max(int(sweep), 1), nb_stop - j)
        j0, rows = j * panel, r * panel
        cur = _gram_band(kernel, x, noisep, params, j0, rows)
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
            w = _store_width(j + rr, panel, c, width_quant)
            writer.put(j + rr, cur[rr * panel:(rr + 1) * panel, :w])
        j += r
        if progress_cb is not None:
            writer.drain()  # every panel below j is stored
            progress_cb(j, u)
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


def ooc_solve_alpha(lstore, y: torch.Tensor, *, panel: int, block: int = 256) -> torch.Tensor:
    """alpha = (L L^T)^{-1} y by a forward and a backward substitution, each
    one pass over the stored L panels: W never enters, so a narrowed W
    store cannot reach the posterior mean."""
    del block  # the substitutions solve whole diagonal blocks
    nb = y.shape[0] // panel
    u = torch.zeros_like(y)
    for j, lj in _Prefetcher(lstore, range(nb)):
        _fwd_sub_step(u, lj, y, j * panel)
    return ooc_alpha_backward(lstore, u, panel=panel)


def ooc_trsm(lstore, wstore, y: torch.Tensor, *, panel: int, block: int = 256,
             accumulate_alpha: bool = True, width_quant: int = 2, sweep: int = 1,
             start_panel: int = 0, end_panel: int | None = None, progress_cb=None,
             on_panel=None, store_final: bool = True):
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
    write.

    Resumable: the TRSM carries no vector state without accumulate_alpha,
    so the W panels [0, start_panel) in `wstore` (reattached by `open_dir`)
    are its whole checkpoint, and a resumed run needs L panels
    [start_panel, nb) only.  `progress_cb(next_j)` is called after each
    sweep once its W panels are stored; `end_panel` stops after panels
    [start_panel, end_panel)."""
    if accumulate_alpha and (start_panel or end_panel is not None):
        raise ValueError("alpha accumulation cannot run over a panel sub-range (the partial "
                         "sum would pose as the full alpha); use accumulate_alpha=False "
                         "(substitution alpha)")
    if panel % block:
        raise ValueError(f"panel ({panel}) must be a multiple of block ({block})")
    c = y.shape[0]
    nb = c // panel
    nb_stop = nb if end_panel is None else min(int(end_panel), nb)
    alpha = torch.zeros_like(y) if accumulate_alpha else None
    dev = lstore.device
    writer = _AsyncWriter(wstore)
    j = int(start_panel)
    while j < nb_stop:
        r = min(max(int(sweep), 1), nb_stop - j)
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
        writer.drain()  # the previous sweep is stored before L goes
        for rr in range(r):
            lstore.free(j + rr)
        _trsm_finish(ljj, u, j0, block=block)
        del ljj
        if accumulate_alpha:
            alpha += (u @ y) @ u
        if on_panel is not None:
            on_panel(j0, u)
        if store_final or j + r < nb_stop:
            for rr in range(r):
                w = _store_width(j + rr, panel, c, width_quant)
                writer.put(j + rr, u[rr * panel:(rr + 1) * panel, :w])
        del u
        j += r
        if progress_cb is not None:
            writer.drain()  # the panels are stored before the checkpoint says so
            progress_cb(j)
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
    # A narrowed (float16) W panel's rounding is ~1e-1 ABSOLUTE where W is
    # large (~1/sqrt(noise)): tolerable in the variance's squares, but V =
    # W K(X, X_new) and A = W^T V feed the mean's correction directly (the
    # JAX package measured 0.7 off on a 1,024-point problem with one spilled
    # panel).  The configured spill dtype misses panels that a reattached
    # store inherited, so what is stored is checked too.
    sd = getattr(model.wstore, "_spill_dtype", None)
    checker = getattr(model.wstore, "has_compressed_panels", None)
    if ((sd is not None and torch.finfo(sd).bits < torch.finfo(dt).bits)
            or (checker is not None and checker())):
        raise ValueError(
            "tactile updates need the uncompressed W factor: this fit's W "
            "store holds spill-compressed panels, whose rounding is "
            "amplified into the posterior-mean correction (fine for "
            "variance-only queries).  Refit with w_dtype=None to update."
        )
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


def ooc_residual_check(model: OOCModel, *, n_blocks: int = 4, block: int = 256,
                       tol: float = 3e-3, tol_y: float = 3e-2) -> dict:
    """The guard of a fit whose stored panels were compressed (the int16 L
    codec): sampled rows of the system the factor claims to have solved,
    r_S = (K + diag(noise))_S alpha - y_S, rebuilt from the coordinates
    (`n_blocks` bands of `block` rows, Kernel A's band mode or Kernel E; no
    panel is read).  alpha flows through every decoded L panel, so a codec
    error the problem cannot absorb shows in r by the factor it would move
    the posterior mean.  Two ratios:

    * rel_bw = max_i |r_i| / (sum_j |K_ij| |alpha_j| + |y_i|), the
      componentwise backward error: it fires on corrupted storage (a damaged
      panel file, a stale panel) that no quantizer produced;
    * rel_y = max_i |r_i| / ||y||_inf, the residual in observation units,
      which tracks the damage to the mean.

    ok needs rel_bw <= tol and rel_y <= tol_y (the JAX package's
    calibration).  The rows come from the real value rows [0, n_real)
    (padded rows' noise would drown the scale); a touch tail is left out
    (check the fresh fit)."""
    dt = model.dtype
    cols = _factor_cols(model)
    if getattr(model, "meta", None) is not None:
        noise_full = cuda_joint.joint_noise(model.n0, model.noise, model.noise_g, None, model.x)
    else:
        noise_full = model.noise
    nr = int(model.n_real)
    b = min(block, nr)
    n_blocks = max(1, min(n_blocks, nr // max(b, 1)))
    if n_blocks == 1:
        starts = [0]
    else:  # evenly spread, deduplicated block starts inside the real rows
        starts = sorted({round(k * (nr - b) / (n_blocks - 1)) for k in range(n_blocks)})
    alpha = model.alpha
    aabs = alpha.abs()
    # The scale of the whole target (pad rows are zero): a joint system's
    # value targets are all 0 on the surface, its signal in the normals.
    y_scale = float(model.y.abs().max()) or 1.0
    tiny = torch.finfo(dt).tiny
    worst_abs, worst_bw = 0.0, 0.0
    for r0 in starts:
        band = _gram_band(model.kernel, cols, noise_full, model.params, r0, b)
        yb = model.y[r0:r0 + b]
        r = band @ alpha - yb
        scale = band.abs() @ aabs + yb.abs()
        worst_abs = max(worst_abs, float(r.abs().max()))
        worst_bw = max(worst_bw, float((r.abs() / torch.clamp(scale, min=tiny)).max()))
    rel_y = worst_abs / max(y_scale, tiny)
    ok = worst_bw <= tol and rel_y <= tol_y
    return {"residual": worst_abs, "rel_bw": worst_bw, "rel_y": rel_y, "ok": bool(ok),
            "tol": tol, "tol_y": tol_y, "rows": [int(v) for v in starts], "block": int(b)}


def plan_sweeps(c: int, panel: int, itemsize: int = 4, *, limit: int | None = None,
                w_itemsize: int | None = None, l_itemsize: int | None = None,
                width_quant: int = 2, max_sweep: int = 32, device="cuda") -> dict:
    """The factor's and the TRSM's sweep widths that minimize the modelled
    host-to-device refetch traffic, and the device budgets that go with
    them (the JAX package's planner, arithmetic alone).  For sweep s over
    nb = c / panel stored panels, each group of s rows refetches the stored
    prefix [0, j) but for the budget-first resident panels:

        traffic(s) = sum over groups of max(0, cum(j) - cum(tier(s))),

    cum the cumulative trimmed panel bytes (`_store_width`), tier(s) the
    longest resident prefix under the phase's budget,

        factor: limit - ((s + 4.5) B C i + 2 (s B)^2 i + 0.5 GB),
        TRSM:   limit - ((2 s + 3.5) B C i + 2 (s B)^2 i + 0.5 GB).

    Raising s divides the groups but shrinks the tier; ties take the
    smaller s.  Spilled L panels refetch at `l_itemsize` (the int16 codec:
    2), W panels at `w_itemsize` both spilled and resident (device_dtype).
    `limit` defaults to what `device`'s allocator can hold.  Returns {"nb",
    "factor_sweep", "factor_budget", "factor_traffic", "trsm_sweep",
    "trsm_budget", "trsm_traffic"}: pass the budgets on with the sweeps."""
    if limit is None:
        limit = _device_limit(resolve_device(device))
    nb = c // panel
    if nb * panel != c:
        raise ValueError(f"c ({c}) must be a multiple of panel ({panel})")
    pb = panel * c * itemsize
    cum = [0]
    for k in range(nb):
        cum.append(cum[-1] + panel * _store_width(k, panel, c, width_quant) * itemsize)

    def tier_panels(budget: int) -> int:
        t = 0
        while t < nb and cum[t + 1] <= budget:
            t += 1
        return t

    def traffic(s: int, budget: int, refetch_scale: float) -> float:
        t = tier_panels(budget)
        return sum(max(0, cum[j] - cum[min(t, j)]) * refetch_scale for j in range(0, nb, s))

    def pick(rows_per_sweep: float, fixed_rows: float, refetch_scale: float,
             tier_scale: float = 1.0):
        slack = int(fixed_rows * pb) + 500_000_000
        best = None
        for s in range(1, min(max_sweep, nb) + 1):
            diag = 2 * (s * panel) ** 2 * itemsize
            budget = limit - int(rows_per_sweep * s * pb) - diag - slack
            if budget < 0:
                break
            vol = traffic(s, int(budget / tier_scale), refetch_scale)
            if best is None or vol < best[2]:
                best = (s, budget, vol)
        return best or (1, 0, traffic(1, 0, refetch_scale))

    fs, fbudget, fvol = pick(1.0, 4.5, (l_itemsize / itemsize) if l_itemsize else 1.0)
    wscale = (w_itemsize / itemsize) if w_itemsize else 1.0
    ts, tbudget, tvol = pick(2.0, 3.5, wscale, tier_scale=wscale)
    return {"nb": nb, "factor_sweep": fs, "factor_budget": fbudget,
            "factor_traffic": int(fvol), "trsm_sweep": ts, "trsm_budget": tbudget,
            "trsm_traffic": int(tvol)}


# ------------------------------------------------------------------- fits


def _device_limit(device, default: int = 15_500_000_000) -> int:
    """Bytes this process's allocator can hold on the card: what is free
    plus what it has cached.  `default` off the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return default
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device)


def _hbm_budget(panel: int, c: int, itemsize: int, device, sweep: int = 1) -> int:
    """Device bytes left to the tiered stores: the limit minus the row-band
    working set -- the widest (sweep B, C) band of the factor or the TRSM's
    (its band and U, `sweep` the larger), two prefetched panels, the
    transients of a step -- and 0.5 GB (the JAX package's reserve)."""
    reserve = int((sweep + 4.5) * panel * c * itemsize) + 500_000_000
    return max(_device_limit(device) - reserve, 0)


def _padded(v, fill: float, shape, like: torch.Tensor) -> torch.Tensor:
    out = torch.full(shape, fill, dtype=like.dtype, device=like.device)
    n = like.shape[0]
    out[:n] = torch.as_tensor(v, dtype=like.dtype, device=like.device).broadcast_to(
        (n,) + tuple(shape[1:]))
    return out


def _pad_problem(kernel: str, x, y, noise, params, *, panel: int, pad_noise: float,
                 dtype=None):
    """Pad (x, y, noise) to a panel multiple with inert high-noise rows at
    the origin, in `dtype` (default x's); returns (xp, yp, noisep, params,
    c, n, jitter)."""
    if dtype is not None:
        x = x.to(dtype)
    n = x.shape[0]
    c = round_up(n, panel)
    params = {k: float(v) for k, v in params.items()}
    jitter = 4.0 * torch.finfo(x.dtype).eps * c * abs(float(kf.k_diag0(kernel, params)))
    return (_padded(x, 0.0, (c, 3), x), _padded(y, 0.0, (c,), x),
            _padded(noise, pad_noise, (c,), x), params, c, n, jitter)


def _pad_joint_problem(kernel: str, x, y, normals, noise_f, noise_g, params, *, panel: int,
                       pad_noise: float, dtype=None):
    """Pad a problem with normals so that J = 4C is a panel multiple (C to a
    multiple of panel / 4) and pack its factor metadata, in `dtype`
    (default x's).  Returns (xp, yj, meta, nrm, nf, ng, params, c, n,
    jitter)."""
    if dtype is not None:
        x = x.to(dtype)
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
                        jitter, width_quant: int = 2, sweep: int = 2,
                        initial_jitter: float | None = None,
                        max_jitter_retries: int = MAX_JITTER_RETRIES,
                        spill_dir: str | None = None, l_codec: str | None = None):
    """The NaN-escalation jitter ladder around `ooc_cholesky`, from
    `initial_jitter` (default none) up `max_jitter_retries` rungs.  Returns
    (store, u, logdiag_sum, extra), extra the jitter added to the factor's
    diagonal, which the caller folds into its stored noises."""
    extra = initial_jitter if initial_jitter is not None else 0.0
    for _ in range(max_jitter_retries + 1):
        st = _make_store(store, budget, cols.device, spill_dir, spill_codec=l_codec)
        stats: dict = {}
        ok, u = ooc_cholesky(kernel, cols, noise + extra, params, st, panel=panel, block=block,
                             width_quant=width_quant, sweep=sweep, y=y, stats=stats)
        if ok:
            return st, u, stats["logdiag_sum"], extra
        st.clear()
        del st
        extra = max(extra * 10.0, jitter)
    raise FloatingPointError(f"out-of-core Cholesky failed even with jitter {extra:.2e}")


def _fit_budget(device_budget, panel: int, j: int, x: torch.Tensor, sweep: int) -> DeviceBudget:
    if device_budget is not None:
        return DeviceBudget(device_budget)
    return DeviceBudget(_hbm_budget(panel, j, x.element_size(), x.device, sweep=sweep))


def _trsm_sweep(sweep: int, trsm_sweep: int | None) -> int:
    return min(sweep, 2) if trsm_sweep is None else trsm_sweep


def ooc_fit(kernel: str, x, y, noise, params, *, panel: int, block: int = 256,
            store: str = "tiered", pad_noise: float = 1e10, dtype=None,
            max_jitter_retries: int = MAX_JITTER_RETRIES, initial_jitter: float | None = None,
            device_budget: int | None = None, w_dtype=None, width_quant: int = 2,
            sweep: int = 2, trsm_sweep: int | None = None, spill_dir: str | None = None,
            l_codec: str | None = None) -> OOCModel:
    """Out-of-core GP fit in `dtype` (default x's) on x's device: pad to a
    panel multiple, factor with the NaN-escalation jitter ladder (from
    `initial_jitter`, `max_jitter_retries` rungs), alpha by substitution
    against L, then the TRSM.  `store` = "tiered" (the card up to
    `device_budget` bytes, by default all the card can spare, then host RAM,
    or with `spill_dir` files there), "host" or "device".  `sweep` row
    panels form a factor band and `trsm_sweep` (default min(sweep, 2)) a
    TRSM step; stored widths round up to `width_quant` panels.

    `w_dtype` (float16) narrows the SPILLED W panels: alpha comes from L,
    so only the variance sees the rounding (~1e-3), and `ooc_update`
    refuses such a model.  `l_codec="int16"` spills the L panels in the
    blockwise int16 codec (absolute error <= blockmax * 3e-5; check the fit
    with `ooc_residual_check`); a narrower L DTYPE is never offered, its
    relative rounding breaks the mean."""
    xp, yp, noisep, params, c, n, jitter = _pad_problem(kernel, x, y, noise, params,
                                                        panel=panel, pad_noise=pad_noise,
                                                        dtype=dtype)
    tsw = _trsm_sweep(sweep, trsm_sweep)
    budget = _fit_budget(device_budget, panel, c, xp, max(sweep, tsw + 1))
    st, u, logdiag, extra = _factor_with_jitter(
        kernel, xp, noisep, params, budget, panel=panel, block=block, store=store, y=yp,
        jitter=jitter, width_quant=width_quant, sweep=sweep, initial_jitter=initial_jitter,
        max_jitter_retries=max_jitter_retries, spill_dir=spill_dir, l_codec=l_codec)
    alpha = ooc_alpha_backward(st, u, panel=panel)
    wstore = _make_store(store, budget, xp.device, spill_dir, spill_dtype=w_dtype)
    ooc_trsm(st, wstore, yp, panel=panel, block=block, accumulate_alpha=False,
             width_quant=width_quant, sweep=tsw)
    return OOCModel(kernel=kernel, x=xp, y=yp, noise=noisep + extra, params=params, alpha=alpha,
                    wstore=wstore, panel=panel, n_real=n, u=u, logdiag_sum=logdiag)


def ooc_fit_joint(kernel: str, x, y, normals, noise_f, noise_g, params, *, panel: int,
                  block: int = 256, store: str = "tiered", pad_noise: float = 1e10, dtype=None,
                  max_jitter_retries: int = MAX_JITTER_RETRIES,
                  initial_jitter: float | None = None, device_budget: int | None = None,
                  w_dtype=None, width_quant: int = 2, sweep: int = 2,
                  trsm_sweep: int | None = None, spill_dir: str | None = None,
                  l_codec: str | None = None) -> OOCJointModel:
    """Out-of-core joint (value + gradient) fit: J = 4C factor rows for C
    padded points, in the dimension-major layout [f | d1 | d2 | d3]; the
    same factor, TRSM and alpha as `ooc_fit` (and its options), on packed
    joint metadata."""
    (xp, yj, meta, nrm, nf, ng, params, c, n,
     jitter) = _pad_joint_problem(kernel, x, y, normals, noise_f, noise_g, params, panel=panel,
                                  pad_noise=pad_noise, dtype=dtype)
    j_tot = 4 * c
    tsw = _trsm_sweep(sweep, trsm_sweep)
    budget = _fit_budget(device_budget, panel, j_tot, xp, max(sweep, tsw + 1))
    noisej = cuda_joint.joint_noise(c, nf, ng, None, xp)
    st, u, logdiag, extra = _factor_with_jitter(
        kernel, meta, noisej, params, budget, panel=panel, block=block, store=store, y=yj,
        jitter=jitter, width_quant=width_quant, sweep=sweep, initial_jitter=initial_jitter,
        max_jitter_retries=max_jitter_retries, spill_dir=spill_dir, l_codec=l_codec)
    alpha = ooc_alpha_backward(st, u, panel=panel)
    wstore = _make_store(store, budget, xp.device, spill_dir, spill_dtype=w_dtype)
    ooc_trsm(st, wstore, yj, panel=panel, block=block, accumulate_alpha=False,
             width_quant=width_quant, sweep=tsw)
    return OOCJointModel(kernel=kernel, x=xp, y=yj, noise=nf + extra, params=params,
                         alpha=alpha, wstore=wstore, panel=panel, n_real=n, u=u,
                         logdiag_sum=logdiag, meta=meta, normals=nrm, noise_g=ng + extra, n0=c)


# ------------------------------------------------- process-split phases


def _problem_tag(arrays, params, dtype) -> str:
    """sha1 of a padded problem: its arrays' bytes and the hyperparameters at
    the fit's dtype (as the JAX package hashes its jnp scalars)."""
    h = hashlib.sha1()
    for a in arrays:
        h.update(a.detach().cpu().numpy().tobytes())
    for k in sorted(params):
        h.update(k.encode())
        h.update(np.asarray(params[k], dtype=_np_dtype(dtype)).tobytes())
    return h.hexdigest()


def _save_npz_atomic(path: str, **arrays) -> None:
    """np.savez through a temporary file and a rename: a kill mid-write
    leaves the old file whole."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def ooc_factor_phase(kernel: str, x, y, noise, params, *, panel: int, spill_dir: str,
                     block: int = 256, sweep: int = 2, width_quant: int = 2,
                     pad_noise: float = 1e10, dtype=None,
                     max_jitter_retries: int = MAX_JITTER_RETRIES,
                     initial_jitter: float | None = None, device_budget: int | None = None,
                     resume: bool = True, normals=None, noise_g=None,
                     l_codec: str | None = None, defer_alpha: bool = False) -> None:
    """Phase 1 of the two-phase out-of-core fit: factor, solve alpha, and
    persist the L store and the problem's state under `spill_dir` (`L/`,
    `state.npz`), for `ooc_solve_phase` to finish in another process.

    The factor survives a crash: the L store is write-through (every panel
    mirrored to its file as it is stored) and a progress checkpoint (u =
    L^{-1} y so far, the next panel, the jitter, sum(log diag L)) lands after
    every stored sweep, so with `resume` a rerun reattaches the store and
    continues from the last finished sweep, provided the checkpoint's
    problem hash (the padded coordinates, targets, noise, normals and
    hyperparameters) is this problem's.  A NaN factor restarts from scratch
    one jitter rung up.

    `normals` (and `noise_g`) switch to the joint layout: the factor's
    columns are packed joint metadata and the state carries normals,
    noise_f and noise_g.  `defer_alpha` (value fits) skips the backward
    substitution's stream of the L panels: the solve phase sums alpha =
    W^T (W y) from its W bands instead.  `l_codec="int16"` codes the L
    panels on disk."""
    joint = normals is not None
    if joint:
        (xp, yp, cols, nrm, nf, ng, params, c0, n,
         jitter) = _pad_joint_problem(kernel, x, y, normals, noise, noise_g, params, panel=panel,
                                      pad_noise=pad_noise, dtype=dtype)
        np_ = cuda_joint.joint_noise(c0, nf, ng, None, xp)
        c = 4 * c0
    else:
        xp, yp, np_, params, c, n, jitter = _pad_problem(kernel, x, y, noise, params,
                                                         panel=panel, pad_noise=pad_noise,
                                                         dtype=dtype)
        cols = xp
    dt, dev = xp.dtype, xp.device
    budget = _fit_budget(device_budget, panel, c, xp, sweep)
    extra = initial_jitter if initial_jitter is not None else 0.0
    ldir = os.path.join(spill_dir, "L")
    prog_path = os.path.join(spill_dir, "progress.npz")
    # Same shapes are not enough to resume: a rerun with other
    # hyperparameters or another cloud of the same size would splice two
    # factors into one.
    problem_tag = _problem_tag([xp, yp, np_] + ([nrm] if joint else []), params, dt)

    start_panel, u0, st0, ld0 = 0, None, None, 0.0
    if resume and os.path.exists(prog_path) and os.path.exists(os.path.join(ldir,
                                                                            "manifest.json")):
        try:
            with np.load(prog_path) as d:
                prog = {k: d[k] for k in d.files}
            match = (int(prog["c"]) == c and int(prog["panel"]) == panel
                     and str(prog["kernel"]) == kernel and str(prog["problem"]) == problem_tag)
        except (OSError, ValueError, KeyError):
            match = False  # a damaged checkpoint: factor from scratch
        if match:
            start_panel = int(prog["next_panel"])
            u0 = torch.as_tensor(prog["u"], dtype=dt, device=dev)
            extra = float(prog["extra"])
            # A checkpoint without the log-diagonal sum has lost the
            # prefix's share: the sum stays unknown rather than wrong.
            ld0 = (float(prog["logdiag"]) if "logdiag" in prog
                   else (0.0 if start_panel == 0 else None))
            st0 = TieredPanelStore.open_dir(budget, ldir, device=dev, write_through=True,
                                            spill_codec=l_codec)

    stats: dict = {}
    st_cur = None

    def checkpoint(next_j, u_now):
        st_cur.save_manifest()
        logdiag = ({"logdiag": stats["logdiag_sum"]}
                   if stats.get("logdiag_sum") is not None and ld0 is not None else {})
        _save_npz_atomic(prog_path, next_panel=next_j, u=u_now.detach().cpu().numpy(),
                         extra=extra, c=c, panel=panel, kernel=kernel, problem=problem_tag,
                         **logdiag)

    for _ in range(max_jitter_retries + 1):
        st_cur = st0 if st0 is not None else TieredPanelStore(
            budget, dev, spill_dir=ldir, write_through=True, spill_codec=l_codec)
        st0 = None
        stats.clear()
        ok, u = ooc_cholesky(kernel, cols, np_ + extra, params, st_cur, panel=panel,
                             block=block, width_quant=width_quant, sweep=sweep, y=yp,
                             start_panel=start_panel, u0=u0, progress_cb=checkpoint,
                             logdiag0=ld0 or 0.0, stats=stats if ld0 is not None else None)
        if ok:
            np_ = np_ + extra
            st = st_cur
            break
        st_cur.clear()
        start_panel, u0, ld0 = 0, None, 0.0  # a NaN factor starts afresh
        _unlink(prog_path)
        extra = max(extra * 10.0, jitter)
    else:
        raise FloatingPointError(f"out-of-core Cholesky failed even with jitter {extra:.2e}")

    def host(t):
        return t.detach().cpu().numpy()

    state = {"x": host(xp), "y": host(yp), "noise": host(np_), "u": host(u), "kernel": kernel,
             "panel": panel, "n_real": n, "block": block, "width_quant": width_quant}
    if not (defer_alpha and not joint):
        state["alpha"] = host(ooc_alpha_backward(st, u, panel=panel))
    st.evict_all()
    st.save_manifest()
    if joint:
        # The jitter was added to the whole joint diagonal: both noise
        # families carry it, so that later borderings rebuild K as L has it.
        state.update(normals=host(nrm), noise_f=host(nf) + extra, noise_g=host(ng) + extra)
    if stats.get("logdiag_sum") is not None:
        state["logdiag_sum"] = stats["logdiag_sum"]
    for k, v in params.items():
        state[f"param_{k}"] = np.asarray(v, dtype=_np_dtype(dt))
    np.savez(os.path.join(spill_dir, "state.npz"), **state)
    _unlink(prog_path)


def _load_state(spill_dir: str) -> dict:
    with np.load(os.path.join(spill_dir, "state.npz"), allow_pickle=False) as d:
        return {k: d[k] for k in d.files}


def _solve_tag(d: dict) -> str:
    """The W store's tag: a hash of the solved state (u, else alpha), which
    pins the whole upstream problem, and stays put when a deferred alpha is
    written into the state after the TRSM."""
    h = hashlib.sha1()
    for a in (d["x"], d["y"], d["noise"], d["u"] if "u" in d else d["alpha"]):
        h.update(np.asarray(a).tobytes())
    h.update(f"{d['kernel']}:{int(d['panel'])}".encode())
    return h.hexdigest()


def _missing_l(lst, lo: int, hi: int, spill_dir: str, what: str):
    missing = [j for j in range(lo, hi) if j not in lst]
    if missing:
        raise FileNotFoundError(
            f"{what} needs L panels {missing[:5]}{'...' if len(missing) > 5 else ''} "
            f"of [{lo}, {hi}) but they are not in the L store at {spill_dir}/L: an "
            "earlier TRSM consumed them and its W store was cleared afterwards.  Restore "
            "the panels or run the factor phase again.")


def ooc_solve_phase(spill_dir: str, *, w_dtype=None, trsm_sweep: int = 1,
                    device_budget: int | None = None, resume: bool = True,
                    stop_after: int | None = None, fused_query=None, keep_w: bool = True,
                    device="cuda"):
    """Phase 2 of the two-phase out-of-core fit: reattach the L store that
    `ooc_factor_phase` persisted under `spill_dir`, run the panel-consuming
    TRSM (W replaces L on disk, under `W/`) on `device`, and return the
    query-ready OOCModel (or OOCJointModel).

    The TRSM survives a crash: the W store is write-through with its
    manifest saved after every stored sweep, and, the TRSM carrying no
    vector state, the W prefix on disk is its checkpoint.  With `resume` a
    rerun reattaches W (its tag must be this factor's) and continues at the
    first missing panel; the L panels from there on must be on disk again
    (a missing one raises FileNotFoundError at once).  `stop_after` ends the
    run after that many W panels and returns None; a later call finishes.

    `fused_query` (M, 3): the TRSM-fused query.  Each sweep's W rows add
    their share of every query's quad (Kernel F's band mode, value or joint
    columns) while they are on the card, so no W panel is read back for
    it; with `keep_w=False` the last sweep's panels, never read again, are
    not written.  Returns (model, (mean, var)) then, or (model, None) when
    a resumed TRSM has lost earlier bands' shares and the caller must query
    the model.  A deferred alpha is summed from the fresh TRSM's W bands
    (and written into the state), else solved against the restored L."""
    dev = resolve_device(device)
    d = _load_state(spill_dir)
    kernel, panel, block = str(d["kernel"]), int(d["panel"]), int(d["block"])
    width_quant = int(d["width_quant"])

    def t(key):
        return torch.as_tensor(d[key], device=dev)

    xp, yp, np_ = t("x"), t("y"), t("noise")
    alpha = t("alpha") if "alpha" in d else None
    params = {k[len("param_"):]: float(d[k]) for k in d if k.startswith("param_")}
    c = yp.shape[0]  # the factor's size, C or J = 4C
    nb = c // panel
    budget = _fit_budget(device_budget, panel, c, xp, trsm_sweep + 1)
    lst = TieredPanelStore.open_dir(budget, os.path.join(spill_dir, "L"), device=dev)
    wdir = os.path.join(spill_dir, "W")
    w_tag = _solve_tag(d)
    wkw = dict(spill_dtype=w_dtype, device_dtype=w_dtype, write_through=True, tag=w_tag)

    start, wstore = 0, None
    if resume and os.path.exists(os.path.join(wdir, "manifest.json")):
        try:
            wstore = TieredPanelStore.open_dir(budget, wdir, expect_tag=w_tag, device=dev, **wkw)
        except ValueError:
            wstore = None  # a stale W store: the TRSM starts afresh
        else:
            while start in wstore:
                start += 1
    if wstore is None:
        # device_dtype too: narrow resident W panels double the tier, and
        # alpha is summed from the full-precision bands before they are
        # stored either way.
        wstore = TieredPanelStore(budget, dev, spill_dir=wdir, **wkw)
    joint = "normals" in d
    cols = cuda_joint.pack_meta(cuda_joint.joint_meta(xp)) if joint else xp
    fused_pair = None
    if start < nb:
        end = nb if stop_after is None else min(nb, stop_after)
        _missing_l(lst, start, end, spill_dir, "the TRSM")
        on_panel = None
        fused_ok = fused_query is not None and start == 0 and stop_after is None
        if fused_ok:
            q = torch.as_tensor(fused_query).to(dtype=xp.dtype, device=dev).contiguous()
            chunks = _chunks(q, 8192)
            quads = [torch.zeros((ch.shape[0],), dtype=xp.dtype, device=dev) for ch in chunks]

            def on_panel(j0, w_band):
                for quad, ch in zip(quads, chunks):
                    quad += _quad_band(kernel, ch, cols, params, w_band, j0)

        want_accum = alpha is None and start == 0 and stop_after is None
        if alpha is None and not want_accum:
            alpha = ooc_solve_alpha(lst, yp, panel=panel, block=block)
        out_alpha = ooc_trsm(lst, wstore, yp, panel=panel, block=block,
                             accumulate_alpha=want_accum, width_quant=width_quant,
                             sweep=trsm_sweep, start_panel=start, end_panel=stop_after,
                             progress_cb=lambda _j: wstore.save_manifest(), on_panel=on_panel,
                             store_final=keep_w or not fused_ok)
        if want_accum:
            # The L panels that could give alpha again are consumed: a later
            # reattach of the finished fit reads it from the state.
            alpha = out_alpha
            d["alpha"] = alpha.cpu().numpy()
            _save_npz_atomic(os.path.join(spill_dir, "state.npz"), **d)
        if fused_ok:
            mean = torch.cat([_value_cross(kernel, ch, cols, params) @ alpha for ch in chunks])
            k0 = float(kf.k_diag0(kernel, params))
            fused_pair = (mean, torch.clamp(k0 - torch.cat(quads), 0.0, k0))
    if alpha is None:
        # A deferred alpha whose TRSM had nothing left to do.
        _missing_l(lst, 0, nb, spill_dir, "the deferred alpha")
        alpha = ooc_solve_alpha(lst, yp, panel=panel, block=block)
    if stop_after is not None and stop_after < nb:
        return None
    common = dict(kernel=kernel, x=xp, y=yp, params=params, alpha=alpha, wstore=wstore,
                  panel=panel, n_real=int(d["n_real"]), u=t("u") if "u" in d else None,
                  logdiag_sum=float(d["logdiag_sum"]) if "logdiag_sum" in d else None)
    if joint:
        model = OOCJointModel(noise=t("noise_f"), meta=cols, normals=t("normals"),
                              noise_g=t("noise_g"), n0=xp.shape[0], **common)
    else:
        model = OOCModel(noise=np_, **common)
    if fused_query is not None:
        return model, fused_pair
    return model
