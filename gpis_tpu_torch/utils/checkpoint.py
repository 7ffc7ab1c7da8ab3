"""Checkpoint / resume (port of gpis_tpu/utils/checkpoint.py): a session that
crashes is rebuilt from its last checkpoint, and the touches that came after
it are replayed through `update`.

The file is the JAX package's NPZ layout, key for key, with the same JSON
`meta` and format version, so a checkpoint written by either package loads
in the other: in-core value models (`linv_is_chol` where the factor is W,
`has_linv` where W is kept beside it), joint models with their touch slots,
and sharded value and joint models, whose row bands of L and W rank 0
gathers into the whole matrices (each rank keeps its band at load).  The hyperparameters are written as float64
scalars (the port holds Python floats, so its own round trip is exact); a
float32 JAX checkpoint's are read as their float32 values.  Committees
(`gp.experts`, value and joint, with or without their stacked L) keep the
JAX package's stacked keys too.  The port writes
its members uncompressed (`np.savez`): the factor and W of a large model
are mostly mantissa noise, and deflating them costs the host seconds a
gigabyte; `np.load` in both packages reads either form.

`factor=False` leaves the factor out, and `load_model` refits it from the
Gram: Kernel A (value) or E (joint), then the blocked Cholesky (Kernel B);
where the saved factor was W (`linv_is_chol`) W is formed again (Kernel C).
A committee saved without its factors refactors every expert
(`experts.expert_chol`) and, as in the JAX package, carries no W.

An out-of-core model (value or joint, with its touch tail) keeps its small
state in the NPZ and its W = L^{-1} panels, at their stored dtype, as one
raw file each under `path + ".w/"` with the panel store's manifest
(`TieredPanelStore.put_host` and `save_manifest` write them,
`TieredPanelStore.open_dir` reattaches them): the loaded model's panels
stay on disk until the session promotes them.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch
import torch.distributed as dist

from gpis_tpu_torch import convert
from gpis_tpu_torch._build import resolve_device
from gpis_tpu_torch.gp.experts import expert_chol
from gpis_tpu_torch.gp.kinds import model_kind
from gpis_tpu_torch.gp.sharded_joint import ShardedJointModel
from gpis_tpu_torch.gp.sharded_model import _all_gather
from gpis_tpu_torch.kernels import cuda_joint
from gpis_tpu_torch.kernels import derivative as kd
from gpis_tpu_torch.kernels import gram as kg
from gpis_tpu_torch.linalg import cholesky as lin
from gpis_tpu_torch.linalg import outofcore as ooc
from gpis_tpu_torch.linalg.cuda_chol import blocked_linv
from gpis_tpu_torch.parallel.mesh import make_row_mesh

__all__ = ["save_model", "load_model"]

_FORMAT_VERSION = 1
_LINV_BLOCK = 256


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _param_arrays(params) -> dict:
    return {"param_lengthscale": np.float64(params["lengthscale"]),
            "param_signal_variance": np.float64(params["signal_variance"])}


def save_model(path: str, model, *, factor: bool = True) -> None:
    """Save an in-core GPModel or DerivGPModel, an ExpertGPModel, an
    OOCModel or OOCJointModel (W panels beside the NPZ in `path + ".w/"`),
    or a ShardedGPModel or ShardedJointModel (every rank calls it; rank 0
    writes)."""
    kind = model_kind(model)
    if kind in ("ooc", "ooc_joint"):
        _save_ooc(path, model)
        return
    if kind in ("sharded", "sharded_joint"):
        _save_sharded(path, model)
        return
    if kind == "experts":
        _save_experts(path, model, factor=factor)
        return
    joint = kind == "joint"
    meta = {"format": _FORMAT_VERSION, "kernel": model.kernel, "n0": model.n0,
            "dtype": _dtype_name(model.dtype), "has_factor": bool(factor), "joint": joint}
    arrays = {"x": _np(model.x), "y": _np(model.y), "alpha": _np(model.alpha),
              **_param_arrays(model.params)}
    if joint:
        arrays.update(normals=_np(model.normals), noise_f=_np(model.noise_f),
                      noise_g=_np(model.noise_g))
        if model.linv is not None:
            meta["has_linv"] = True
            arrays["linv"] = _np(model.linv)
        if model.touch_x is not None:
            meta["joint_touch"] = True
            meta["n_touch"] = int(model.n_touch)
            arrays.update(touch_x=_np(model.touch_x), touch_y=_np(model.touch_y),
                          touch_noise=_np(model.touch_noise))
    else:
        meta["pad_noise"] = float(model.pad_noise)
        arrays["noise"] = _np(model.noise)
        arrays["n_touch"] = np.asarray(model.n_touch, dtype=np.int32)
        # A fit_inference model's chol IS W: stored once.
        if model.linv is not None:
            if model.linv is model.chol:
                meta["linv_is_chol"] = True
            else:
                meta["has_linv"] = True
                arrays["linv"] = _np(model.linv)
    if factor:
        arrays["chol"] = _np(model.chol)
    np.savez(path, meta=json.dumps(meta), **arrays)


def _save_experts(path: str, model, *, factor: bool = True) -> None:
    """A committee's stacked leaves, its L and W where it has them (and
    `factor`), in the JAX package's keys and meta."""
    meta = {"format": _FORMAT_VERSION, "kernel": model.kernel, "n0": model.n0,
            "dtype": _dtype_name(model.dtype), "experts": True,
            "pad_noise": float(model.pad_noise), "beta": model.beta, "gate": int(model.gate),
            "has_factor": bool(factor), "has_linv": bool(factor) and model.linv is not None,
            "has_chol": bool(factor) and model.chol is not None}
    arrays = {"x": _np(model.x), "y": _np(model.y), "noise": _np(model.noise),
              "alpha": _np(model.alpha), "n_touch": np.asarray(model.n_touch, np.int32),
              "centroids": _np(model.centroids), **_param_arrays(model.params)}
    if model.joint:
        meta["experts_joint"] = True
        arrays.update(normals=_np(model.normals), noise_g=_np(model.noise_g))
        if model.touch_x is not None:
            arrays.update(touch_x=_np(model.touch_x), touch_y=_np(model.touch_y),
                          touch_noise=_np(model.touch_noise))
    if meta["has_chol"]:
        arrays["chol"] = _np(model.chol)
    if meta["has_linv"]:
        arrays["linv"] = _np(model.linv)
    np.savez(path, meta=json.dumps(meta), **arrays)


_OOC_TAIL_KEYS = ("tail_x", "tail_y", "tail_noise", "tail_v", "tail_a", "tail_chol",
                  "tail_alpha")


def _save_ooc(path: str, model) -> None:
    """The NPZ of the replicated state (x, y, noise, alpha, u, the touch
    tail; a joint model's normals and noise_g), and W's panels, at their
    stored dtype, through a zero-budget store's `put_host` into
    `path + ".w/"` with its manifest."""
    nb = model.alpha.shape[0] // model.panel  # the factor size: C, or J = 4C
    out = ooc.TieredPanelStore(ooc.DeviceBudget(0), "cpu", spill_dir=path + ".w")
    for j in range(nb):
        v = model.wstore.get(j)
        # A materialized copy, never a view of the file: a restored model
        # saved back to its own path reads each panel from the file that
        # put_host is about to truncate.
        out.put_host(j, np.array(v.read()) if isinstance(v, ooc._DiskPanel) else _np(v))
    out.compute_dtype = model.dtype
    out.save_manifest()
    meta = {"format": _FORMAT_VERSION, "kernel": model.kernel, "dtype": _dtype_name(model.dtype),
            "ooc": True, "panel": int(model.panel), "n_real": int(model.n_real),
            "n_tail": int(model.n_tail), "has_u": model.u is not None,
            "logdiag_sum": None if model.logdiag_sum is None else float(model.logdiag_sum)}
    arrays = {"x": _np(model.x), "y": _np(model.y), "noise": _np(model.noise),
              "alpha": _np(model.alpha), **_param_arrays(model.params)}
    if model.u is not None:
        arrays["u"] = _np(model.u)
    if model.n_tail:
        arrays["alpha0"] = _np(model.alpha0)
        arrays.update({k: _np(getattr(model, k)) for k in _OOC_TAIL_KEYS})
    if getattr(model, "meta", None) is not None:
        # The packed (J, 7) factor metadata is rebuilt from x at load.
        meta["joint"] = True
        arrays.update(normals=_np(model.normals), noise_g=_np(model.noise_g))
    np.savez(path, meta=json.dumps(meta), **arrays)


def _load_ooc(arrays, meta: dict, path: str, dev: torch.device):
    """The out-of-core model of an NPZ and its `.w/` panels, the panels
    left on disk in a tiered store with the fit's device budget."""
    panel = int(meta["panel"])
    budget = ooc.DeviceBudget(ooc._hbm_budget(panel, arrays["alpha"].shape[0],
                                              arrays["x"].dtype.itemsize, dev))
    wstore = ooc.TieredPanelStore.open_dir(budget, path + ".w", device=dev)

    def t(key):
        return torch.as_tensor(arrays[key], device=dev)

    tail = {}
    if meta.get("n_tail"):
        tail = {k: t(k) for k in (*_OOC_TAIL_KEYS, "alpha0")}
    common = dict(kernel=meta["kernel"], x=t("x"), y=t("y"), noise=t("noise"), alpha=t("alpha"),
                  params={"lengthscale": float(arrays["param_lengthscale"]),
                          "signal_variance": float(arrays["param_signal_variance"])},
                  wstore=wstore, panel=panel, n_real=int(meta["n_real"]),
                  u=t("u") if meta.get("has_u") else None,
                  logdiag_sum=(None if meta.get("logdiag_sum") is None
                               else float(meta["logdiag_sum"])),
                  n_tail=int(meta.get("n_tail", 0)), **tail)
    if meta.get("joint"):
        xp = common["x"]
        return ooc.OOCJointModel(meta=cuda_joint.pack_meta(cuda_joint.joint_meta(xp)),
                                 normals=t("normals"), noise_g=t("noise_g"), n0=xp.shape[0],
                                 **common)
    return ooc.OOCModel(**common)


def _rank0_done(mesh) -> None:
    """Return on every rank only once rank 0 has reached this point (a
    reduction the host waits for: NCCL's returns before it has run)."""
    flag = torch.zeros(1, device=mesh.device)
    dist.all_reduce(flag)
    flag.item()


def _save_sharded(path: str, model) -> None:
    """Rank 0 gathers the bands of L and W into the whole (C, C) matrices and
    writes the JAX package's sharded layout; every rank joins the gathers
    and returns once the file is written."""
    mesh = model.mesh
    whole = {}
    for key in ("l", "w"):
        full = _all_gather(getattr(model, key), mesh.size)
        if mesh.rank == 0:
            whole[key] = _np(full)
        del full
    if mesh.rank == 0:
        joint = model_kind(model) == "sharded_joint"
        meta = {"format": _FORMAT_VERSION, "kernel": model.kernel, "n0": model.n0,
                "dtype": _dtype_name(model.dtype), "sharded": True, "joint": joint,
                "n_devices": mesh.size, "block": int(model.block),
                "n_touch": int(model.n_touch), "n_real": int(model.n_real)}
        if joint:
            meta["pad_noise"] = float(model.pad_noise)
            extra = {"normals": _np(model.normals), "noise_f": _np(model.noise_f),
                     "noise_g": _np(model.noise_g)}
        else:
            extra = {"noise": _np(model.noise)}
        np.savez(path, meta=json.dumps(meta), x=_np(model.x), y=_np(model.y), **whole,
                 alpha=_np(model.alpha), **extra, **_param_arrays(model.params))
    _rank0_done(mesh)


def _refactor(arrays, meta: dict, dev: torch.device) -> torch.Tensor:
    """The factor of a checkpoint saved without it, from its Gram: W where
    the saved factor was W (`linv_is_chol`), else L."""

    def t(key):
        return torch.as_tensor(arrays[key], device=dev)

    params = {"lengthscale": float(arrays["param_lengthscale"]),
              "signal_variance": float(arrays["param_signal_variance"])}
    if meta.get("joint"):
        touch = {}
        if meta.get("joint_touch"):
            touch = {"touch_x": t("touch_x"), "touch_noise": t("touch_noise")}
        return lin.cholesky(kd.joint_gram(meta["kernel"], t("x"), params, noise_f=t("noise_f"),
                                          noise_g=t("noise_g"), **touch))
    l = lin.cholesky(kg.gram(meta["kernel"], t("x"), params, noise=t("noise")))
    if not meta.get("linv_is_chol"):
        return l
    c = l.shape[0]
    return blocked_linv(l, _LINV_BLOCK if c % _LINV_BLOCK == 0 else c, inplace=True)


def load_model(path: str, device="cuda", *, mesh=None):
    """The model in the checkpoint at `path` on `device`.  A sharded
    checkpoint loads on every rank of `mesh` (by default the row mesh of the
    initialized process group, on `device`), whose size must be the
    checkpoint's `n_devices`; each rank keeps its band.  An out-of-core
    checkpoint's W panels stay in their files (`path + ".w/"`)."""
    with np.load(path, allow_pickle=False) as d:
        meta = json.loads(str(d["meta"]))
        if meta["format"] != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint format {meta['format']}")
        arrays = {k: d[k] for k in d.files if k != "meta"}
    if meta.get("sharded"):
        return _load_sharded(arrays, meta, mesh, device)
    dev = resolve_device(device)
    if meta.get("ooc"):
        return _load_ooc(arrays, meta, path, dev)
    if meta.get("experts"):
        m = convert.experts_model_from_arrays(arrays, meta, dev)
        if meta["has_factor"]:
            return m
        return dataclasses.replace(m, chol=torch.stack(
            [expert_chol(m, e) for e in range(m.n_experts)]))
    chol = None if meta["has_factor"] else _refactor(arrays, meta, dev)
    return convert.gp_model_from_arrays(arrays, meta, dev, chol=chol)


def _load_sharded(arrays, meta: dict, mesh, device):
    mesh = mesh or make_row_mesh(device=device)
    n = int(meta["n_devices"])
    if mesh.size != n:
        raise RuntimeError(f"checkpoint was fit on {n} devices; the process group has "
                           f"{mesh.size} ranks")
    params = {"lengthscale": arrays["param_lengthscale"],
              "signal_variance": arrays["param_signal_variance"]}
    if meta.get("joint"):
        row0, rows = mesh.band(arrays["l"].shape[0])

        def t(key, band=False):
            a = arrays[key][row0:row0 + rows] if band else arrays[key]
            return torch.as_tensor(np.array(a), device=mesh.device)

        return ShardedJointModel(
            kernel=meta["kernel"], x=t("x"), params={k: float(v) for k, v in params.items()},
            l=t("l", True), w=t("w", True), alpha=t("alpha"), mesh=mesh,
            block=int(meta["block"]), n0=int(meta["n0"]), normals=t("normals"), y=t("y"),
            noise_f=t("noise_f"), noise_g=t("noise_g"), n_touch=int(meta.get("n_touch", 0)),
            n_real=int(meta.get("n_real", 0)), pad_noise=float(meta.get("pad_noise", 1e10)))
    return convert.sharded_model_from_arrays(arrays, mesh, kernel=meta["kernel"], params=params,
                                             block=int(meta["block"]),
                                             n_real=int(meta.get("n_real", 0)),
                                             n_touch=int(meta.get("n_touch", 0)))
