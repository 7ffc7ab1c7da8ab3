"""Carry a model fitted by the JAX package across to the port (builds the
in-core value and joint models from the arrays of the checkpoint layout,
gpis_tpu/utils/checkpoint.py:24-85, an out-of-core model from its arrays
and W panels, and a rank's sharded model from the whole arrays).

A `gpis_tpu` checkpoint is an `.npz` of numpy arrays plus a JSON `meta`
entry; `load_jax_checkpoint` reads it through the port's own
`utils.checkpoint.load_model`, which writes the same layout.  A committee
(`ExpertGPModel`) crosses over through `experts_model_from_arrays`.  An
out-of-core model in memory crosses over through `ooc_model_from_arrays`,
a sharded one through `sharded_model_from_arrays`.
"""

from __future__ import annotations

import numpy as np
import torch

from gpis_tpu_torch._build import resolve_device
from gpis_tpu_torch.gp.derivative import DerivGPModel
from gpis_tpu_torch.gp.experts import ExpertGPModel
from gpis_tpu_torch.gp.model import GPModel
from gpis_tpu_torch.gp.sharded_model import ShardedGPModel
from gpis_tpu_torch.linalg.outofcore import DevicePanelStore, OOCJointModel, OOCModel

__all__ = ["gp_model_from_arrays", "experts_model_from_arrays", "ooc_model_from_arrays",
           "sharded_model_from_arrays", "load_jax_checkpoint"]

_NOT_IN_CORE = ("sharded", "ooc")


def _joint_model(t, meta: dict, params: dict) -> DerivGPModel:
    """A `gpis_tpu` DerivGPModel's arrays (x, y, normals, noise_f, noise_g,
    alpha, chol, linv, touch_*) as the port's DerivGPModel."""
    touch = {}
    if meta.get("joint_touch"):
        touch = dict(touch_x=t("touch_x"), touch_y=t("touch_y"), touch_noise=t("touch_noise"),
                     n_touch=int(meta["n_touch"]))
    return DerivGPModel(
        x=t("x"), y=t("y"), normals=t("normals"), noise_f=t("noise_f"), noise_g=t("noise_g"),
        params=params, chol=t("chol"), alpha=t("alpha"), kernel=meta["kernel"],
        n0=int(meta["n0"]), linv=t("linv") if meta.get("has_linv") else None, **touch,
    )


def gp_model_from_arrays(arrays, meta: dict, device="cuda", *, chol=None):
    """The port's model from a `gpis_tpu` model's numpy arrays, under the
    checkpoint's key names (x, y, noise, alpha, chol, linv,
    param_lengthscale, param_signal_variance, n_touch; a joint model's
    normals, noise_f, noise_g and touch_*) and metadata (kernel, n0,
    pad_noise, linv_is_chol, joint): a GPModel or a DerivGPModel, or with
    meta "experts" the committee of `experts_model_from_arrays`.  `chol`,
    a tensor on `device`, stands in for arrays["chol"] (a factor refit on
    loading a checkpoint saved without it)."""
    if meta.get("experts"):
        return experts_model_from_arrays(arrays, meta, device)
    for kind in _NOT_IN_CORE:
        if meta.get(kind):
            raise ValueError(f"{kind} arrays are not an in-core model's "
                             "(utils.checkpoint.load_model reads every kind of checkpoint)")
    if chol is None and "chol" not in arrays:
        raise ValueError("checkpoint carries no factor (saved with factor=False)")
    dev = resolve_device(device)

    def t(key):
        if key == "chol" and chol is not None:
            return chol
        return torch.as_tensor(np.asarray(arrays[key]), device=dev)

    params = {"lengthscale": float(arrays["param_lengthscale"]),
              "signal_variance": float(arrays["param_signal_variance"])}
    if meta.get("joint"):
        return _joint_model(t, meta, params)
    factor = t("chol")
    if meta.get("linv_is_chol"):
        linv = factor  # a fit_inference model: its chol field is W
    elif meta.get("has_linv"):
        linv = t("linv")
    else:
        linv = None
    return GPModel(
        x=t("x"), y=t("y"), noise=t("noise"), params=params,
        chol=factor, alpha=t("alpha"), n_touch=int(arrays["n_touch"]),
        kernel=meta["kernel"], n0=int(meta["n0"]),
        pad_noise=float(meta.get("pad_noise", 1e10)), linv=linv,
    )


def experts_model_from_arrays(arrays, meta: dict, device="cuda") -> ExpertGPModel:
    """The port's ExpertGPModel from a `gpis_tpu` committee's numpy arrays
    under the checkpoint's keys (x, y, noise, alpha, n_touch, centroids,
    param_*, chol and linv where meta has_chol / has_linv says; a joint
    committee's normals, noise_g and touch_*) and metadata (kernel, n0,
    pad_noise, beta, gate, experts_joint).  Without chol, chol is None (the
    committee serves from W; `experts.expert_chol` refactors on demand)."""
    dev = resolve_device(device)

    def t(key):
        return torch.as_tensor(np.asarray(arrays[key]), device=dev)

    extra = {}
    if meta.get("experts_joint"):
        extra = {k: t(k) for k in ("normals", "noise_g", "touch_x", "touch_y", "touch_noise")
                 if k in arrays}
    has = meta["has_factor"]
    return ExpertGPModel(
        x=t("x"), y=t("y"), noise=t("noise"),
        params={"lengthscale": float(arrays["param_lengthscale"]),
                "signal_variance": float(arrays["param_signal_variance"])},
        chol=t("chol") if has and meta.get("has_chol", True) and "chol" in arrays else None,
        alpha=t("alpha"), linv=t("linv") if meta.get("has_linv") else None,
        n_touch=np.asarray(arrays["n_touch"], np.int32).copy(), centroids=t("centroids"),
        kernel=meta["kernel"], n0=int(meta["n0"]), pad_noise=float(meta["pad_noise"]),
        beta=meta["beta"], gate=int(meta["gate"]), **extra)


_OOC_TAIL = ("u", "alpha0", "tail_x", "tail_y", "tail_noise", "tail_v", "tail_a", "tail_chol",
             "tail_alpha")


def ooc_model_from_arrays(arrays, panels, *, kernel: str, params, panel: int, n_real: int,
                          device="cuda"):
    """The port's OOCModel (or OOCJointModel, when `arrays` has "meta") from
    a `gpis_tpu` out-of-core model: its arrays (x, y, noise, alpha; a joint
    model's meta, normals, noise_g; u for updates, u and the scalar
    logdiag_sum for `log_marginal_likelihood`, and after updates alpha0,
    n_tail and the tail_* arrays) and its W panels in order, trimmed as
    stored, all numpy.  The panels go to a device store on `device`."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), device=dev)

    wstore = DevicePanelStore(dev)
    for j, w in enumerate(panels):
        wstore.put(j, t(w))
    common = dict(kernel=kernel, x=t(arrays["x"]), y=t(arrays["y"]), noise=t(arrays["noise"]),
                  params={k: float(v) for k, v in params.items()}, alpha=t(arrays["alpha"]),
                  wstore=wstore, panel=int(panel), n_real=int(n_real),
                  n_tail=int(arrays["n_tail"]) if "n_tail" in arrays else 0,
                  logdiag_sum=(None if arrays.get("logdiag_sum") is None
                               else float(arrays["logdiag_sum"])),
                  **{k: t(arrays[k]) for k in _OOC_TAIL
                     if k in arrays and arrays[k] is not None})
    if "meta" in arrays:
        return OOCJointModel(meta=t(arrays["meta"]), normals=t(arrays["normals"]),
                             noise_g=t(arrays["noise_g"]), n0=int(np.shape(arrays["x"])[0]),
                             **common)
    return OOCModel(**common)


def sharded_model_from_arrays(arrays, mesh, *, kernel: str, params, block: int, n_real: int,
                              n_touch: int = 0) -> ShardedGPModel:
    """This rank's ShardedGPModel on `mesh` from a `gpis_tpu` sharded
    model's whole arrays as numpy: x, y, noise, alpha, and the (C, C) l and
    w, of which the rank keeps its row band."""
    row0, rows = mesh.band(np.shape(arrays["l"])[0])

    def t(a):
        return torch.as_tensor(np.array(a), device=mesh.device)

    return ShardedGPModel(
        kernel=kernel, x=t(arrays["x"]), y=t(arrays["y"]), noise=t(arrays["noise"]),
        params={k: float(v) for k, v in params.items()},
        l=t(np.asarray(arrays["l"])[row0:row0 + rows]),
        w=t(np.asarray(arrays["w"])[row0:row0 + rows]), alpha=t(arrays["alpha"]), mesh=mesh,
        block=int(block), n0=int(np.shape(arrays["x"])[0]), n_touch=int(n_touch),
        n_real=int(n_real))


def load_jax_checkpoint(path: str, device="cuda"):
    """Read a checkpoint written by `gpis_tpu.utils.checkpoint.save_model`
    (`utils.checkpoint.load_model`)."""
    from gpis_tpu_torch.utils import checkpoint

    return checkpoint.load_model(path, device=device)
