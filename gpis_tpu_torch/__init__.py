"""gpis_tpu_torch: the PyTorch / CUDA port of gpis-tpu for one NVIDIA H100.

The JAX package `gpis_tpu` stays the reference; this package mirrors its
module names.  Plain tensor code is PyTorch; every TPU kernel on the ported
path is a hand-written CUDA kernel for sm_90a (`csrc/`, built on first use
by `_build`), each with a plain PyTorch twin that a CPU tensor goes to.

    from gpis_tpu_torch import ObjectModelSession, ModelConfig
    sess = ObjectModelSession(ModelConfig(kernel="rbf", touch_capacity=0))
    sess.start(points)                  # device="cuda" by default
    verts, faces, var = sess.extract_surface()

The device defaults to "cuda" and a missing card raises: pass device="cpu"
for the plain path.  Float32 matrix products and convolutions are held to
full float32 below (TF32 off): the variance quad cancels heavily and TF32's
~10-bit mantissa visibly corrupts it.
"""

import torch

from gpis_tpu_torch.config import ExploreConfig, MeshConfig, ModelConfig, load_config

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# The JAX package's public names and the port's own.
__all__ = [
    "ModelConfig",
    "ExploreConfig",
    "MeshConfig",
    "load_config",
    "ObjectModelSession",
    "fit",
    "fit_inference",
    "predict",
    "update",
    "fit_with_normals",
    "fit_experts",
    "fit_sharded",
    "fit_sharded_joint",
    "optimize_sharded",
    "optimize_ooc",
    "optimize_ooc_joint",
    "ooc_fit",
    "ooc_fit_joint",
    "ooc_update",
    "kernel_params",
    "register_kernel",
    "build_training_set",
    "load_cloud",
    "with_linv",
    "load_jax_checkpoint",
]
__version__ = "0.1.0"

_LAZY = {
    "ObjectModelSession": ("gpis_tpu_torch.api.session", "ObjectModelSession"),
    "fit": ("gpis_tpu_torch.gp.regression", "fit"),
    "fit_inference": ("gpis_tpu_torch.gp.regression", "fit_inference"),
    "predict": ("gpis_tpu_torch.gp.regression", "predict"),
    "update": ("gpis_tpu_torch.gp.regression", "update"),
    "fit_with_normals": ("gpis_tpu_torch.gp.derivative", "fit_with_normals"),
    "fit_experts": ("gpis_tpu_torch.gp.experts", "fit_experts"),
    "fit_sharded": ("gpis_tpu_torch.gp.sharded_model", "fit_sharded"),
    "fit_sharded_joint": ("gpis_tpu_torch.gp.sharded_joint", "fit_sharded_joint"),
    "optimize_sharded": ("gpis_tpu_torch.gp.sharded_hyperopt", "optimize_sharded"),
    "optimize_ooc": ("gpis_tpu_torch.gp.ooc_hyperopt", "optimize_ooc"),
    "optimize_ooc_joint": ("gpis_tpu_torch.gp.ooc_hyperopt", "optimize_ooc_joint"),
    "ooc_fit": ("gpis_tpu_torch.linalg.outofcore", "ooc_fit"),
    "ooc_fit_joint": ("gpis_tpu_torch.linalg.outofcore", "ooc_fit_joint"),
    "ooc_update": ("gpis_tpu_torch.linalg.outofcore", "ooc_update"),
    "kernel_params": ("gpis_tpu_torch.kernels.functions", "kernel_params"),
    "register_kernel": ("gpis_tpu_torch.kernels.functions", "register_kernel"),
    "build_training_set": ("gpis_tpu_torch.data.gpis", "build_training_set"),
    "load_cloud": ("gpis_tpu_torch.data.io", "load_cloud"),
    "with_linv": ("gpis_tpu_torch.gp.regression", "with_linv"),
    "load_jax_checkpoint": ("gpis_tpu_torch.convert", "load_jax_checkpoint"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(name)
