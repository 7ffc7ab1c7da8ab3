"""The model-kind discriminator for every polymorphic verb (port of
gpis_tpu/gp/kinds.py).

Matched on class names, not attributes, so a model that grows a stray
attribute cannot be mis-routed, and classifying a model imports nothing.
"""

from __future__ import annotations

__all__ = ["model_kind", "MODEL_KINDS"]

# kind -> class names that map to it.
MODEL_KINDS = {
    "ooc": ("OOCModel",),
    "ooc_joint": ("OOCJointModel",),
    "sharded": ("ShardedGPModel",),
    "sharded_joint": ("ShardedJointModel",),
    "experts": ("ExpertGPModel",),
    "joint": ("DerivGPModel",),
    "dense": ("GPModel",),
}

_BY_CLASS = {cls: kind for kind, classes in MODEL_KINDS.items() for cls in classes}


def model_kind(model) -> str:
    """"dense", "joint", "sharded", "sharded_joint", "experts", "ooc" or
    "ooc_joint" for a fitted model.  Anything else raises
    TypeError: an unknown model fails at the dispatch point rather than
    falling through to the dense path."""
    for cls in type(model).__mro__:
        kind = _BY_CLASS.get(cls.__name__)
        if kind is not None:
            return kind
    raise TypeError(f"unknown model type {type(model).__name__!r}; register it in "
                    "gpis_tpu_torch.gp.kinds.MODEL_KINDS")
