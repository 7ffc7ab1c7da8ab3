"""GPIS training-set construction (port of gpis_tpu/data/gpis.py:25-110).

De-mean and scale the cloud into the unit sphere, label surface points 0,
internal points -1 at or near the centroid and external points +1 on an
enclosing sphere, with per-role noise.  Row order: surface, internal,
external.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpis_tpu_torch.config import ModelConfig
from gpis_tpu_torch._build import resolve_device
from gpis_tpu_torch.utils import profiling

__all__ = ["Frame", "TrainingSet", "normalize_cloud", "build_training_set", "fibonacci_sphere"]


@dataclasses.dataclass(frozen=True)
class Frame:
    """Similarity transform between world and normalized (unit-sphere)
    frames: x_norm = (x_world - centroid) / scale."""

    centroid: torch.Tensor  # (3,)
    scale: torch.Tensor  # ()

    def to_normalized(self, x):
        return (x - self.centroid) / self.scale

    def to_world(self, x):
        return x * self.scale + self.centroid


@dataclasses.dataclass(frozen=True)
class TrainingSet:
    x: torch.Tensor  # (N, 3) normalized-frame positions
    y: torch.Tensor  # (N,) labels
    noise: torch.Tensor  # (N,) per-point observation variance
    frame: Frame
    n_surface: int
    n_internal: int
    n_external: int


def normalize_cloud(points: torch.Tensor) -> tuple[torch.Tensor, Frame]:
    """Centroid-center and scale the cloud into the unit sphere."""
    centroid = points.mean(dim=0)
    centered = points - centroid
    scale = torch.linalg.norm(centered, dim=1).max()
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    return centered / scale, Frame(centroid=centroid, scale=scale)


def fibonacci_sphere(n: int, radius: float = 1.0, dtype=np.float64) -> np.ndarray:
    """Deterministic quasi-uniform points on a sphere (external label shell)."""
    i = np.arange(n, dtype=dtype) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + np.sqrt(5.0)) * i
    return radius * np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], axis=1
    )


def build_training_set(points, cfg: ModelConfig, normals=None, *, device="cuda") -> TrainingSet:
    """Cloud (world frame, (N,3) array or tensor) -> training set in the
    normalized frame on `device`, in the cloud's dtype.  `normals` is
    accepted and unused, as in the JAX package: the session hands normals to
    the joint fit itself."""
    dev = resolve_device(device)
    with profiling.wait("training.upload"):
        pts = torch.as_tensor(np.asarray(points), device=dev)
    surf, frame = normalize_cloud(pts)
    dt = surf.dtype
    n_s = surf.shape[0]
    if cfg.n_internal > 1:
        # Extra internal points spread on a small inner sphere.
        internal = torch.as_tensor(fibonacci_sphere(cfg.n_internal, 0.1), dtype=dt, device=dev)
    else:
        internal = torch.zeros((cfg.n_internal, 3), dtype=dt, device=dev)
    with profiling.wait("training.upload"):
        external = torch.as_tensor(fibonacci_sphere(cfg.n_external, cfg.external_radius),
                                   dtype=dt, device=dev)

    def full(n, v):
        return torch.full((n,), v, dtype=dt, device=dev)

    return TrainingSet(
        x=torch.cat([surf, internal, external]),
        y=torch.cat([full(n_s, cfg.label_surface), full(cfg.n_internal, cfg.label_internal),
                     full(cfg.n_external, cfg.label_external)]),
        noise=torch.cat([full(n_s, cfg.noise_surface), full(cfg.n_internal, cfg.noise_internal),
                         full(cfg.n_external, cfg.noise_external)]),
        frame=frame, n_surface=n_s, n_internal=cfg.n_internal, n_external=cfg.n_external,
    )
