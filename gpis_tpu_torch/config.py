"""Configuration system: the port's own copy of gpis_tpu/config.py, so the
port imports nothing of the JAX package (rebuild of reference component C9,
SURVEY.md §3).  Fields and defaults are the JAX package's, field for field.

The reference (`pacman-project/gaussian-object-modelling`) configures its node
through the ROS parameter server + launch-file args + YAML: kernel type,
length-scale, noise variances, voxel-downsample leaf size, variance threshold
for exploration termination, and the enclosing-sphere radius used for the
external GPIS label points.  (Reference mount was empty at survey time — see
SURVEY.md §0 — so semantics are reconstructed from SURVEY.md §3 C9/§6, not
cited by file:line.)

Here the same knobs live in frozen dataclasses, loadable from YAML or CLI
flags, so reference-equivalent configurations are expressible without any
middleware.  `MeshConfig` is new (the reference is single-process): it
describes the TPU device mesh + block sizes used by the sharded paths.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping

__all__ = [
    "ModelConfig",
    "ExploreConfig",
    "MeshConfig",
    "load_config",
    "config_from_dict",
]

_KERNELS = ("rbf", "thin_plate", "laplace", "inverse_multiquadric")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """GPIS model hyperparameters (reference C9 YAML params, SURVEY.md §3)."""

    # Covariance function: one of rbf | thin_plate | laplace | inverse_multiquadric.
    kernel: str = "rbf"
    # Kernel length-scale (RBF/Laplace) or thin-plate scale R.
    lengthscale: float = 1.0
    # Signal variance sigma_f^2 multiplier.
    signal_variance: float = 1.0
    # Observation noise variances by GPIS label role.
    noise_surface: float = 1e-4
    noise_internal: float = 1e-4
    noise_external: float = 1e-4
    # Noise for tactile (touch) points appended during exploration: trusted more.
    noise_touch: float = 1e-6
    # GPIS labels (Williams & Fitzgibbon convention; SURVEY.md §1 step 2).
    label_surface: float = 0.0
    label_internal: float = -1.0
    label_external: float = 1.0
    # Radius of the enclosing sphere of external points (after unit-sphere
    # normalization of the cloud).
    external_radius: float = 2.0
    n_external: int = 64
    n_internal: int = 1
    # Voxel-grid downsample leaf size (0 disables), in normalized units.
    voxel_leaf: float = 0.0
    # Dense query grid resolution per axis (config 4) and half-extent.
    grid_resolution: int = 64
    grid_extent: float = 1.6
    # Compute dtype on device ("float32" on TPU; tests use "float64" on CPU).
    dtype: str = "float32"
    # Training-set capacity padding: arrays are padded to a multiple of this
    # (static shapes under jit; padding rows carry `pad_noise`).
    block: int = 128
    pad_noise: float = 1e12
    # Extra touch-point capacity preallocated for incremental updates.
    touch_capacity: int = 256

    def __post_init__(self):
        if self.kernel not in _KERNELS:
            # A registered custom kernel is accepted too.
            from gpis_tpu_torch.kernels.functions import _REGISTRY

            if self.kernel in _REGISTRY:
                return
            raise ValueError(f"unknown kernel {self.kernel!r}; expected one of {_KERNELS}")


@dataclasses.dataclass(frozen=True)
class ExploreConfig:
    """Atlas/GPAtlasRRT planner knobs (reference C5/C6 params, SURVEY.md §3)."""

    # Global termination: stop when max posterior variance on the surface
    # drops below this (reference's variance threshold).
    variance_threshold: float = 0.05
    # Chart disc radius bounds and variance shrink factor.
    radius_max: float = 0.35
    radius_min: float = 0.05
    variance_radius_gain: float = 1.0
    # Candidate samples on each chart's disc boundary per expansion round.
    n_disc_samples: int = 32
    # Maximum charts in the tree / expansion rounds.
    max_charts: int = 64
    # Newton projection iterations/tolerance for re-projection onto f=0.
    projection_iters: int = 20
    projection_tol: float = 1e-6
    # Exploration strategy: "single_path" (greedy chain) or "multi_branch".
    strategy: str = "single_path"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """TPU device-mesh + blocking description (new; SURVEY.md §3 parallelism table)."""

    # Number of devices along the row-sharding axis ('row'); 1 = single-chip
    # (the sharded pipeline only engages when this is explicitly > 1).
    n_devices: int = 1
    axis_name: str = "row"
    # Block edge for the blocked/sharded Cholesky and Gram tiling.
    block: int = 256
    # Query-grid chunk for ring-rotation cross-covariance.
    query_chunk: int = 4096


def config_from_dict(d: Mapping[str, Any]) -> tuple[ModelConfig, ExploreConfig, MeshConfig]:
    """Build the three config dataclasses from one flat/nested mapping."""

    def pick(cls, section):
        src = dict(d.get(section, {}))
        # Also accept flat keys for convenience.
        names = {f.name for f in dataclasses.fields(cls)}
        for k, v in d.items():
            if k in names and not isinstance(v, Mapping):
                src.setdefault(k, v)
        return cls(**{k: v for k, v in src.items() if k in names})

    return pick(ModelConfig, "model"), pick(ExploreConfig, "explore"), pick(MeshConfig, "mesh")


def load_config(path: str) -> tuple[ModelConfig, ExploreConfig, MeshConfig]:
    """Load configs from a YAML or JSON file.

    YAML support uses pyyaml when present; JSON always works (a YAML subset
    parser is deliberately not hand-rolled — configs in tests ship as JSON).
    """
    text = open(path).read()
    if path.endswith((".yaml", ".yml")):
        try:
            import yaml  # type: ignore

            data = yaml.safe_load(text)
        except ImportError as e:  # pragma: no cover - env provides pyyaml via jax deps
            raise RuntimeError("YAML config requires pyyaml; use JSON instead") from e
    else:
        data = json.loads(text)
    return config_from_dict(data or {})
