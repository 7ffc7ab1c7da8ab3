"""ObjectModelSession, the user-facing orchestrator (port of
gpis_tpu/api/session.py:62-318 for the in-core value model).

World frame in, world frame out: the session owns the normalization Frame.
`start` fits: a session with `touch_capacity == 0` takes the one-matrix-peak
`fit_inference`, any other `fit` + `with_linv`.  `query`, `evaluate_grid`
and `extract_surface` serve the fitted model.  The verbs not yet ported
raise NotImplementedError naming the ROADMAP.md §1 item that ports them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gpis_tpu.config import MeshConfig, ModelConfig
from gpis_tpu.data import voxel
from gpis_tpu.surface import marching
from gpis_tpu_torch._build import resolve_device
from gpis_tpu_torch.data import gpis
from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.surface import grid as grid_mod

__all__ = ["ObjectModelSession"]


def _not_ported(what: str, item: int, name: str):
    raise NotImplementedError(
        f"{what} is not ported to gpis_tpu_torch yet (ROADMAP.md §1 item {item}: {name})"
    )


class ObjectModelSession:
    """Fit / query loop over one object model on one device."""

    def __init__(self, config: ModelConfig | None = None, *, mesh: MeshConfig | None = None,
                 device="cuda"):
        if mesh is not None and mesh.n_devices > 1:
            _not_ported("mesh= (sharded fits)", 14, "multi-GPU")
        self.config = config or ModelConfig()
        self.device = resolve_device(device)
        self.dtype = getattr(torch, self.config.dtype)
        self.model = None
        self.frame = None
        self.training = None
        self.stats: dict[str, float] = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self, points, *, normals=None, params=None, out_of_core: bool = False,
              experts: int = 0):
        """Downsample, normalize, label and fit an (N,3) world-frame cloud."""
        if normals is not None:
            _not_ported("normals= (joint value+gradient fits)", 11, "config 2")
        if experts:
            _not_ported("experts= (committee fits)", 13, "gp/experts.py")
        if out_of_core:
            _not_ported("out_of_core=", 15, "out-of-core")
        t0 = time.perf_counter()
        points = np.asarray(points, dtype=self.config.dtype)
        if points.ndim != 2 or points.shape[1] != 3 or len(points) == 0:
            raise ValueError(f"expected a non-empty (N, 3) point cloud, got shape {points.shape}")
        cfg = self.config
        if cfg.voxel_leaf > 0:
            points = voxel.voxel_downsample(points, cfg.voxel_leaf).astype(cfg.dtype)
        ts = gpis.build_training_set(points, cfg, device=self.device)
        self.training = ts
        self.frame = ts.frame
        params = params or kf.kernel_params(cfg.lengthscale, cfg.signal_variance)
        if cfg.touch_capacity == 0:
            self.model = gpr.fit_inference(cfg.kernel, ts.x, ts.y, ts.noise, params,
                                           block=cfg.block, pad_noise=cfg.pad_noise)
        else:
            self.model = gpr.with_linv(gpr.fit(
                cfg.kernel, ts.x, ts.y, ts.noise, params, block=cfg.block,
                touch_capacity=cfg.touch_capacity, pad_noise=cfg.pad_noise))
        self._sync()
        self.stats["fit_s"] = time.perf_counter() - t0
        return self

    def _require_model(self):
        if self.model is None:
            raise RuntimeError("no model fitted yet; call start(points) first")

    def query(self, points_world):
        """Posterior (mean, variance) at world-frame points, as numpy."""
        self._require_model()
        q = torch.as_tensor(np.asarray(points_world, self.config.dtype), device=self.device)
        mean, var = gpr.predict(self.model, self.frame.to_normalized(q))
        return mean.cpu().numpy(), var.cpu().numpy()

    def evaluate_grid(self, resolution=None, extent=None):
        """Dense posterior grid in the normalized frame, as numpy:
        (mean (R,R,R), var (R,R,R), axis (R,))."""
        self._require_model()
        t0 = time.perf_counter()
        mean, var, axis = grid_mod.evaluate_grid(
            self.model, resolution or self.config.grid_resolution,
            extent or self.config.grid_extent)
        out = mean.cpu().numpy(), var.cpu().numpy(), axis.cpu().numpy()
        self.stats["grid_s"] = time.perf_counter() - t0
        return out

    def extract_surface(self, resolution=None, extent=None, *, world_frame=True):
        """Isosurface mesh + per-vertex variance: (verts, faces, variance)."""
        mean, _, axis = self.evaluate_grid(resolution, extent)
        verts, faces = marching.marching_tetrahedra(mean, axis)
        verts_n = torch.as_tensor(verts.astype(self.config.dtype), device=self.device)
        vvar = grid_mod.evaluate_points_chunked(self.model, verts_n)[1].cpu().numpy()
        if world_frame:
            verts = self.frame.to_world(verts_n).cpu().numpy()
        return verts, faces, vvar

    # Verbs of the JAX session that later ports bring over.
    def update(self, touch_points_world, *, targets=None):
        _not_ported("update (tactile bordering updates)", 7, "session half of gp/regression.py")

    def next_best_path(self, *, seed_world=None):
        _not_ported("next_best_path", 8, "explore/atlas.py and explore/planner.py")

    def optimize_hyperparameters(self, **kw):
        _not_ported("optimize_hyperparameters", 10, "config 3")

    def save(self, path: str):
        _not_ported("save", 9, "utils/checkpoint.py (gpis_tpu_torch.convert reads JAX checkpoints)")

    @classmethod
    def load(cls, path: str, config: ModelConfig | None = None, **kw):
        _not_ported("load", 9, "utils/checkpoint.py (gpis_tpu_torch.convert reads JAX checkpoints)")
