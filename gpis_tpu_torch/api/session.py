"""ObjectModelSession, the user-facing orchestrator (port of
gpis_tpu/api/session.py:62-318 for the in-core value and joint models, the
out-of-core ones and the row-sharded value model).

World frame in, world frame out: the session owns the normalization Frame.
`start` fits: with `out_of_core=True` the panel-streamed fit
(`linalg.outofcore.ooc_fit`, or `ooc_fit_joint` with `normals=`), whose W
panels are then pinned on the card as far as it has room; with `normals=`
the joint value + gradient model (`gp.derivative.fit_with_normals`, then W
once 4C >= 1024); otherwise a session with `touch_capacity == 0` takes the
one-matrix-peak `fit_inference`, any other `fit` + `with_linv`.  With
`mesh=MeshConfig(n_devices=P)`, P > 1, the session is one rank of a
row mesh (`parallel.mesh`): every rank constructs it and calls each verb
with the same arguments, and `start` fits the row-sharded value model
(`gp.sharded_model.fit_sharded`) on rank 0's cloud, which it broadcasts.
`query`, `evaluate_grid`, `extract_surface` and `surface_points` serve the
fitted model; `update` borders tactile points into it (a joint model past
its touch slots is refit with every touch folded into its core).  The
verbs not yet ported raise NotImplementedError naming the ROADMAP.md §1
item that ports them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gpis_tpu_torch._build import not_ported, resolve_device
from gpis_tpu_torch.config import MeshConfig, ModelConfig
from gpis_tpu_torch.data import gpis, voxel
from gpis_tpu_torch.gp import derivative as gpd
from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.gp import sharded_model as gsm
from gpis_tpu_torch.gp.kinds import model_kind
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.linalg import outofcore as ooc
from gpis_tpu_torch.parallel.mesh import make_row_mesh
from gpis_tpu_torch.surface import grid as grid_mod
from gpis_tpu_torch.surface import marching, projection

__all__ = ["ObjectModelSession"]


def _joint_obs(ts, normals, points, cfg):
    """Gradient observations of a joint fit: the cloud's unit normals on the
    training set's surface rows (internal and external label points observe
    values only: pad-noise gradients), and the gradient noise, ten times the
    surface noise (port of gpis_tpu/api/session.py:41-59)."""
    normals = np.asarray(normals, cfg.dtype)
    if normals.shape != points.shape:
        raise ValueError("normals must match the point cloud shape")
    n_s, c = ts.n_surface, ts.x.shape[0]
    unit = normals / np.linalg.norm(normals, axis=1, keepdims=True)
    nrm_full = torch.zeros((c, 3), dtype=ts.x.dtype, device=ts.x.device)
    nrm_full[:n_s] = torch.as_tensor(unit, dtype=ts.x.dtype, device=ts.x.device)
    noise_g = torch.full((c,), cfg.pad_noise, dtype=ts.x.dtype, device=ts.x.device)
    noise_g[:n_s] = cfg.noise_surface * 10.0
    return nrm_full, noise_g


def _ooc_panel(rows: int) -> int:
    """The JAX session's out-of-core panel width for a factor of `rows` rows
    (n for a value fit, 4n with normals)."""
    return 4096 if rows > 20480 else (1024 if rows > 2048 else 256)


def _broadcast_cloud(points: np.ndarray, mesh) -> np.ndarray:
    """Rank 0's cloud on every rank: its length, then its points."""
    n = torch.tensor([len(points)], dtype=torch.int64, device=mesh.device)
    torch.distributed.broadcast(n, src=0)
    if mesh.rank == 0:
        buf = torch.as_tensor(np.ascontiguousarray(points), device=mesh.device)
    else:
        buf = torch.empty((int(n.item()), 3), dtype=getattr(torch, str(points.dtype)),
                          device=mesh.device)
    torch.distributed.broadcast(buf, src=0)
    return buf.cpu().numpy()


class ObjectModelSession:
    """Fit / query loop over one object model on one device, or on one rank
    of a row mesh."""

    def __init__(self, config: ModelConfig | None = None, explore=None,
                 mesh: MeshConfig | None = None, *, device="cuda"):
        if explore is not None:
            not_ported("explore= (ExploreConfig)", 8, "explore/atlas.py and explore/planner.py")
        self.config = config or ModelConfig()
        self.mesh_config = mesh
        self.mesh = None
        if mesh is not None and mesh.n_devices > 1:
            self.mesh = make_row_mesh(mesh.n_devices, device=device)
            self.device = self.mesh.device
        else:
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
              experts: int = 0, expert_gate: int = 0, expert_beta: str = "rbcm"):
        """Downsample, normalize, label and fit an (N,3) world-frame cloud.
        With `normals` (N,3), surface orientation becomes derivative
        observations and the model is the joint system (`gp.derivative`).
        `out_of_core=True` fits through the panel-streamed factorization
        (`linalg.outofcore`), for clouds whose one-matrix factor does not
        fit on the card.  On a mesh every rank fits rank 0's cloud.
        `experts`, `expert_gate` and `expert_beta` (the committee fit) take
        only their defaults until the committee is ported."""
        if experts or expert_gate or expert_beta != "rbcm":
            not_ported("experts=, expert_gate=, expert_beta= (committee fits)", 13,
                       "gp/experts.py")
        t0 = time.perf_counter()
        points = np.asarray(points, dtype=self.config.dtype)
        if points.ndim != 2 or points.shape[1] != 3 or len(points) == 0:
            raise ValueError(f"expected a non-empty (N, 3) point cloud, got shape {points.shape}")
        if self.mesh is not None:
            if out_of_core:
                raise ValueError("out_of_core is the single-card beyond-memory path; "
                                 "use the sharded pipeline (config 5) on a mesh")
            if normals is not None:
                not_ported("normals= on a mesh (sharded joint fits)", 14, "gp/sharded_joint.py")
            points = _broadcast_cloud(points, self.mesh)
        cfg = self.config
        if cfg.voxel_leaf > 0:
            if normals is not None:
                points, normals = voxel.voxel_downsample_with_normals(points, normals,
                                                                      cfg.voxel_leaf)
                points = points.astype(cfg.dtype)
            else:
                points = voxel.voxel_downsample(points, cfg.voxel_leaf).astype(cfg.dtype)
        ts = gpis.build_training_set(points, cfg, device=self.device)
        self.training = ts
        self.frame = ts.frame
        params = params or kf.kernel_params(cfg.lengthscale, cfg.signal_variance)
        if out_of_core:
            n = ts.x.shape[0]
            if normals is not None:
                nrm_full, noise_g = _joint_obs(ts, normals, points, cfg)
                self.model = ooc.ooc_fit_joint(
                    cfg.kernel, ts.x, ts.y, nrm_full, ts.noise, noise_g, params,
                    panel=_ooc_panel(4 * n), pad_noise=cfg.pad_noise)
            else:
                self.model = ooc.ooc_fit(cfg.kernel, ts.x, ts.y, ts.noise, params,
                                         panel=_ooc_panel(n), pad_noise=cfg.pad_noise)
            # Queries outnumber fits in a session: pin spilled W panels on
            # the card the fit's working set has freed.
            self.model.promote_for_serving()
        elif normals is not None:
            nrm_full, noise_g = _joint_obs(ts, normals, points, cfg)
            self.model = gpd.fit_with_normals(
                cfg.kernel, ts.x, ts.y, nrm_full, ts.noise, noise_g, params, block=cfg.block,
                touch_capacity=cfg.touch_capacity, pad_noise=cfg.pad_noise)
            if 4 * self.model.capacity >= 1024:
                self.model = gpd.with_linv_joint(self.model)
        elif self.mesh is not None:
            self.model = gsm.fit_sharded(
                cfg.kernel, ts.x, ts.y, ts.noise, params, self.mesh, block=self.mesh_config.block,
                touch_capacity=cfg.touch_capacity, pad_noise=cfg.pad_noise)
        elif cfg.touch_capacity == 0:
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

    def surface_points(self, seeds_world=None, n: int = 256):
        """Points on the estimated surface: seeds (world frame; by default n
        points of the unit sphere in the normalized frame) Newton-projected
        onto f = 0 (`surface.projection`).  Returns (the converged points in
        the world frame, the converged mask), as numpy."""
        self._require_model()
        if seeds_world is None:
            seeds = torch.as_tensor(gpis.fibonacci_sphere(n, radius=1.0).astype(self.config.dtype),
                                    device=self.device)
        else:
            seeds = self.frame.to_normalized(torch.as_tensor(
                np.asarray(seeds_world, self.config.dtype), device=self.device))
        pts, ok = projection.project_points(self.model, seeds)
        ok = ok.cpu().numpy()
        return self.frame.to_world(pts).cpu().numpy()[ok], ok

    def update(self, touch_points_world, *, targets=None):
        """Append tactile points (world frame; targets 0, the surface, by
        default) with the config's touch noise.  An in-core value model
        borders them into its touch slots (`gp.regression.update`; overflow
        raises); a joint one likewise (`gp.derivative.update_joint`) while
        slots last, and past them refits with every touch so far folded into
        the core observations (value-only: zero normals, pad-noise
        gradients), the old model released first; an out-of-core model
        borders them into its in-core tail of max(touch_capacity, 64) slots
        (`linalg.outofcore.ooc_update`); a sharded one into its last band's
        slots (`ShardedGPModel.update`)."""
        self._require_model()
        kind = model_kind(self.model)
        cfg = self.config
        pts = self.frame.to_normalized(torch.as_tensor(
            np.asarray(touch_points_world, cfg.dtype), device=self.device))
        y = (torch.zeros(pts.shape[0], dtype=pts.dtype, device=self.device) if targets is None
             else torch.as_tensor(targets, dtype=pts.dtype, device=self.device))
        if kind in ("ooc", "ooc_joint"):
            self.model = self.model.update(pts, y, cfg.noise_touch,
                                           tail_capacity=max(int(cfg.touch_capacity), 64))
        elif kind == "sharded":
            self.model = self.model.update(pts, y, cfg.noise_touch)
        elif kind == "joint":
            self._update_joint(pts, y)
        else:
            self.model = gpr.update(self.model, pts, y, cfg.noise_touch)
        self._sync()
        return self

    def _update_joint(self, pts, y):
        m = self.model
        # As in the JAX session, the list of touches is never cleared, not
        # even by a later start().
        self._touches = getattr(self, "_touches", [])
        self._touches.append((pts.cpu().numpy(), y.cpu().numpy()))
        if m.touch_x is not None and int(m.n_touch) + pts.shape[0] <= m.touch_capacity:
            self.model = gpd.update_joint(m, pts, y, self.config.noise_touch)
            return
        ts, cfg = self.training, self.config
        tx = torch.as_tensor(np.concatenate([t[0] for t in self._touches]), device=self.device)
        ty = torch.as_tensor(np.concatenate([t[1] for t in self._touches]), device=self.device)
        c0, dt = ts.x.shape[0], ts.x.dtype
        x = torch.cat([ts.x, tx.to(dt)])
        yv = torch.cat([ts.y, ty.to(dt)])
        nrm = torch.cat([m.normals[:c0], torch.zeros((len(tx), 3), dtype=dt, device=self.device)])
        noise_f = torch.cat([ts.noise, torch.full((len(tx),), cfg.noise_touch, dtype=dt,
                                                  device=self.device)])
        noise_g = torch.cat([m.noise_g[:c0], torch.full((len(tx),), cfg.pad_noise, dtype=dt,
                                                        device=self.device)])
        kernel, params = m.kernel, m.params
        # The old joint factor and W go before the refit builds new ones:
        # both alive at once would double the peak.
        del m
        self.model = None
        self.model = gpd.fit_with_normals(kernel, x, yv, nrm, noise_f, noise_g, params,
                                          block=cfg.block, pad_noise=cfg.pad_noise,
                                          touch_capacity=cfg.touch_capacity)
        if 4 * self.model.capacity >= 1024:
            self.model = gpd.with_linv_joint(self.model)

    def next_best_path(self, *, seed_world=None):
        not_ported("next_best_path", 8, "explore/atlas.py and explore/planner.py")

    def is_done(self, n_probe: int = 256) -> bool:
        not_ported("is_done", 8, "explore/planner.py")

    def export_exploration(self, html_path: str, resolution: int = 32):
        not_ported("export_exploration", 16, "viz/export.py")

    def optimize_hyperparameters(self, **kw):
        not_ported("optimize_hyperparameters", 10, "config 3")

    def save(self, path: str):
        not_ported("save", 9, "utils/checkpoint.py (gpis_tpu_torch.convert reads JAX checkpoints)")

    @classmethod
    def load(cls, path: str, config: ModelConfig | None = None, **kw):
        not_ported("load", 9, "utils/checkpoint.py (gpis_tpu_torch.convert reads JAX checkpoints)")

    def restore(self, path: str):
        not_ported("restore", 9, "utils/checkpoint.py (gpis_tpu_torch.convert reads JAX checkpoints)")
