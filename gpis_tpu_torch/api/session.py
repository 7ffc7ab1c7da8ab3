"""ObjectModelSession, the user-facing orchestrator (port of
gpis_tpu/api/session.py: the in-core value and joint models, the
out-of-core ones, the committee and the row-sharded value and joint
models).

World frame in, world frame out: the session owns the normalization Frame.
`start` fits: with `out_of_core=True` the panel-streamed fit
(`linalg.outofcore.ooc_fit`, or `ooc_fit_joint` with `normals=`), whose W
panels are then pinned on the card as far as it has room; with `normals=`
the joint value + gradient model (`gp.derivative.fit_with_normals`, then W
once 4C >= 1024); otherwise a session with `touch_capacity == 0` takes the
one-matrix-peak `fit_inference`, any other `fit` + `with_linv`; with
`experts=E` a committee of E local GPs (`gp.experts.fit_experts`, or
`fit_experts_joint` with `normals=`), queried gated to `expert_gate`
nearest experts.  With
`mesh=MeshConfig(n_devices=P)`, P > 1, the session is one rank of a
row mesh (`parallel.mesh`): every rank constructs it and calls each verb
with the same arguments, and `start` fits the row-sharded value model
(`gp.sharded_model.fit_sharded`), or with `normals=` the sharded joint
model (`gp.sharded_joint.fit_sharded_joint`), on rank 0's cloud, which it
broadcasts; there `start` drops the old model before it fits, so a rank
holds one model's bands at a time (`reset` drops it on its own).
`query`, `evaluate_grid`, `extract_surface` and `surface_points` serve the
fitted model; `update` borders tactile points into it (a joint model past
its touch slots is refit with every touch folded into its core);
`next_best_path` grows the atlas toward high variance and `is_done` says
when the surface is known (`explore.planner`, with the session's
`ExploreConfig`); `optimize_hyperparameters` maximizes the marginal
likelihood (config 3) and refits with the optimum; `save`, `load` and
`restore` checkpoint the model and the frame (`utils.checkpoint`, the JAX
package's layout; an out-of-core model's W panels under `path + ".w/"`);
`export_exploration` writes the mesh, the charts and the next path into
one HTML viewer (`viz.export`).  The committee takes every verb: its touches route to
the nearest expert, and its hyperopt ("subsample" or "poe") refits the
committee and replays the routed touches.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gpis_tpu_torch._build import resolve_device
from gpis_tpu_torch.config import ExploreConfig, MeshConfig, ModelConfig
from gpis_tpu_torch.data import gpis, voxel
from gpis_tpu_torch.explore import planner
from gpis_tpu_torch.gp import derivative as gpd
from gpis_tpu_torch.gp import experts as gpe
from gpis_tpu_torch.gp import hyperopt as ho
from gpis_tpu_torch.gp import ooc_hyperopt as oho
from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.gp import sharded_hyperopt as sho
from gpis_tpu_torch.gp import sharded_joint as gsj
from gpis_tpu_torch.gp import sharded_model as gsm
from gpis_tpu_torch.gp.kinds import model_kind
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.linalg import outofcore as ooc
from gpis_tpu_torch.linalg import sharded as sh
from gpis_tpu_torch.parallel.mesh import make_row_mesh
from gpis_tpu_torch.surface import grid as grid_mod
from gpis_tpu_torch.surface import marching, projection
from gpis_tpu_torch.utils import checkpoint as ckpt
from gpis_tpu_torch.utils import profiling
from gpis_tpu_torch.viz import export

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
    """Rank 0's cloud (N, 3), or (N, 6) with its normals, on every rank: its
    length, then its rows."""
    n = sh._bcast_from(torch.tensor([len(points)], dtype=torch.int64, device=mesh.device), 0)
    if mesh.rank == 0:
        buf = torch.as_tensor(np.ascontiguousarray(points), device=mesh.device)
    else:
        buf = torch.empty((int(n.item()), points.shape[1]), dtype=getattr(torch, str(points.dtype)),
                          device=mesh.device)
    return sh._bcast_from(buf, 0).cpu().numpy()


class ObjectModelSession:
    """Fit / query loop over one object model on one device, or on one rank
    of a row mesh."""

    def __init__(self, config: ModelConfig | None = None, explore: ExploreConfig | None = None,
                 mesh: MeshConfig | None = None, *, device="cuda"):
        self.config = config or ModelConfig()
        self.explore_config = explore or ExploreConfig()
        self.mesh_config = mesh
        self.mesh = None
        if mesh is not None and mesh.n_devices > 1:
            self.mesh = make_row_mesh(mesh.n_devices, device=device)
            self.device = self.mesh.device
        else:
            self.device = resolve_device(device)
        self.dtype = getattr(torch, self.config.dtype)
        if self.device.type == "cuda" and self.dtype != torch.float32:
            raise ValueError(f"ModelConfig.dtype {self.config.dtype!r} on {self.device}: the "
                             "card's kernels take float32 (float64 runs on device='cpu')")
        self.model = None
        self.frame = None
        self.training = None
        self.stats: dict[str, float] = {}

    def reset(self):
        """Drop the fitted model so that its memory (on a mesh, this rank's
        bands of L and W) is free; `start` fits anew."""
        self.model = None

    def _sync(self):
        if self.device.type == "cuda":
            with profiling.wait("session.sync"):
                torch.cuda.synchronize(self.device)

    @profiling.spanned("session.start")
    def start(self, points, *, normals=None, params=None, out_of_core: bool = False,
              experts: int = 0, expert_gate: int = 0, expert_beta: str = "rbcm"):
        """Downsample, normalize, label and fit an (N,3) world-frame cloud.
        With `normals` (N,3), surface orientation becomes derivative
        observations and the model is the joint system (`gp.derivative`).
        `out_of_core=True` fits through the panel-streamed factorization
        (`linalg.outofcore`), for clouds whose one-matrix factor does not
        fit on the card.  On a mesh every rank fits rank 0's cloud.
        `experts=E` > 0 fits a committee of E local GPs sharing the label
        rows (`gp.experts`; `expert_beta` "rbcm" or "bcm", queries gated to
        the `expert_gate` nearest experts, 0 = all), with or without
        normals; it composes with neither out_of_core= nor a mesh.  With
        experts=0 the other two are unused, as in the JAX package."""
        t0 = time.perf_counter()
        points = np.asarray(points, dtype=self.config.dtype)
        if points.ndim != 2 or points.shape[1] != 3 or len(points) == 0:
            raise ValueError(f"expected a non-empty (N, 3) point cloud, got shape {points.shape}")
        if experts and out_of_core:
            raise ValueError(
                "experts= is the in-core committee path; it does not "
                "compose with out_of_core= (the committee exists so the "
                "factor never exceeds HBM — use one or the other)"
            )
        if experts and self.mesh is not None:
            raise ValueError(
                "experts= and mesh= are separate scaling axes; shard an "
                "expert model with gp.experts.shard_experts/"
                "predict_sharded directly"
            )
        if self.mesh is not None:
            if out_of_core:
                raise ValueError("out_of_core is the single-card beyond-memory path; "
                                 "use the sharded pipeline (config 5) on a mesh")
            if normals is not None:
                both = _broadcast_cloud(np.concatenate([points, np.asarray(
                    normals, dtype=points.dtype)], axis=1), self.mesh)
                points, normals = both[:, :3], both[:, 3:]
            else:
                points = _broadcast_cloud(points, self.mesh)
            # A rank holds one model's bands, not two: the old ones go before
            # the fit (at C 147,456 two models' bands are 87 GB a rank).
            self.reset()
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
        if experts:
            kw = dict(n_experts=int(experts), n_shared_tail=ts.n_internal + ts.n_external,
                      block=cfg.block, touch_capacity=cfg.touch_capacity,
                      pad_noise=cfg.pad_noise, beta=expert_beta, gate=int(expert_gate))
            if normals is not None:
                nrm_full, noise_g = _joint_obs(ts, normals, points, cfg)
                # Kept for the hyperopt refit: the stacked per-expert normals
                # cannot be taken apart again.
                self._joint_expert_obs = (nrm_full, noise_g)
                self.model = gpe.fit_experts_joint(cfg.kernel, ts.x, ts.y, nrm_full, ts.noise,
                                                   noise_g, params, **kw)
            else:
                self.model = gpe.fit_experts(cfg.kernel, ts.x, ts.y, ts.noise, params, **kw)
        elif out_of_core:
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
        elif normals is not None and self.mesh is not None:
            # Config 2 x config 5: the distributed joint fit.
            nrm_full, noise_g = _joint_obs(ts, normals, points, cfg)
            self.model = gsj.fit_sharded_joint(
                cfg.kernel, ts.x, ts.y, nrm_full, ts.noise, noise_g, params, self.mesh,
                block=self.mesh_config.block, pad_noise=cfg.pad_noise,
                touch_capacity=cfg.touch_capacity)
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

    @profiling.spanned("session.query")
    def query(self, points_world):
        """Posterior (mean, variance) at world-frame points, as numpy."""
        self._require_model()
        q = torch.as_tensor(np.asarray(points_world, self.config.dtype), device=self.device)
        mean, var = gpr.predict(self.model, self.frame.to_normalized(q))
        with profiling.wait("session.copy", 2):
            return mean.cpu().numpy(), var.cpu().numpy()

    @profiling.spanned("session.evaluate_grid")
    def evaluate_grid(self, resolution=None, extent=None):
        """Dense posterior grid in the normalized frame, as numpy:
        (mean (R,R,R), var (R,R,R), axis (R,))."""
        self._require_model()
        t0 = time.perf_counter()
        mean, var, axis = grid_mod.evaluate_grid(
            self.model, resolution or self.config.grid_resolution,
            extent or self.config.grid_extent)
        with profiling.wait("session.copy", 3):
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

    @profiling.spanned("session.update")
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
        slots (`ShardedGPModel.update`); a committee routes each point to
        its nearest expert and borders it there (`gp.experts.update`)."""
        self._require_model()
        kind = model_kind(self.model)
        cfg = self.config
        with profiling.wait("session.upload"):
            pts = torch.as_tensor(np.asarray(touch_points_world, cfg.dtype), device=self.device)
        pts = self.frame.to_normalized(pts)
        y = (torch.zeros(pts.shape[0], dtype=pts.dtype, device=self.device) if targets is None
             else torch.as_tensor(targets, dtype=pts.dtype, device=self.device))
        if kind == "experts":
            self.model = gpe.update(self.model, pts, y, cfg.noise_touch)
        elif kind in ("ooc", "ooc_joint"):
            self.model = self.model.update(pts, y, cfg.noise_touch,
                                           tail_capacity=max(int(cfg.touch_capacity), 64))
        elif kind in ("sharded", "sharded_joint"):
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
        if ts is None:
            raise ValueError(
                "joint touch slots overflowed in a restored session: the "
                "original training set is not part of the checkpoint, so "
                "accumulated touches cannot be folded into the core. "
                "Restart from the original cloud (start()) or refit with "
                "a larger touch_capacity; bordering updates within "
                "capacity work fine after restore()."
            )
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

    @profiling.spanned("session.next_best_path")
    def next_best_path(self, *, seed_world=None):
        """The next best tactile path (`explore.planner.next_best_path`) from
        `seed_world` (default: the surface point of highest variance), as an
        ExplorationResult whose path is in the world frame.  On a mesh every
        rank calls it and gets the same path."""
        self._require_model()
        seed = None
        if seed_world is not None:
            seed = self.frame.to_normalized(torch.as_tensor(
                np.asarray(seed_world, self.config.dtype), device=self.device))
        res = planner.next_best_path(self.model, self.explore_config, seed_point=seed)
        with profiling.wait("session.upload"):
            path = torch.as_tensor(res.path, device=self.device)
        path = self.frame.to_world(path)
        with profiling.wait("session.copy"):
            res.path = path.cpu().numpy()
        return res

    def is_done(self, n_probe: int = 256) -> bool:
        """True when the posterior variance at `n_probe` points of the
        estimated surface (the unit sphere's Fibonacci points, projected) is
        below the ExploreConfig's threshold everywhere."""
        self._require_model()
        probes, _ = projection.project_points(self.model, torch.as_tensor(
            gpis.fibonacci_sphere(n_probe, 1.0).astype(self.config.dtype), device=self.device))
        return planner.is_done(self.model, self.explore_config, probes)

    def export_exploration(self, html_path: str, resolution: int = 32):
        """One-stop visual: the isosurface mesh, the atlas charts and the
        next-best path in one self-contained HTML viewer
        (`viz.export.export_html`), in the world frame.  Returns the
        ExplorationResult."""
        res = self.next_best_path()
        verts, faces, var = self.extract_surface(resolution=resolution)
        scale = float(self.frame.scale)
        charts = [
            {"center": self.frame.to_world(torch.as_tensor(
                c.center, dtype=self.dtype, device=self.device)).cpu().numpy().tolist(),
             "normal": c.normal.tolist(), "u": c.u.tolist(), "v": c.v.tolist(),
             "radius": float(c.radius * scale)}
            for c in res.charts
        ]
        export.export_html(html_path, verts, faces, variance=var, charts=charts,
                           best_path=res.path)
        return res

    @profiling.spanned("session.optimize_hyperparameters")
    def optimize_hyperparameters(self, **kw):
        """MLL optimization (config 3) in place, then a refit with the
        optimum; keywords go to the optimizer (`steps`, `learning_rate`,
        `learn_noise`, ...).  `method` picks the objective by model kind:

        * in core (value or joint): "subsample", the whole padded model
          (`gp.hyperopt.optimize` / `optimize_joint`); the value refit keeps
          the touch slots' points, the joint one folds the occupied slots
          into its core as value-only observations;
        * out of core: "subsample" (default; `subsample=` points, 4,096
          value / 1,024 joint) or "stream" (the full-data objective of
          `gp.ooc_hyperopt`, one out-of-core factor a step); the refit
          folds the touch tail in;
        * sharded: "subsample" (a single-device fit of `subsample=` 2,048
          points) or "distributed" (`gp.sharded_hyperopt`, one sharded fit
          a step); every rank calls it alike;
        * committee: "subsample" (default; the exact MLL of `subsample=`
          4,096 training points) or "poe" (`gp.experts.optimize_experts`,
          every expert's rows); the refit replays the routed touches."""
        self._require_model()
        m = self.model
        kind = model_kind(m)
        if kind == "experts":
            del m  # the refit releases the old committee first
            return self._optimize_experts(kw)
        if kind in ("ooc", "ooc_joint"):
            return self._optimize_ooc(m, kind, kw)
        if kind == "sharded":
            return self._optimize_sharded(m, kw)
        if kind == "sharded_joint":
            return self._optimize_sharded_joint(m, kw)
        bad = kw.pop("method", "subsample")
        if bad != "subsample":
            raise ValueError(
                f"unknown hyperopt method {bad!r} for an in-core model "
                "('distributed' needs a sharded fit, 'stream' an "
                "out-of-core fit)"
            )
        cfg = self.config
        if kind == "joint":
            res = ho.optimize_joint(m.kernel, m.x, m.y, m.normals, m.noise_f, m.noise_g, m.params,
                                    n_real=m.n0, **kw)
            # Refit with the optimum, the OCCUPIED touch slots folded into the
            # core as value-only observations (the slots re-arm empty).
            x, yv, nrm, nf, ng = m.x, m.y, m.normals, res.noise, res.noise_g
            occ = int(m.n_touch or 0)
            if occ:
                dt, dev = x.dtype, x.device
                x = torch.cat([x, m.touch_x[:occ]])
                yv = torch.cat([yv, m.touch_y[:occ]])
                nrm = torch.cat([nrm, torch.zeros((occ, 3), dtype=dt, device=dev)])
                nf = torch.cat([nf, m.touch_noise[:occ]])
                ng = torch.cat([ng, torch.full((occ,), cfg.pad_noise, dtype=dt, device=dev)])
            self.model = gpd.fit_with_normals(m.kernel, x, yv, nrm, nf, ng, res.params,
                                              block=cfg.block, pad_noise=cfg.pad_noise,
                                              touch_capacity=cfg.touch_capacity)
            if 4 * self.model.capacity >= 1024:
                self.model = gpd.with_linv_joint(self.model)
        else:
            res = ho.optimize(m.kernel, m.x, m.y, m.noise, m.params, n_real=m.n0, **kw)
            # As in the JAX package the refit keeps the padded arrays, touch
            # slots included (its n_touch starts at 0 again); W is attached,
            # as `start` attaches it.
            self.model = gpr.with_linv(gpr.fit_padded(m.kernel, m.x, m.y, res.noise, res.params,
                                                      n0=m.n0, pad_noise=m.pad_noise))
        self._sync()
        return res

    def _optimize_experts(self, kw: dict):
        """The committee branches of optimize_hyperparameters: the shared
        hyperparameters, then a refit of the committee from the training
        set and a replay of the old slots' touches (re-routed to the new
        centroids; the bordering is exact either way)."""
        m = self.model
        method = kw.pop("method", "subsample")
        joint_obs = getattr(self, "_joint_expert_obs", None)
        ts = self.training
        if method == "poe":
            kw.pop("subsample", None)
            res = gpe.optimize_experts(m, **kw)
        elif method == "subsample":
            if ts is None:
                raise ValueError(
                    "subsample hyperopt on a restored experts session "
                    "needs the original training set (not part of the "
                    "checkpoint); re-start() from the cloud, or use "
                    "method='poe' (optimizes on the committee's own "
                    "stored rows)"
                )
            step = max(1, ts.x.shape[0] // int(kw.pop("subsample", 4096)))
            xs = ts.x[::step]
            if m.joint:
                nrm_full, noise_g = joint_obs
                res = ho.optimize_joint(m.kernel, xs, ts.y[::step], nrm_full[::step],
                                        ts.noise[::step], noise_g[::step], m.params,
                                        n_real=xs.shape[0], **kw)
            else:
                res = ho.optimize(m.kernel, xs, ts.y[::step], ts.noise[::step], m.params,
                                  n_real=xs.shape[0], **kw)
        else:
            raise ValueError(
                f"unknown hyperopt method {method!r} for an expert "
                "committee (use 'subsample' or 'poe')"
            )
        if ts is None or (m.joint and joint_obs is None):
            raise ValueError(
                "refitting a restored experts session needs the "
                "original training set; re-start() from the cloud, or "
                "optimize before saving"
            )
        cfg, scale = self.config, float(res.noise_scale)
        ekw = dict(n_experts=m.n_experts, n_shared_tail=ts.n_internal + ts.n_external,
                   block=cfg.block, touch_capacity=cfg.touch_capacity, pad_noise=cfg.pad_noise,
                   beta=m.beta, gate=m.gate)
        # The old stacks go before the refit builds new ones; the touches
        # to replay are copied out of them first.
        slots = []
        for e, k in enumerate(m.n_touch):
            if k and m.joint:
                slots.append((m.touch_x[e, :k], m.touch_y[e, :k], m.touch_noise[e, :k]))
            elif k:
                n0 = m.n0
                slots.append((m.x[e, n0:n0 + k], m.y[e, n0:n0 + k], m.noise[e, n0:n0 + k]))
        replay = [torch.cat(parts) for parts in zip(*slots)] if slots else None
        kernel, joint = m.kernel, m.joint
        del m, slots
        self.model = None
        if joint:
            nrm_full, noise_g = joint_obs
            self.model = gpe.fit_experts_joint(
                kernel, ts.x, ts.y, nrm_full, ts.noise * scale,
                noise_g * float(res.get("noise_scale_g", 1.0) or 1.0), res.params, **ekw)
        else:
            self.model = gpe.fit_experts(kernel, ts.x, ts.y, ts.noise * scale, res.params, **ekw)
        if replay is not None:
            self.model = gpe.update(self.model, *replay)
        self._sync()
        return res

    def _optimize_ooc(self, m, kind: str, kw: dict):
        """The out-of-core branches of optimize_hyperparameters."""
        method = kw.pop("method", "subsample")
        cfg = self.config
        if kind == "ooc_joint":
            n = m.n_real
            if method == "stream":
                kw.pop("subsample", None)
                res_d = oho.optimize_ooc_joint(m.kernel, m.x[:n], m.y[:n], m.normals[:n],
                                               m.noise[:n], m.noise_g[:n], m.params,
                                               panel=m.panel, pad_noise=cfg.pad_noise, **kw)
                # The stream objective scales the value noise only.
                res = ho.HyperoptResult(params=res_d["params"],
                                        noise=m.noise[:n] * res_d["noise_scale"],
                                        noise_scale=res_d["noise_scale"], noise_scale_g=1.0,
                                        history=res_d["history"], mll=res_d["mll"])
            elif method == "subsample":
                step = max(1, n // int(kw.pop("subsample", 1024)))
                res = ho.optimize_joint(m.kernel, m.x[:n:step], m.y[:n:step],
                                        m.normals[:n:step], m.noise[:n:step],
                                        m.noise_g[:n:step], m.params,
                                        n_real=m.x[:n:step].shape[0], **kw)
            else:
                raise ValueError(
                    f"unknown hyperopt method {method!r} for a joint "
                    "out-of-core model (use 'subsample' or 'stream')"
                )
            fx, fy, fnrm = m.x[:n], m.y[:n], m.normals[:n]
            fnf = m.noise[:n] * float(res.noise_scale)
            fng = m.noise_g[:n] * float(res.noise_scale_g)
            if m.n_tail:
                # Touches fold in as value-only observations.
                occ, dt, dev = m.n_tail, m.dtype, m.device
                fx = torch.cat([fx, m.tail_x[:occ]])
                fy = torch.cat([fy, m.tail_y[:occ]])
                fnrm = torch.cat([fnrm, torch.zeros((occ, 3), dtype=dt, device=dev)])
                fnf = torch.cat([fnf, m.tail_noise[:occ]])
                fng = torch.cat([fng, torch.full((occ,), cfg.pad_noise, dtype=dt, device=dev)])
            self.model = ooc.ooc_fit_joint(m.kernel, fx, fy, fnrm, fnf, fng, res.params,
                                           panel=m.panel, pad_noise=cfg.pad_noise)
        else:
            ts = self.training
            if ts is None:
                raise ValueError(
                    "hyperopt on a restored out-of-core session needs the "
                    "original training set (not part of the checkpoint); "
                    "re-start() from the cloud, or optimize before saving"
                )
            if method == "stream":
                kw.pop("subsample", None)
                res_d = oho.optimize_ooc(m.kernel, ts.x, ts.y, ts.noise, m.params,
                                         panel=m.panel, pad_noise=cfg.pad_noise, **kw)
                res = ho.HyperoptResult(params=res_d["params"],
                                        noise=ts.noise * res_d["noise_scale"],
                                        noise_scale=res_d["noise_scale"],
                                        history=res_d["history"], mll=res_d["mll"])
            elif method == "subsample":
                step = max(1, ts.x.shape[0] // int(kw.pop("subsample", 4096)))
                xs = ts.x[::step]
                res = ho.optimize(m.kernel, xs, ts.y[::step], ts.noise[::step], m.params,
                                  n_real=xs.shape[0], **kw)
            else:
                raise ValueError(
                    f"unknown hyperopt method {method!r} for an out-of-core "
                    "model (use 'subsample', or 'stream' for full-data "
                    "exact gradients at one factorization per step)"
                )
            # The touch tail folds into the refit at its own noise: the scale
            # applies to the training set the objective saw.
            fx, fy = ts.x, ts.y
            fnoise = ts.noise * float(res.noise_scale)
            if m.n_tail:
                occ = m.n_tail
                fx = torch.cat([fx, m.tail_x[:occ]])
                fy = torch.cat([fy, m.tail_y[:occ]])
                fnoise = torch.cat([fnoise, m.tail_noise[:occ]])
            self.model = ooc.ooc_fit(m.kernel, fx, fy, fnoise, res.params, panel=m.panel,
                                     pad_noise=cfg.pad_noise)
        self.model.promote_for_serving()
        self._sync()
        return res

    def _optimize_sharded(self, m, kw: dict):
        """The sharded branches of optimize_hyperparameters (every rank)."""
        method = kw.pop("method", "subsample")
        if method not in ("subsample", "distributed"):
            raise ValueError(
                f"unknown hyperopt method {method!r} for a sharded "
                "model (use 'subsample' or 'distributed')"
            )
        cfg, n = self.config, m.n_real
        if method == "distributed":
            res_d = sho.optimize_sharded(m.kernel, m.x, m.y, m.noise, m.params, m.mesh,
                                         block=m.block, n_real=n, **kw)
            res = ho.HyperoptResult(params=res_d["params"],
                                    noise=m.noise[:n] * res_d["noise_scale"],
                                    noise_scale=res_d["noise_scale"],
                                    history=res_d["history"], mll=res_d["mll"])
        else:
            step = max(1, n // int(kw.pop("subsample", 2048)))
            sub = gpr.fit(m.kernel, m.x[:n:step], m.y[:n:step], m.noise[:n:step], m.params,
                          block=cfg.block, touch_capacity=0, pad_noise=cfg.pad_noise)
            res = ho.optimize(m.kernel, sub.x, sub.y, sub.noise, m.params,
                              n_real=m.x[:n:step].shape[0], **kw)
            del sub
        # One multiplicative scale on every real row's noise.
        self.model = gsm.fit_sharded(m.kernel, m.x[:n], m.y[:n],
                                     m.noise[:n] * float(res.noise_scale), res.params,
                                     mesh=m.mesh, block=m.block,
                                     touch_capacity=cfg.touch_capacity, pad_noise=cfg.pad_noise)
        self._sync()
        return res

    def _optimize_sharded_joint(self, m, kw: dict):
        """The sharded joint branches of optimize_hyperparameters (every
        rank): "subsample" optimizes the joint MLL of a core-point
        subsample (`subsample=` 1,024) on one device, "distributed" the
        whole system over the mesh (`optimize_sharded_joint`); either way
        the refit replays the touches the old model held."""
        method = kw.pop("method", "subsample")
        cfg, n = self.config, m.n_real
        if method == "distributed":
            res_d = sho.optimize_sharded_joint(m.kernel, m.x, m.y, m.noise_f, m.noise_g,
                                               m.params, m.mesh, c=m.n0, block=m.block,
                                               n_real=n, n_touch=m.n_touch, **kw)
            scale = float(res_d["noise_scale"])
            res = ho.HyperoptResult(params=res_d["params"], noise=m.noise_f[:n] * scale,
                                    noise_scale=res_d["noise_scale"],
                                    history=res_d["history"], mll=res_d["mll"])
            scale_g = 1.0
        elif method == "subsample":
            step = max(1, n // int(kw.pop("subsample", 1024)))
            res = ho.optimize_joint(m.kernel, m.x[:n:step], m.y[:n:step], m.normals[:n:step],
                                    m.noise_f[:n:step], m.noise_g[:n:step], m.params,
                                    n_real=m.x[:n:step].shape[0], **kw)
            scale, scale_g = float(res.noise_scale), float(res.noise_scale_g)
        else:
            raise ValueError(
                f"unknown hyperopt method {method!r} for a sharded joint "
                "model (use 'subsample' or 'distributed')"
            )
        c, occ = m.n0, m.n_touch
        touches = (m.x[c:c + occ], m.y[4 * c:4 * c + occ], m.noise_f[c:c + occ])
        x, yv, nrm = m.x[:n], m.y[:n], m.normals[:n]
        nf, ng = m.noise_f[:n] * scale, m.noise_g[:n] * scale_g
        kernel, mesh, block, pad_noise = m.kernel, m.mesh, m.block, m.pad_noise
        # The old bands go before the refit builds new ones.
        del m
        self.model = None
        self.model = gsj.fit_sharded_joint(kernel, x, yv, nrm, nf, ng, res.params, mesh,
                                           block=block, touch_capacity=cfg.touch_capacity,
                                           pad_noise=pad_noise)
        if occ:
            self.model = self.model.update(*touches)
        self._sync()
        return res

    def save(self, path: str):
        """Checkpoint the model (`utils.checkpoint.save_model`) and the frame
        (`path + ".frame.npz"`).  On a mesh every rank calls it; rank 0
        writes, and every rank returns once the files are written."""
        self._require_model()
        if self.mesh is None or self.mesh.rank == 0:
            np.savez(path + ".frame.npz", centroid=self.frame.centroid.cpu().numpy(),
                     scale=self.frame.scale.cpu().numpy())
        ckpt.save_model(path, self.model)
        return path

    @classmethod
    def load(cls, path: str, config: ModelConfig | None = None, **kw):
        """A new session (`config` and the constructor's keywords) restored
        from the checkpoint at `path`."""
        return cls(config, **kw).restore(path)

    def restore(self, path: str):
        """Load a checkpoint into this session: the crash-recovery drill is
        fit, touch, save, crash, load, then replay the pending touches
        through `update`, which continues from the checkpointed factor and
        W.  As in the JAX package the training set and the list of joint
        touches are not part of the checkpoint: a restored joint session
        borders touches while its slots last and raises past them."""
        self.model = ckpt.load_model(path, device=self.device, mesh=self.mesh)
        # A restored out-of-core model's W panels are all on disk: pin them
        # on the card as start() does (the checkpoint's files stay).
        if model_kind(self.model) in ("ooc", "ooc_joint"):
            self.model.promote_for_serving()
        with np.load(path + ".frame.npz") as d:
            self.frame = gpis.Frame(centroid=torch.as_tensor(d["centroid"], device=self.device),
                                    scale=torch.as_tensor(d["scale"], device=self.device))
        self.training = None
        self._touches = []
        return self
