"""GPAtlasRRT explorer (port of gpis_tpu/explore/planner.py).

An RRT-style tree of charts grown over the estimated surface toward high
posterior variance; it emits the "next best path" a finger should trace to
reduce the model's uncertainty.  Strategies:

* ``single_path``  -- a greedy chain: the newest chart always expands;
* ``multi_branch`` -- the frontier chart whose candidate scores best
  expands.

Host tree logic around batched device queries: each round predicts at all
of the frontier's disc candidates in one call.  The JAX package pads that
call with origin rows to a multiple of 256 so that XLA does not compile a
new shape each round; the port pads it the same way.  The padding rows are
sliced away after the predict, but a committee's gating reads every row of
a chunk, so they choose which experts answer as they do in JAX.  On a
sharded model every rank runs this loop and takes the same branches (see
`explore.atlas`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpis_tpu_torch.config import ExploreConfig
from gpis_tpu_torch.explore import atlas as atlas_mod
from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.surface import projection
from gpis_tpu_torch.utils import profiling

__all__ = ["ExplorationResult", "next_best_path", "is_done"]


@dataclasses.dataclass
class ExplorationResult:
    """Pose sequence root -> target plus the atlas that produced it."""

    path: np.ndarray  # (K, 3) positions along the surface
    normals: np.ndarray  # (K, 3) outward normals (pose orientation)
    charts: list  # list[Chart], the whole tree
    target_variance: float
    reached_threshold: bool  # True if a target of variance >= threshold was found


def _predict_var(model, points) -> np.ndarray:
    with profiling.wait("plan.upload"):
        q = torch.as_tensor(points).to(dtype=model.dtype, device=model.device)
    var = gpr.predict(model, q)[1]
    with profiling.wait("plan.var"):
        return var.cpu().numpy()


def is_done(model, cfg: ExploreConfig, probe_points) -> bool:
    """Global termination: exploration is complete when the posterior
    variance at every probe of the estimated surface is below the
    threshold."""
    return bool(np.max(_predict_var(model, probe_points)) < cfg.variance_threshold)


def _extract_path(charts, leaf_id):
    chain = []
    cid = leaf_id
    by_id = {c.id: c for c in charts}
    while cid != -1:
        chain.append(by_id[cid])
        cid = by_id[cid].parent
    chain.reverse()
    return np.stack([c.center for c in chain]), np.stack([c.normal for c in chain])


def _default_seed(model) -> np.ndarray:
    """The surface-labelled training point of highest variance.  `noise` is
    the value-observation noise of the C core points on every model kind,
    the first C entries of y are their value targets (a joint layout's
    gradients come after), and the first C rows of x their coordinates."""
    with profiling.wait("plan.seed", 3):
        noise_v = model.noise.cpu().numpy()
        c_v = noise_v.shape[0]
        y, x = model.y[:c_v].cpu().numpy(), model.x[:c_v].cpu().numpy()
    on_surface = (y == 0.0) & (noise_v < 1e6)
    cand = x[on_surface]
    if len(cand) == 0:
        raise ValueError("model has no surface-labeled training points to seed from")
    return cand[int(np.argmax(_predict_var(model, cand)))]


def next_best_path(model, cfg: ExploreConfig, *, seed_point=None) -> ExplorationResult:
    """Grow the atlas from a surface seed toward high variance and return
    the next best tactile path.  Deterministic: candidates are taken by
    argmax variance, so repeated calls on one model give the same path."""
    with profiling.span("plan.seed"):
        if seed_point is None:
            seed_point = _default_seed(model)
        seed, _ = projection.project_point(
            model, torch.as_tensor(seed_point).to(model.dtype))
        charts = atlas_mod.make_charts(model, seed[None, :], cfg, ids=[0], parents=[-1])

    frontier = [charts[0]]
    best_leaf, best_var = charts[0], charts[0].variance
    reached = charts[0].variance >= cfg.variance_threshold
    next_id = 1
    # Charts whose disc candidates all failed projection or are covered.
    # disc_samples is deterministic, so retrying such a chart without new
    # neighbours would loop forever: the single-path strategy re-seeds from
    # the best chart not exhausted instead.
    exhausted: set[int] = set()

    def _reseed():
        remaining = [c for c in charts if c.id not in exhausted]
        if not remaining:
            return False
        frontier[:] = [max(remaining, key=lambda c: c.variance)]
        return True

    while not reached and next_id < cfg.max_charts and frontier:
        with profiling.span("plan.candidates"):
            # Every frontier chart's disc candidates in one predict.
            cand_blocks = [atlas_mod.disc_samples(c, cfg.n_disc_samples) for c in frontier]
            cands = np.concatenate(cand_blocks, axis=0)
            qpad = np.zeros((-(-len(cands) // 256) * 256, 3), dtype=cands.dtype)
            qpad[:len(cands)] = cands
            var = _predict_var(model, qpad)[:len(cands)]

        with profiling.span("plan.score"):
            # Candidates that fall back inside existing charts score -inf
            # (the tree explores instead of oscillating).
            centers = np.stack([c.center for c in charts])
            radii = np.array([c.radius for c in charts])
            d = np.linalg.norm(cands[:, None, :] - centers[None, :, :], axis=-1)
            covered = (d < 0.8 * radii[None, :]).any(axis=1)
            score = np.where(covered, -np.inf, var)
            if cfg.strategy == "single_path":
                # Only the newest chart expands; its block is the last one.
                lo = len(cands) - cfg.n_disc_samples
                score = np.where(np.arange(len(score)) >= lo, score, -np.inf)
            # Candidates best first: a failed projection must not orphan
            # good candidates on the same disc, so up to 8 are tried.
            order = np.argsort(-score)

        def owner(idx):
            # The frontier chart a flat candidate index belongs to.
            acc = 0
            for c, blk in zip(frontier, cand_blocks):
                if idx < acc + len(blk):
                    return c
                acc += len(blk)
            return frontier[-1]

        if not np.isfinite(score).any():
            if cfg.strategy == "single_path":
                # The active chart's disc is covered: re-seed from the next
                # best chart instead of ending the exploration.
                exhausted.add(frontier[0].id)
                if _reseed():
                    continue
            break

        new = None
        for cand_idx in order[:8]:
            if not np.isfinite(score[cand_idx]):
                break
            parent = owner(int(cand_idx))
            with profiling.span("plan.chart"):
                new = atlas_mod.project_and_chart(model, cands[int(cand_idx)], cfg,
                                                  cid=next_id, parent=parent.id)
            if new is not None:
                break
        if new is None:
            if cfg.strategy == "single_path":
                # Every candidate tried on this disc failed projection:
                # re-seed from the next best chart in the tree.
                exhausted.add(frontier[0].id)
                if _reseed():
                    continue
                break
            # Drop the chart owning the best-scoring candidate, so that the
            # round still makes progress.
            bad = owner(int(order[0]))
            exhausted.add(bad.id)
            frontier.remove(bad)
            continue

        charts.append(new)
        profiling.count("plan.charts")
        next_id += 1
        if cfg.strategy == "single_path":
            frontier = [new]
        else:
            frontier.append(new)
        if new.variance > best_var:
            best_leaf, best_var = new, new.variance
        # A touch target: a region whose uncertainty reaches the threshold.
        if new.variance >= cfg.variance_threshold:
            best_leaf, best_var = new, new.variance
            reached = True

    with profiling.span("plan.path"):
        path, normals = _extract_path(charts, best_leaf.id)
    return ExplorationResult(path=path, normals=normals, charts=charts,
                             target_variance=best_var, reached_threshold=reached)
