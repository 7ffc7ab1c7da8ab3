"""The port's exploration loop (`explore.atlas`, `explore.planner` and the
session's `next_best_path` / `is_done`) against the JAX package, on the CPU
in float64 (the port's wrappers take their plain twins for CPU tensors).
The models are the JAX tests' partial-sphere scans (tests/test_explore.py),
whose variances differ enough that no argmax ties across packages; the
atlas is held chart for chart (ids, parents, centres, normals, radii and
variances) at BASELINE.md row 2's 1e-6.  Two gloo ranks run the planner on
a sharded model (`tests/torch_session_rank.py`, no jax) and each returns
the single-process path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

from gpis_tpu.api.session import ObjectModelSession as JaxSession
from gpis_tpu.config import ExploreConfig as JaxExploreConfig
from gpis_tpu.config import ModelConfig as JaxModelConfig
from gpis_tpu.data import gpis as jgpis
from gpis_tpu.data import synthetic
from gpis_tpu.explore import atlas as jatlas
from gpis_tpu.explore import planner as jplanner
from gpis_tpu.gp import regression as jgpr
from gpis_tpu.kernels import functions as jkf
from gpis_tpu_torch.api.session import ObjectModelSession
from gpis_tpu_torch.config import ExploreConfig, ModelConfig
from gpis_tpu_torch.data import gpis
from gpis_tpu_torch.explore import atlas, planner
from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.kernels import functions as kf
from torch_ranks import spawn_ranks

TOL = 1e-6
LS = 0.7
NORTH = np.array([0.0, 0.0, 1.0])


def _fit_both(pts, block=128, touch_capacity=128):
    """The JAX test's model (rbf, lengthscale 0.7, surface noise 1e-5) fitted
    by both packages on the same cloud."""
    kw = dict(kernel="rbf", lengthscale=LS, noise_surface=1e-5)
    jts = jgpis.build_training_set(pts, JaxModelConfig(**kw))
    ts = gpis.build_training_set(pts, ModelConfig(**kw, dtype="float64"), device="cpu")
    jm = jgpr.fit("rbf", jts.x, jts.y, jts.noise, jkf.kernel_params(LS, 1.0), block=block,
                  touch_capacity=touch_capacity)
    m = gpr.fit("rbf", ts.x, ts.y, ts.noise, kf.kernel_params(LS, 1.0), block=block,
                touch_capacity=touch_capacity)
    return m, jm


@pytest.fixture(scope="module")
def partial_models():
    """Upper-hemisphere scan: the south pole is unseen."""
    pts, _ = synthetic.partial_sphere_cloud(250, radius=1.0, cap_cos=-0.2, seed=2)
    return _fit_both(pts)


def _same_chart(c, jc):
    assert (c.id, c.parent) == (jc.id, jc.parent)
    for key in ("center", "normal", "u", "v"):
        np.testing.assert_allclose(getattr(c, key), np.asarray(getattr(jc, key)), atol=TOL)
    np.testing.assert_allclose((c.radius, c.variance), (jc.radius, jc.variance), atol=TOL)


def _same_result(res, jres):
    assert len(res.charts) == len(jres.charts)
    for c, jc in zip(res.charts, jres.charts):
        _same_chart(c, jc)
    np.testing.assert_allclose(res.path, np.asarray(jres.path), atol=TOL)
    np.testing.assert_allclose(res.normals, np.asarray(jres.normals), atol=TOL)
    np.testing.assert_allclose(res.target_variance, jres.target_variance, atol=TOL)
    assert res.reached_threshold == jres.reached_threshold


def test_make_charts_matches_jax(partial_models):
    m, jm = partial_models
    centers = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
    charts = atlas.make_charts(m, centers, ExploreConfig(), ids=[0, 1], parents=[-1, 0])
    jcharts = jatlas.make_charts(jm, centers, JaxExploreConfig(), ids=[0, 1], parents=[-1, 0])
    for c, jc in zip(charts, jcharts):
        _same_chart(c, jc)
        np.testing.assert_allclose(np.linalg.norm(c.normal), 1.0, atol=1e-9)
        np.testing.assert_allclose((np.dot(c.u, c.v), np.dot(c.u, c.normal)), 0.0, atol=1e-9)


def test_disc_samples_match_jax(partial_models):
    m, jm = partial_models
    (chart,) = atlas.make_charts(m, NORTH[None], ExploreConfig(), ids=[0], parents=[-1])
    (jchart,) = jatlas.make_charts(jm, NORTH[None], JaxExploreConfig(), ids=[0], parents=[-1])
    s = atlas.disc_samples(chart, 16)
    np.testing.assert_allclose(s, jatlas.disc_samples(jchart, 16), atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(s - chart.center, axis=1), chart.radius, atol=1e-9)
    np.testing.assert_allclose((s - chart.center) @ chart.normal, 0.0, atol=1e-9)


@pytest.mark.parametrize("k", [0, 5, 11])
def test_project_and_chart_matches_jax(partial_models, k):
    m, jm = partial_models
    (chart,) = atlas.make_charts(m, NORTH[None], ExploreConfig(), ids=[0], parents=[-1])
    x0 = atlas.disc_samples(chart, 12)[k]
    got = atlas.project_and_chart(m, x0, ExploreConfig(), cid=3, parent=0)
    want = jatlas.project_and_chart(jm, x0, JaxExploreConfig(), cid=3, parent=0)
    _same_chart(got, want)
    assert abs(float(gpr.predict_mean(m, torch.as_tensor(got.center)[None])[0])) <= 1e-6


@pytest.mark.parametrize("strategy", ["single_path", "multi_branch"])
@pytest.mark.parametrize("seed", ["north", "default"])
def test_next_best_path_matches_jax_chart_for_chart(partial_models, strategy, seed):
    m, jm = partial_models
    kw = dict(variance_threshold=0.3, max_charts=16, n_disc_samples=16, strategy=strategy)
    seed_point = NORTH if seed == "north" else None
    res = planner.next_best_path(m, ExploreConfig(**kw), seed_point=seed_point)
    jres = jplanner.next_best_path(jm, JaxExploreConfig(**kw), seed_point=seed_point)
    _same_result(res, jres)
    assert len(res.charts) == 16 and len(res.path) >= 2


def test_next_best_path_seeks_the_unseen_region(partial_models):
    m, _ = partial_models
    cfg = ExploreConfig(variance_threshold=0.3, max_charts=16, n_disc_samples=16)
    res = planner.next_best_path(m, cfg, seed_point=NORTH)
    assert res.path[-1][2] < res.path[0][2]
    assert res.target_variance > res.charts[0].variance
    np.testing.assert_allclose(np.linalg.norm(res.normals, axis=1), 1.0, atol=1e-9)


def test_single_path_reseeds_on_pathological_disc_as_jax(partial_models, monkeypatch):
    """Every projection from chart 1's disc fails: both packages re-seed from
    the best chart not exhausted and grow the same tree past it."""
    m, jm = partial_models

    def flaky(real):
        def pac(model, x0, cfg, *, cid, parent):
            return None if parent == 1 else real(model, x0, cfg, cid=cid, parent=parent)
        return pac

    monkeypatch.setattr(planner.atlas_mod, "project_and_chart", flaky(atlas.project_and_chart))
    monkeypatch.setattr(jplanner.atlas_mod, "project_and_chart",
                        flaky(jatlas.project_and_chart))
    kw = dict(variance_threshold=10.0, max_charts=5, n_disc_samples=16, strategy="single_path")
    res = planner.next_best_path(m, ExploreConfig(**kw), seed_point=NORTH)
    jres = jplanner.next_best_path(jm, JaxExploreConfig(**kw), seed_point=NORTH)
    _same_result(res, jres)
    assert len(res.charts) >= 3 and all(c.parent != 1 for c in res.charts)


def test_failed_projections_fall_through_to_the_next_candidate_as_jax(partial_models,
                                                                     monkeypatch):
    """The first projection tried for each new chart fails: both packages
    try the next-best candidates of the same disc (up to 8) and grow the
    same tree, without a reseed."""
    m, jm = partial_models

    def first_fails(real):
        seen = set()

        def pac(model, x0, cfg, *, cid, parent):
            if cid not in seen:
                seen.add(cid)
                return None
            return real(model, x0, cfg, cid=cid, parent=parent)
        return pac

    monkeypatch.setattr(planner.atlas_mod, "project_and_chart",
                        first_fails(atlas.project_and_chart))
    monkeypatch.setattr(jplanner.atlas_mod, "project_and_chart",
                        first_fails(jatlas.project_and_chart))
    kw = dict(variance_threshold=10.0, max_charts=6, n_disc_samples=16, strategy="single_path")
    res = planner.next_best_path(m, ExploreConfig(**kw), seed_point=NORTH)
    jres = jplanner.next_best_path(jm, JaxExploreConfig(**kw), seed_point=NORTH)
    _same_result(res, jres)
    assert [c.parent for c in res.charts] == [-1, 0, 1, 2, 3, 4]


@pytest.mark.parametrize("model", ["complete", "partial"])
def test_is_done_matches_jax(model):
    """A fully scanned sphere is done; an under-scanned one is not."""
    if model == "complete":
        m, jm = _fit_both(gpis.fibonacci_sphere(400, radius=1.0))
    else:
        pts, _ = synthetic.partial_sphere_cloud(100, radius=1.0, cap_cos=0.3, seed=1)
        m, jm = _fit_both(pts, block=64, touch_capacity=64)
    probes = gpis.fibonacci_sphere(128, radius=1.0)
    cfg, jcfg = ExploreConfig(variance_threshold=0.05), JaxExploreConfig(variance_threshold=0.05)
    done = planner.is_done(m, cfg, probes)
    assert done == jplanner.is_done(jm, jcfg, jnp.asarray(probes)) == (model == "complete")


# ------------------------------------------------------------ the session

SESSION_KW = dict(kernel="rbf", lengthscale=LS, noise_surface=1e-5, n_external=32,
                  touch_capacity=64, block=64)
EXPLORE_KW = dict(max_charts=8, n_disc_samples=12, variance_threshold=0.3)


def _session_cloud(center=np.array([2.0, -1.0, 0.5]), scale=0.3):
    """A scaled, off-centre partial scan: the session converts frames."""
    pts, nrm = synthetic.partial_sphere_cloud(200, radius=1.0, cap_cos=-0.2, seed=11)
    return pts * scale + center, nrm


@pytest.mark.parametrize("kind", ["value", "joint", "ooc", "ooc_joint"])
def test_session_explore_verbs_match_jax(kind):
    pts, nrm = _session_cloud()
    kw = {}
    if kind in ("joint", "ooc_joint"):
        kw["normals"] = nrm
    if kind.startswith("ooc"):
        kw["out_of_core"] = True
    sess = ObjectModelSession(ModelConfig(**SESSION_KW, dtype="float64"),
                              ExploreConfig(**EXPLORE_KW), device="cpu").start(pts, **kw)
    jsess = JaxSession(JaxModelConfig(**SESSION_KW, dtype="float64"),
                       JaxExploreConfig(**EXPLORE_KW)).start(pts, **kw)
    assert sess.explore_config == ExploreConfig(**EXPLORE_KW)
    seed_world = np.array([2.0, -1.0, 0.5 + 0.3])
    for seed in (seed_world, None):
        _same_result(sess.next_best_path(seed_world=seed), jsess.next_best_path(seed_world=seed))
    assert sess.is_done(64) == jsess.is_done(64)


def test_session_explores_after_touches_as_jax():
    """The loop the service drives: path, touch its target, path again."""
    pts, _ = _session_cloud()
    sess = ObjectModelSession(ModelConfig(**SESSION_KW, dtype="float64"),
                              ExploreConfig(**EXPLORE_KW), device="cpu").start(pts)
    jsess = JaxSession(JaxModelConfig(**SESSION_KW, dtype="float64"),
                       JaxExploreConfig(**EXPLORE_KW)).start(pts)
    for _ in range(2):
        res, jres = sess.next_best_path(), jsess.next_best_path()
        _same_result(res, jres)
        sess.update(res.path[-1:])
        jsess.update(np.asarray(jres.path)[-1:])
    _same_result(sess.next_best_path(), jsess.next_best_path())


# --------------------------------------------------------- two gloo ranks


@pytest.fixture(scope="module")
def rank_outputs(tmp_path_factory):
    pts, _ = _session_cloud()
    inputs = dict(pts=pts, seed_world=np.array([2.0, -1.0, 0.8]), ls=LS,
                  explore=np.array([EXPLORE_KW["max_charts"], EXPLORE_KW["n_disc_samples"],
                                    EXPLORE_KW["variance_threshold"]]))
    return spawn_ranks("torch_session_rank.py", ["explore"], 2, inputs,
                       tmp_path_factory.mktemp("explore_ranks"))


def test_sharded_ranks_return_the_single_process_path(rank_outputs):
    pts, _ = _session_cloud()
    cfg = JaxModelConfig(**{**SESSION_KW, "touch_capacity": 0}, dtype="float64")
    jsess = JaxSession(cfg, JaxExploreConfig(**EXPLORE_KW)).start(pts)
    for which, seed in (("seed", np.array([2.0, -1.0, 0.8])), ("default", None)):
        jres = jsess.next_best_path(seed_world=seed)
        for out in rank_outputs:
            assert out["imported"] == ""
            assert int(out[f"{which}_n_charts"]) == len(jres.charts)
            np.testing.assert_array_equal(out[f"{which}_ids"],
                                          [[c.id, c.parent] for c in jres.charts])
            np.testing.assert_allclose(out[f"{which}_charts"],
                                       [[*c.center, c.radius, c.variance] for c in jres.charts],
                                       atol=TOL)
            np.testing.assert_allclose(out[f"{which}_path"], np.asarray(jres.path), atol=TOL)
    for out in rank_outputs:
        assert bool(out["done"]) == jsess.is_done(64)
