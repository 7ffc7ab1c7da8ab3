"""The port's local-expert committee (`gp.experts`) against the JAX package's,
on the CPU in float64, case for case after tests/test_experts.py: the
partition (same groups and centroids, bit for bit), the single expert
against the exact GP, E = 8 against JAX, the far field, gating, the
committee mean's gradient against `jax.grad`, touch routing and the
ladders, checkpoints both ways (with and without L, and without the
factors), the product-of-experts objective, the halo, the joint committee,
the sessions end to end (hyperopt refits replaying their touches), and
`predict_sharded` on two gloo ranks (`tests/torch_session_rank.py`, no jax).

Tolerances: the port against JAX 1e-6 (BASELINE.md row 2); the JAX tests'
own bars where they are the port's against itself (1e-12 gate-all against
ungated, 1e-10 the single expert against the exact GP, 5e-3 and 5e-2 the
committee against the exact GP and gated against ungated)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)
import torch_jax_native

from gpis_tpu.api.session import ObjectModelSession as JaxSession
from gpis_tpu.config import ExploreConfig as JaxExploreConfig
from gpis_tpu.config import ModelConfig as JaxModelConfig
from gpis_tpu.data import gpis as jgpis
from gpis_tpu.data import synthetic
from gpis_tpu.gp import experts as jex
from gpis_tpu.kernels import functions as jkf
from gpis_tpu.utils import checkpoint as jckpt
from gpis_tpu_torch import convert
from gpis_tpu_torch.api.session import ObjectModelSession
from gpis_tpu_torch.config import ExploreConfig, ModelConfig
from gpis_tpu_torch.gp import derivative as gpd
from gpis_tpu_torch.gp import experts as ex
from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.utils import checkpoint as ckpt
from torch_ranks import spawn_ranks

TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for the module: these sizes gain nothing from
    more, and the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol)


def _queries(n=200, seed=3):
    return np.random.default_rng(seed).normal(size=(n, 3))


@pytest.fixture(scope="module")
def fixture64():
    """tests/test_experts.py's fixture: a 400-point sphere's training set."""
    pts, _ = synthetic.sphere_cloud(400, seed=0)
    ts = jgpis.build_training_set(pts, JaxModelConfig(dtype="float64"))
    return ts, ts.n_internal + ts.n_external


def _fit(fixture, **kw):
    """One committee fitted by both packages on the fixture."""
    ts, shared = fixture
    kw.setdefault("n_shared_tail", shared)
    jm = jex.fit_experts("rbf", ts.x, ts.y, ts.noise, jkf.kernel_params(1.0, 1.0), **kw)
    m = ex.fit_experts("rbf", _t(ts.x), _t(ts.y), _t(ts.noise), kf.kernel_params(1.0, 1.0),
                       **kw)
    return m, jm


@pytest.fixture(scope="module")
def four(fixture64):
    return _fit(fixture64, n_experts=4)


@pytest.fixture(scope="module")
def one(fixture64):
    """A single-expert BCM committee: the exact GP with the shared rows."""
    return _fit(fixture64, n_experts=1, beta="bcm")


@pytest.fixture(scope="module")
def eight(fixture64):
    return _fit(fixture64, n_experts=8)


@pytest.fixture(scope="module")
def wide(fixture64):
    """B = 768 (448 touch slots): W formed, with and without the stacked L."""
    kw = dict(n_experts=4, gate=2, touch_capacity=448)
    return _fit(fixture64, retain_chol=True, **kw), _fit(fixture64, retain_chol=False, **kw)


def _same_posterior(m, jm, q, atol=TOL, **kw):
    mean, var = ex.predict(m, _t(q), **kw)
    jmean, jvar = jex.predict(jm, _j(q), **kw)
    _close(mean, jmean, atol)
    _close(var, jvar, atol)
    return mean, var


@pytest.mark.parametrize("n_experts, n_halo", [(7, 0), (4, 32)])
def test_partition_matches_jax_bit_for_bit(n_experts, n_halo):
    pts = np.random.default_rng(0).normal(size=(1000, 3))
    cent, groups = ex._partition_with_halo(pts, n_experts, n_halo=n_halo)
    jcent, jgroups = jex._partition_with_halo(pts, n_experts, n_halo=n_halo)
    np.testing.assert_array_equal(cent, jcent)
    assert len(groups) == len(jgroups) == n_experts
    for g, jg in zip(groups, jgroups):
        np.testing.assert_array_equal(g, jg)
    if not n_halo:
        counts = [len(g) for g in groups]
        assert sum(counts) == 1000 and max(counts) <= -(-1000 // n_experts)
        np.testing.assert_array_equal(np.sort(np.concatenate(groups)), np.arange(1000))


def test_single_expert_bcm_matches_exact_gp(fixture64, one):
    ts, shared = fixture64
    m1, jm1 = one
    exact = gpr.fit("rbf", _t(ts.x), _t(ts.y), _t(ts.noise), kf.kernel_params(1.0, 1.0),
                    touch_capacity=64)
    q = _queries()
    mc, vc = _same_posterior(m1, jm1, q)
    me, ve = gpr.predict(exact, _t(q))
    _close(mc, me, 1e-10)
    _close(vc, ve, 1e-10)


def test_committee_tracks_exact_and_jax(fixture64, eight):
    ts, _ = fixture64
    m8, jm8 = eight
    assert (m8.capacity, m8.n0) == (jm8.capacity, jm8.n0)
    _close(m8.centroids, jm8.centroids, 0.0)
    _close(m8.alpha, jm8.alpha)
    exact = gpr.fit("rbf", _t(ts.x), _t(ts.y), _t(ts.noise), kf.kernel_params(1.0, 1.0),
                    touch_capacity=0)
    dirs = np.random.default_rng(5).normal(size=(128, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    mc, _ = _same_posterior(m8, jm8, dirs)
    me, _ = gpr.predict(exact, _t(dirs))
    assert float(torch.max(torch.abs(me - mc))) < 5e-3


@pytest.mark.parametrize("beta", ["rbcm", "bcm"])
def test_far_field_and_combine_rules_match_jax(four, fixture64, beta):
    m, jm = four
    if beta == "bcm":
        m, jm = dataclasses.replace(m, beta="bcm"), dataclasses.replace(jm, beta="bcm")
    far = np.array([[25.0, 25.0, 25.0]])
    mean, var = _same_posterior(m, jm, far)
    if beta == "rbcm":
        k0 = kf.k_diag0("rbf", kf.kernel_params(1.0, 1.0))
        assert abs(float(var[0]) - k0) < 1e-6 and abs(float(mean[0])) < 1e-6
    _same_posterior(m, jm, _queries(64, seed=4))
    with pytest.raises(ValueError, match="unknown committee rule"):
        ex.predict(dataclasses.replace(m, beta="poe"), _t(far))


def test_gate_full_matches_ungated_exactly(four):
    m, jm = four
    q = _queries(1500, seed=7)
    ma, va = ex.predict(m, _t(q), gate=0)
    mg, vg = ex.predict(m, _t(q), gate=4, chunk=512)
    _close(mg, ma, 1e-12)
    _close(vg, va, 1e-12)
    _same_posterior(m, jm, q, gate=4, chunk=512)


def test_gated_surface_queries_match_ungated_and_jax(eight):
    m, jm = eight
    dirs = np.random.default_rng(11).normal(size=(600, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    ma, va = ex.predict(m, _t(dirs), gate=0)
    mg, vg = _same_posterior(m, jm, dirs, gate=4, chunk=256)
    assert float(torch.max(torch.abs(mg - ma))) < 5e-2
    assert float(torch.max(torch.abs(vg - va))) < 5e-2
    # The large-query rule: M B E >= 2^24 takes the gated chunks even with
    # every expert gated in (here 8,192 x 256 x 8), experts in order 0..E-1.
    q = _queries(8192, seed=12)
    _same_posterior(m, jm, q)


def test_predict_mean_and_gradient_match_jax_grad(four):
    m, jm = four
    q = np.array([[0.0, 0.0, 0.9], [0.3, -0.5, 0.7], [1.4, 0.2, -0.3], [25.0, 0.0, 0.0]])
    mean, g = ex.mean_and_gradient(m, _t(q))
    _close(mean, jex.predict_mean(jm, _j(q)))
    _close(ex.predict_mean(m, _t(q)), mean, 1e-12)
    jg = jax.vmap(jax.grad(lambda p: jex.predict_mean(jm, p[None, :])[0]))(_j(q))
    _close(g, jg)
    assert float(g[0, 2]) > 0  # outward near the upper surface


def test_touch_update_routes_and_matches_jax(four):
    m, jm = four
    tp = np.array([[0.9, 0.3, 0.2], [-0.2, 0.1, -0.95], [0.88, 0.32, 0.25]])
    tp /= np.linalg.norm(tp, axis=1, keepdims=True)
    mu = ex.update(m, _t(tp), torch.zeros(3, dtype=torch.float64), 1e-6)
    jmu = jex.update(jm, _j(tp), jnp.zeros(3), jnp.full(3, 1e-6))
    np.testing.assert_array_equal(mu.n_touch, np.asarray(jmu.n_touch))
    assert mu.n_touch.sum() == 3 and (m.n_touch == 0).all()  # the input is left as it was
    for e in np.nonzero(mu.n_touch)[0]:
        _close(mu.alpha[e], jmu.alpha[e])
        _close(mu.chol[e], jmu.chol[e])
    e = int(np.nonzero(mu.n_touch == 2)[0][0])
    ve = gpr.update(ex.expert_view(m, e), _t(tp[[0, 2]]), torch.zeros(2, dtype=torch.float64),
                    1e-6)
    # The single-model bordering, lifted to the committee: the same factor,
    # and the same expert posterior (alpha itself carries the Gram's
    # conditioning, ~1e2 here, and the library solve's threading).
    _close(mu.chol[e], ve.chol, 1e-10)
    _close(gpr.predict(ex.expert_view(mu, e), _t(_queries(32))),
           gpr.predict(ve, _t(_queries(32))), 1e-10)
    _same_posterior(mu, jmu, _queries(64))
    _, v0 = ex.predict(m, _t(tp))
    _, v1 = ex.predict(mu, _t(tp))
    assert bool((v1 <= v0 + 1e-12).all())


def test_touch_ladder_escalates_and_gives_up(four, monkeypatch):
    """The noise ladder: a bordered factor with a NaN on its touched
    diagonal is retried at 10x the floored noise; past the last rung the
    update raises, as the JAX package's does."""
    m, _ = four
    tp = np.array([[0.0, 0.0, 1.0]])
    real, seen = gpr.update, []

    def flaky(model, x, y, noise, fail_first=1):
        out = real(model, x, y, noise)
        seen.append(float(noise[0]))
        if len(seen) <= fail_first:
            chol = out.chol.clone()
            chol[model.n0, model.n0] = float("nan")
            out = dataclasses.replace(out, chol=chol)
        return out

    monkeypatch.setattr(gpr, "update", flaky)
    mu = ex.update(m, _t(tp), 0.0, 1e-6)
    assert seen == [pytest.approx(1e-6), pytest.approx(1e-5)]
    monkeypatch.setattr(gpr, "update", real)
    want = ex.update(m, _t(tp), 0.0, 1e-5)
    _close(mu.alpha, want.alpha, 0.0)
    monkeypatch.setattr(gpr, "update", lambda *a: flaky(*a, fail_first=99))
    with pytest.raises(FloatingPointError, match="touch bordering failed"):
        ex.update(m, _t(tp), 0.0, 1e-6, max_jitter_retries=2)


def test_fit_ladder_refits_only_the_failed_expert(fixture64, monkeypatch):
    """The fit's jitter ladder: an expert whose factor comes back NaN is
    refit alone at 4 eps B k0 on its noise; the others keep theirs."""
    ts, shared = fixture64
    real, calls = ex.lin.cholesky, []

    def flaky(a):
        calls.append(a.shape[0])
        out = real(a)
        if len(calls) == 3:  # expert 2's first attempt
            out.diagonal()[0] = float("nan")
        return out

    monkeypatch.setattr(ex.lin, "cholesky", flaky)
    m = ex.fit_experts("rbf", _t(ts.x), _t(ts.y), _t(ts.noise), kf.kernel_params(1.0, 1.0),
                       n_experts=4, n_shared_tail=shared)
    monkeypatch.setattr(ex.lin, "cholesky", real)
    assert len(calls) == 5
    ref = ex.fit_experts("rbf", _t(ts.x), _t(ts.y), _t(ts.noise), kf.kernel_params(1.0, 1.0),
                         n_experts=4, n_shared_tail=shared)
    jitter = 4.0 * np.finfo(np.float64).eps * m.capacity * 1.0
    assert torch.equal(m.noise[2], ref.noise[2] + jitter)
    assert torch.equal(m.noise[[0, 1, 3]], ref.noise[[0, 1, 3]])
    assert torch.equal(m.alpha[[0, 1, 3]], ref.alpha[[0, 1, 3]])


def test_committee_w_is_lower_triangular_and_refined(wide):
    """W exactly lower-triangular (Kernels D and F plan the lower triangle
    only), the inverse of each expert's factor, and JAX's W."""
    (m, jm), _ = wide
    for e in range(m.n_experts):
        w = m.linv[e]
        assert torch.equal(w, torch.tril(w))
        eye = torch.eye(m.capacity, dtype=w.dtype)
        _close(w @ m.chol[e], eye, 1e-9)
    _close(m.linv, jm.linv)


def test_newton_step_refines_w_and_keeps_it_lower_triangular(wide):
    """The step W <- tril(W + W (I - L W)) on an inverse carrying error in
    both triangles (as the JAX package's raw Pallas inverse can): the
    error falls quadratically and nothing is left above the diagonal."""
    (m, _), _ = wide
    l = m.chol[0]
    exact = torch.linalg.solve_triangular(l, torch.eye(m.capacity, dtype=l.dtype), upper=False)
    noise = torch.as_tensor(np.random.default_rng(30).normal(size=exact.shape))
    w = exact * (1.0 + 1e-6 * noise) + 1e-9 * noise
    out = torch.empty_like(w)
    ex._newton_w(l, w, out)
    assert torch.equal(out, torch.tril(out))
    before = float((torch.tril(w) - exact).abs().max())
    after = float((out - exact).abs().max())
    assert after < 1e-3 * before


@pytest.mark.parametrize("mode", ["rbcm", "bcm"])
def test_combine_weights_and_floor_match_jax_in_float32(mode):
    """The quad-noise floor eps max(16, GPIS_EXPERT_FLOOR_SCALE B) k0 (the
    same knob and default as JAX) and the rule's weights, where the floor
    binds: float32 at B = 7,168."""
    var = np.array([1e-9, 1e-6, 1e-4, 3e-4, 1e-2, 0.5, 1.0, 2.0], np.float32)
    beta, vc = ex._beta_weights(torch.as_tensor(var), 1.0, mode, torch.float32, 7168)
    jbeta, jvc = jex._beta_weights(jnp.asarray(var), jnp.float32(1.0), mode, jnp.float32, 7168)
    assert ex._FLOOR_SCALE == jex._FLOOR_SCALE
    np.testing.assert_allclose(vc.numpy(), np.asarray(jvc), rtol=1e-6)
    np.testing.assert_allclose(beta.numpy(), np.asarray(jbeta), rtol=1e-6, atol=1e-7)
    assert float(vc[0]) > 1e-4  # the floor binds at B = 7,168


def test_retain_chol_false_matches_and_updates(wide):
    (m_full, jm_full), (m_lean, _) = wide
    assert m_full.chol is not None and m_lean.chol is None and m_lean.linv is not None
    q = _queries(128)
    ma, va = _same_posterior(m_full, jm_full, q)
    mb, vb = ex.predict(m_lean, _t(q))
    _close(mb, ma, 1e-12)
    _close(vb, va, 1e-12)
    _close(ex.expert_chol(m_lean, 0), m_full.chol[0], 1e-9)
    tp = _t([[0.0, 0.0, 1.0]])
    u_full, u_lean = ex.update(m_full, tp, 0.0, 1e-6), ex.update(m_lean, tp, 0.0, 1e-6)
    assert u_lean.chol is None
    ma, va = ex.predict(u_full, _t(q))
    mb, vb = ex.predict(u_lean, _t(q))
    _close(mb, ma, 1e-9)
    _close(vb, va, 1e-9)


@pytest.mark.parametrize("layout", ["value", "lean", "no_factor", "joint"])
def test_checkpoint_both_ways(four, wide, joint4, layout, tmp_path):
    """A touched committee written by the port loads in the JAX package,
    which writes it again in its own layout for the port to read: the two
    files hold the same keys and meta, and every load answers as the saved
    committee (1e-6; the port's own round trip exactly)."""
    tp = np.array([[0.0, 0.0, 1.05 if layout == "joint" else 1.0]])
    m, _ = {"joint": joint4, "lean": wide[1]}.get(layout, four)
    if layout != "lean":
        m = dataclasses.replace(m, gate=2)
    m = ex.update(m, _t(tp), 0.0, 1e-6)
    factor = layout != "no_factor"
    ckpt.save_model(str(tmp_path / "port.npz"), m, factor=factor)
    by_jax = jckpt.load_model(str(tmp_path / "port.npz"))
    jckpt.save_model(str(tmp_path / "jax.npz"), by_jax, factor=factor)
    with np.load(tmp_path / "port.npz") as d, np.load(tmp_path / "jax.npz") as jd:
        assert sorted(d.files) == sorted(jd.files)
        assert json.loads(str(d["meta"])) == json.loads(str(jd["meta"]))
    q = _queries(64)
    own = ckpt.load_model(str(tmp_path / "port.npz"), device="cpu")
    from_jax = convert.load_jax_checkpoint(str(tmp_path / "jax.npz"), device="cpu")
    assert type(own).__name__ == type(by_jax).__name__ == "ExpertGPModel"
    assert (own.beta, own.gate, own.n0) == (m.beta, m.gate, m.n0)
    assert (own.chol is None) == (by_jax.chol is None) == (layout == "lean")
    np.testing.assert_array_equal(own.n_touch, m.n_touch)
    np.testing.assert_array_equal(np.asarray(by_jax.n_touch), m.n_touch)
    want = ex.predict(m, _t(q))
    _close(ex.predict(own, _t(q)), want, 0.0 if factor else 1e-9)
    _close(ex.predict(from_jax, _t(q)), want)
    _close(jex.predict(by_jax, _j(q)), want)
    if layout == "no_factor":
        assert own.chol is not None and own.linv is None
    # A touch after the load continues from the loaded factors.
    tp2 = _t([[0.5, 0.5, 0.7]])
    _close(ex.predict(ex.update(own, tp2, 0.0, 1e-6), _t(q)),
           ex.predict(ex.update(m, tp2, 0.0, 1e-6), _t(q)), 1e-9)


def test_poe_at_one_expert_is_the_exact_mll(one):
    m1, jm1 = one  # the PoE objective does not read the combine rule
    res = ex.optimize_experts(m1, steps=1, learn_noise=False)
    jres = jex.optimize_experts(jm1, steps=1, learn_noise=False)
    direct = gpr.log_marginal_likelihood("rbf", m1.x[0], m1.y[0], m1.noise[0], m1.params)
    np.testing.assert_allclose(res.history[0], float(direct), rtol=1e-10)
    np.testing.assert_allclose(res.history[0], jres.history[0], rtol=TOL)
    assert res.noise is None


def test_poe_improves_and_matches_jax(fixture64):
    """From a wrong lengthscale: the port's Adam steps track JAX's history
    and improve the objective, the noise scale on the real rows only."""
    ts, shared = fixture64
    kw = dict(n_experts=4, n_shared_tail=shared, touch_capacity=64)
    m = ex.fit_experts("rbf", _t(ts.x), _t(ts.y), _t(ts.noise), kf.kernel_params(3.0, 1.0), **kw)
    m = ex.update(m, _t([[0.0, 0.0, 1.0]]), 0.0, 1e-6)  # an occupied slot keeps its noise
    jm = jex.fit_experts("rbf", ts.x, ts.y, ts.noise, jkf.kernel_params(3.0, 1.0), **kw)
    jm = jex.update(jm, _j([[0.0, 0.0, 1.0]]), jnp.zeros(1), jnp.full(1, 1e-6))
    res = ex.optimize_experts(m, steps=6, learning_rate=0.1, learn_signal=True)
    jres = jex.optimize_experts(jm, steps=6, learning_rate=0.1, learn_signal=True)
    np.testing.assert_allclose(res.history, jres.history, rtol=TOL)
    assert res.mll > res.history[0]
    for k in ("lengthscale", "signal_variance"):
        np.testing.assert_allclose(res.params[k], float(jres.params[k]), rtol=TOL)
    np.testing.assert_allclose(res.noise_scale, float(jres.noise_scale), rtol=TOL)
    assert 0.1 < res.params["lengthscale"] < 3.0


def test_halo_overlap_partition(fixture64, four):
    m0, _ = four
    mh, jmh = _fit(fixture64, n_experts=4, n_halo=32)
    real0 = int((m0.noise[0] < 1e9).sum())
    realh = int((mh.noise[0] < 1e9).sum())
    assert realh >= real0 + 16
    _close(mh.x, jmh.x, 0.0)
    _same_posterior(mh, jmh, _queries(128))


# ------------------------------------------------------ joint (config-2 x EP)


@pytest.fixture(scope="module")
def joint_fixture(fixture64):
    """Normals and gradient noise in the session's `_joint_obs` layout."""
    ts, shared = fixture64
    c, n_s = ts.x.shape[0], ts.n_surface
    xs = np.asarray(ts.x)
    nrm = np.zeros((c, 3))
    nrm[:n_s] = xs[:n_s] / np.linalg.norm(xs[:n_s], axis=1, keepdims=True)
    noise_g = np.full((c,), 1e10)
    noise_g[:n_s] = 1e-2
    return ts, shared, nrm, noise_g


@pytest.fixture(scope="module")
def joint4(joint_fixture):
    return _fit_joint(joint_fixture, n_experts=4, touch_capacity=8)


def _fit_joint(fixture, **kw):
    ts, shared, nrm, ng = fixture
    kw.setdefault("n_shared_tail", shared)
    jm = jex.fit_experts_joint("rbf", ts.x, ts.y, _j(nrm), ts.noise, _j(ng),
                               jkf.kernel_params(1.0, 1.0), **kw)
    m = ex.fit_experts_joint("rbf", _t(ts.x), _t(ts.y), _t(nrm), _t(ts.noise), _t(ng),
                             kf.kernel_params(1.0, 1.0), **kw)
    return m, jm


def test_single_joint_expert_matches_dense_joint(joint_fixture):
    ts, _, nrm, ng = joint_fixture
    m1, jm1 = _fit_joint(joint_fixture, n_experts=1, beta="bcm", touch_capacity=0)
    assert m1.touch_x is None and m1.linv is not None
    ref = gpd.fit_with_normals("rbf", _t(ts.x), _t(ts.y), _t(nrm), _t(ts.noise), _t(ng),
                               kf.kernel_params(1.0, 1.0), touch_capacity=0)
    q = _queries(128)
    ma, va = _same_posterior(m1, jm1, q)
    mr, vr = gpd.predict(ref, _t(q))
    _close(ma, mr)
    _close(va, vr)


def test_joint_committee_tracks_exact_and_jax(joint_fixture, joint4):
    ts, _, nrm, ng = joint_fixture
    m4, jm4 = joint4
    assert (m4.n0, m4.touch_capacity) == (jm4.n0, jm4.touch_capacity)
    ref = gpd.fit_with_normals("rbf", _t(ts.x), _t(ts.y), _t(nrm), _t(ts.noise), _t(ng),
                               kf.kernel_params(1.0, 1.0), touch_capacity=0)
    q = _queries(48)
    q = q / np.linalg.norm(q, axis=1, keepdims=True) * 1.1
    ma, _ = _same_posterior(m4, jm4, q)
    mr, _ = gpd.predict(ref, _t(q))
    assert float(torch.max(torch.abs(ma - mr))) < 0.08
    # The gradient against central differences of the mean held to JAX
    # above (h 1e-5: truncation and rounding both under 1e-9 here).
    mean, g = ex.mean_and_gradient(m4, _t(q))
    _close(mean, ma, 1e-12)
    h = 1e-5
    fd = np.stack([(ex.predict_mean(m4, _t(q + h * e)) - ex.predict_mean(m4, _t(q - h * e)))
                   .numpy() / (2 * h) for e in np.eye(3)], axis=1)
    _close(g, fd)
    cos = torch.sum(g * _t(q), dim=1) / (g.norm(dim=1) * _t(q).norm(dim=1))
    assert float(cos.mean()) > 0.9


def test_joint_committee_touch_update_and_overflow(joint_fixture, joint4):
    m, jm = joint4
    tp = np.array([[0.0, 0.0, 1.05]])
    _, v0 = ex.predict(m, _t(tp))
    m2 = ex.update(m, _t(tp), 0.0, 1e-6)
    jm2 = jex.update(jm, _j(tp), jnp.zeros(1), jnp.full(1, 1e-6))
    np.testing.assert_array_equal(m2.n_touch, np.asarray(jm2.n_touch))
    mean2, v2 = _same_posterior(m2, jm2, np.concatenate([tp, _queries(32)]))
    assert float(v2[0]) < float(v0[0]) and abs(float(mean2[0])) < 0.1
    many = np.tile(tp, (m.touch_capacity, 1))
    with pytest.raises(ValueError, match="tactile slots would overflow"):
        ex.update(m2, _t(many), 0.0, 1e-6)
    with pytest.raises(ValueError, match="PoE objective covers value"):
        ex.optimize_experts(m2)
    ts, shared, nrm, ng = joint_fixture
    m0 = ex.fit_experts_joint("rbf", _t(ts.x), _t(ts.y), _t(nrm), _t(ts.noise), _t(ng),
                              kf.kernel_params(1.0, 1.0), n_experts=2, n_shared_tail=shared,
                              touch_capacity=0)
    with pytest.raises(ValueError, match="touch_capacity=0"):
        ex.update(m0, _t(tp), 0.0, 1e-6)


# --------------------------------------------------------------- sessions

SESSION_KW = dict(kernel="rbf", lengthscale=1.0, touch_capacity=64, dtype="float64")
EXPLORE_KW = dict(max_charts=4, n_disc_samples=8, variance_threshold=0.3)


def _sessions(pts, normals=None, **start):
    jsess = JaxSession(JaxModelConfig(**SESSION_KW), JaxExploreConfig(**EXPLORE_KW))
    sess = ObjectModelSession(ModelConfig(**SESSION_KW), ExploreConfig(**EXPLORE_KW),
                              device="cpu")
    return (sess.start(pts, normals=normals, **start),
            jsess.start(pts, normals=normals, **start))


def _cloud():
    """The value sessions' cloud: every session test starts the same
    committee, so the JAX package compiles its programs once."""
    return synthetic.sphere_cloud(600, radius=0.08, center=(0.1, 0.2, 0.3), seed=0,
                                  dtype=np.float64)[0]


def test_session_experts_end_to_end():
    pts = _cloud()
    sess, jsess = _sessions(pts, experts=4, expert_gate=2)
    assert type(sess.model).__name__ == "ExpertGPModel" and sess.model.gate == 2
    mean, var = sess.query(pts[:10])
    _close((mean, var), jsess.query(pts[:10]))
    assert np.abs(mean).max() < 0.05
    torch_jax_native.require()  # the JAX soup in its native order
    verts, faces, vvar = sess.extract_surface(resolution=24)
    jverts, jfaces, jvvar = jsess.extract_surface(resolution=24)
    np.testing.assert_array_equal(faces, jfaces)
    _close(verts, jverts)
    _close(vvar, jvvar)
    r = np.linalg.norm(verts - [0.1, 0.2, 0.3], axis=1)
    assert np.sqrt(np.mean((r - 0.08) ** 2)) < 2e-3
    for s in (sess, jsess):
        s.update(pts[:2])
    assert int(sess.model.n_touch.sum()) == 2
    _close(sess.query(pts[:20]), jsess.query(pts[:20]))
    got, ok = sess.surface_points(n=16)
    jgot, jok = jsess.surface_points(n=16)
    np.testing.assert_array_equal(ok, jok)
    _close(got, jgot)
    res, jres = sess.next_best_path(), jsess.next_best_path()
    assert res.path.shape[0] > 0
    _close(res.path, jres.path)
    # Chart for chart: the candidates' gating and the charts' variances as
    # the JAX planner reads them (variances ~1e-6 here: held relatively).
    np.testing.assert_allclose([c.variance for c in res.charts],
                               [c.variance for c in jres.charts], rtol=TOL)
    assert sess.is_done(32) == jsess.is_done(32)


@pytest.mark.parametrize("method", ["subsample", "poe"])
def test_session_hyperopt_refit_replays_touches(method):
    pts = _cloud()
    sess, jsess = _sessions(pts, experts=4, expert_gate=2)
    for s in (sess, jsess):
        s.update(pts[:2])
    kw = dict(subsample=200) if method == "subsample" else dict(method="poe")
    res = sess.optimize_hyperparameters(steps=3, **kw)
    jres = jsess.optimize_hyperparameters(steps=3, **kw)
    np.testing.assert_allclose(res.history, jres.history, rtol=TOL)
    np.testing.assert_allclose(res.params["lengthscale"], float(jres.params["lengthscale"]),
                               rtol=TOL)
    assert int(sess.model.n_touch.sum()) == 2
    np.testing.assert_array_equal(sess.model.n_touch, np.asarray(jsess.model.n_touch))
    _close(sess.query(pts[:20]), jsess.query(pts[:20]))
    with pytest.raises(ValueError, match="unknown hyperopt method"):
        sess.optimize_hyperparameters(method="bogus")


def test_session_joint_experts_end_to_end():
    cfg = dict(kernel="rbf", lengthscale=0.4, noise_surface=1e-3, block=64, touch_capacity=64,
               dtype="float64")
    pts = np.asarray(jgpis.fibonacci_sphere(300, radius=0.08), np.float64)
    nrm = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    jsess = JaxSession(JaxModelConfig(**cfg)).start(pts, normals=nrm, experts=4, expert_gate=2)
    sess = ObjectModelSession(ModelConfig(**cfg), device="cpu").start(
        pts, normals=nrm, experts=4, expert_gate=2)
    assert sess.model.joint and sess.model.n_experts == 4
    torch_jax_native.require()  # the JAX soup in its native order
    verts, faces, _ = sess.extract_surface(resolution=24)
    jverts, jfaces, _ = jsess.extract_surface(resolution=24)
    np.testing.assert_array_equal(faces, jfaces)
    _close(verts, jverts)
    assert np.sqrt(np.mean((np.linalg.norm(verts, axis=1) - 0.08) ** 2)) / 0.08 < 0.01
    for s in (sess, jsess):
        s.update(np.asarray([pts[0] * 1.2]))
    res = sess.optimize_hyperparameters(steps=2, subsample=128)
    jres = jsess.optimize_hyperparameters(steps=2, subsample=128)
    np.testing.assert_allclose(res.history, jres.history, rtol=TOL)
    assert sess.model.joint and int(sess.model.n_touch.sum()) == 1
    q = pts[::40] * 1.1
    _close(sess.query(q), jsess.query(q))


def test_session_experts_refusals_match_jax():
    pts, _ = synthetic.sphere_cloud(200, seed=0, dtype=np.float32)
    for s in (JaxSession(JaxModelConfig()), ObjectModelSession(ModelConfig(), device="cpu")):
        with pytest.raises(ValueError, match="does not compose with out_of_core"):
            s.start(pts, out_of_core=True, experts=4)
    # A restored committee keeps serving, but a refit needs the training set.
    cfg = ModelConfig(**SESSION_KW)
    sess = ObjectModelSession(cfg, device="cpu").start(pts.astype(np.float64), experts=2)
    sess.training = None
    with pytest.raises(ValueError, match="needs the original training set"):
        sess.optimize_hyperparameters(steps=1)
    with pytest.raises(ValueError, match="refitting a restored experts session"):
        sess.optimize_hyperparameters(steps=1, method="poe")


# ------------------------------------------------------ two gloo ranks


@pytest.fixture(scope="module")
def rank_outputs(fixture64, tmp_path_factory):
    ts, shared = fixture64
    rng = np.random.default_rng(21)
    clouds = [rng.normal(size=(n, 3)) for n in (50, 80, 70, 20)]
    inputs = dict(x=np.asarray(ts.x), y=np.asarray(ts.y), noise=np.asarray(ts.noise),
                  shared=np.array(shared), q=_queries(300, seed=1), ls=np.array(1.0),
                  pts=synthetic.sphere_cloud(200, seed=0)[0],
                  **{f"cloud{i}": c for i, c in enumerate(clouds)})
    return spawn_ranks("torch_session_rank.py", ["experts"], 2, inputs,
                       tmp_path_factory.mktemp("expert_ranks"))


def test_predict_sharded_on_two_ranks_matches_local_and_jax(fixture64, eight, rank_outputs):
    m, jm = eight
    q = _queries(300, seed=1)
    mean, var = ex.predict(m, _t(q), gate=0)
    jmean, jvar = jex.predict(jm, _j(q), gate=0)
    for out in rank_outputs:
        assert out["imported"] == ""
        _close(out["sharded_mean"], mean, 1e-12)
        _close(out["sharded_var"], var, 1e-12)
        _close(out["sharded_mean"], jmean)
        _close(out["sharded_var"], jvar)
        assert "separate scaling axes" in str(out["mesh_refusal"])
    assert [int(out["n_local"]) for out in rank_outputs] == [4, 4]
