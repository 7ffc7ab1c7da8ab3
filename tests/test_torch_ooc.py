"""The port's out-of-core (panel-streamed) fit and query against the JAX
package, on the CPU in float64 (the port's wrappers take their plain twins
for CPU tensors).

The kernels' twins are held to the Pallas kernels run in interpret mode,
called directly as tests/test_outofcore.py calls them: there `_dot3` is an
exact dot, so the bar is 1e-10.  The band quads keep a float32 scratch even
on float64 inputs, so they are held at the JAX tests' own 1e-5, and the
twins also to a float64 ||W kq^T||^2 at 1e-10.  The JAX out-of-core
pipeline runs its jnp forms on the CPU at these panel sizes, so the
end-to-end comparisons are exact-grade; their bar is BASELINE.md row 2,
1e-6 on posterior mean and variance."""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

from gpis_tpu import config as jconfig
from gpis_tpu.api.session import ObjectModelSession as JaxSession
from gpis_tpu.config import ModelConfig as JaxModelConfig
from gpis_tpu.gp import regression as jgpr
from gpis_tpu.kernels import functions as jkf
from gpis_tpu.kernels import pallas_joint as jpj
from gpis_tpu.kernels.pallas_gram import gram_band_pallas
from gpis_tpu.kernels.pallas_query import fused_quad_band_pallas
from gpis_tpu.linalg import outofcore as jooc
from gpis_tpu.linalg.pallas_chol import (gemm_nn_acc_masked_pallas, gemm_nt_masked_pallas,
                                         stripe_write_pallas)
from gpis_tpu_torch import config, convert
from gpis_tpu_torch.api.session import ObjectModelSession
from gpis_tpu_torch.data.gpis import fibonacci_sphere
from gpis_tpu_torch.gp import ooc_hyperopt as oho
from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.kernels import cuda_gram, cuda_joint, cuda_query
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.linalg import cuda_chol
from gpis_tpu_torch.linalg import outofcore as ooc
from gpis_tpu_torch.surface import grid

C, PANEL, BLOCK = 512, 128, 64
LS, SV = 0.7, 1.1


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _params():
    return kf.kernel_params(LS, SV), jkf.kernel_params(LS, SV)


@pytest.fixture(scope="module")
def problem():
    """A value problem of C - 40 points (padded to C) and queries."""
    rng = np.random.default_rng(91)
    x = rng.normal(size=(C - 40, 3))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = rng.normal(size=C - 40) * 0.3
    noise = rng.uniform(1e-4, 1e-2, size=C - 40)
    q = rng.normal(size=(300, 3)) * 0.8
    return x, y, noise, q


def _panels(store, nb):
    return [np.asarray(store.get(j)) for j in range(nb)]


# ---------------------------------------------------------------- kernels


@pytest.mark.parametrize("k0", [0, 256, 300, 1024])
def test_gemm_nt_masked_twin_matches_pallas(k0):
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(256, 1024)), rng.normal(size=(512, 1024))
    s = rng.normal(size=(256, 512))
    want = np.asarray(gemm_nt_masked_pallas(_j(a), _j(b), _j(s), k0))
    # The port takes S as a strided stripe of a wider buffer.
    wide = torch.zeros((256, 700), dtype=torch.float64)
    wide[:, 100:612] = _t(s)
    got = cuda_chol.gemm_nt_masked(_t(a), _t(b), wide[:, 100:612], k0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10)
    np.testing.assert_allclose(got.numpy(), s - a[:, :k0] @ b[:, :k0].T, atol=1e-10)


@pytest.mark.parametrize("w", [0, 100, 256, 512])
def test_gemm_nn_acc_masked_twin_matches_pallas(w):
    rng = np.random.default_rng(4)
    u, a, b = rng.normal(size=(256, 512)), rng.normal(size=(256, 256)), rng.normal(size=(256, 512))
    want = np.asarray(gemm_nn_acc_masked_pallas(_j(u), _j(a), _j(b), w))
    # A as a strided column slice of a wider L band, as the TRSM k-step passes it.
    band = torch.zeros((256, 1024), dtype=torch.float64)
    band[:, 512:768] = _t(a)
    got = cuda_chol.gemm_nn_acc_masked(_t(u).clone(), band[:, 512:768], _t(b), w)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10)


@pytest.mark.parametrize("c0", [0, 256, 768])
def test_stripe_write_twin_matches_pallas(c0):
    rng = np.random.default_rng(5)
    dst, blk = rng.normal(size=(256, 1024)), rng.normal(size=(256, 256))
    want = np.asarray(stripe_write_pallas(_j(dst), _j(blk), c0))
    got = cuda_chol.stripe_write(_t(dst).clone(), _t(blk), c0)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["rbf", "thin_plate", "laplace", "inverse_multiquadric"])
def test_gram_band_twin_matches_pallas(name):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(512, 3))
    noise = rng.uniform(1e-3, 1e-2, size=300)
    ls = 3.0 if name == "thin_plate" else 0.8
    p, jp = kf.kernel_params(ls, 1.2), jkf.kernel_params(ls, 1.2)
    row0 = 137
    got = cuda_gram.cov(name, _t(x[row0:row0 + 300]), _t(x), p, noise=_t(noise), sym=True,
                        row0=row0)
    want = gram_band_pallas(name, _j(x[row0:row0 + 300]), _j(x), jp, _j(noise), row0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10)
    band = got[:, row0:row0 + 300].diagonal()
    np.testing.assert_allclose(band.numpy(), float(kf.k_diag0(name, p)) + noise, atol=1e-12)


@pytest.mark.parametrize("gen", ["value", "joint"])
def test_quad_band_twin_matches_pallas(gen):
    rng = np.random.default_rng(7)
    c = 64 if gen == "joint" else 512  # joint: J = 4c = 256
    x = rng.normal(size=(c, 3))
    p, jp = _params()
    q = rng.normal(size=(40, 3))
    cols = _t(x) if gen == "value" else cuda_joint.pack_meta(cuda_joint.joint_meta(_t(x)))
    n = cols.shape[0]
    w_full = np.tril(rng.normal(size=(n, n)))
    for row0, r in [(0, 256), (n - 256, 256)]:
        band = w_full[row0:row0 + r]
        if gen == "value":
            want = fused_quad_band_pallas("rbf", _j(q), _j(x), jp, _j(band), row0)
        else:
            want = jpj.fused_joint_quad_band_pallas("rbf", _j(q), jpj.joint_meta(_j(x)), jp,
                                                    _j(band), row0)
        # The port takes the band trimmed to its true width, a strided view.
        got = cuda_query.quad_band(gen, "rbf", _t(q), cols, p, _t(w_full)[row0:row0 + r,
                                                                            :row0 + r], row0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        kq = cuda_query.generated_kq(gen, "rbf", _t(q), cols, p).numpy()
        v = band @ kq.T
        np.testing.assert_allclose(got.numpy(), (v * v).sum(axis=0), rtol=1e-10, atol=1e-10)


def test_trsm_finish_alias_case_matches_jax():
    """The TRSM finish multiplies rows of W by rows of the same buffer: the
    port bounds Kernel H's k extent at r0 (reads rows < r0, writes rows
    r0..r0+block) where the JAX body masks A's columns >= r0."""
    rng = np.random.default_rng(8)
    # j0 on the 256 tile: the Pallas stripe write rounds an unaligned c0 down.
    rows, c, j0, block = 256, 768, 256, 64
    g = rng.normal(size=(rows, rows))
    ljj = np.linalg.cholesky(g @ g.T / rows + np.eye(rows))
    u = np.zeros((rows, c))
    u[:, :j0] = rng.normal(size=(rows, j0))
    # One block step, as the finish makes it.
    x = rng.normal(size=(rows, c))
    r0, width = 128, j0 + rows
    a = np.where(np.arange(rows)[None, :] < r0, ljj[r0:r0 + block], 0.0)
    want = np.asarray(gemm_nn_acc_masked_pallas(_j(x[r0:r0 + block]), _j(-a), _j(x), width))
    xt = _t(x).clone()
    cuda_chol.gemm_nn_acc_masked(xt[r0:r0 + block], -_t(ljj)[r0:r0 + block, :r0], xt[:r0], width)
    np.testing.assert_allclose(xt[r0:r0 + block].numpy(), want, atol=1e-10)
    np.testing.assert_array_equal(xt[:r0].numpy(), x[:r0])
    # The whole finish.
    want = np.asarray(jooc._trsm_finish(_j(ljj), _j(u), j0, block=block))
    ut = _t(u).clone()
    ooc._trsm_finish(_t(ljj), ut, j0, block=block)
    np.testing.assert_allclose(ut.numpy(), want, atol=1e-10)


# ----------------------------------------------------------------- phases


@pytest.mark.parametrize("store,sweep", [("device", 1), ("device", 2), ("host", 1),
                                         ("host", 2)])
def test_ooc_phases_match_jax(problem, store, sweep):
    x, y, noise, _ = problem
    xp, yp, np_, p, c, n, _ = ooc._pad_problem("rbf", _t(x), _t(y), _t(noise), _params()[0],
                                               panel=PANEL, pad_noise=1e10)
    jp = jkf.kernel_params(LS, SV)
    nb = c // PANEL
    st = ooc._make_store(store, ooc.DeviceBudget(0), "cpu")
    ok, u = ooc.ooc_cholesky("rbf", xp, np_, p, st, panel=PANEL, block=BLOCK, sweep=sweep,
                             y=yp)
    jst = jooc.HostPanelStore() if store == "host" else jooc.DevicePanelStore()
    jok, ju = jooc.ooc_cholesky("rbf", _j(xp), _j(np_), jp, jst, panel=PANEL, block=BLOCK,
                                sweep=sweep, y=_j(yp))
    assert ok and jok
    for got, want in zip(_panels(st, nb), _panels(jst, nb)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-10)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=1e-10)
    alpha = ooc.ooc_alpha_backward(st, u, panel=PANEL)
    np.testing.assert_allclose(alpha.numpy(),
                               np.asarray(jooc.ooc_alpha_backward(jst, ju, panel=PANEL)),
                               atol=1e-8)
    wst = ooc._make_store(store, ooc.DeviceBudget(0), "cpu")
    assert ooc.ooc_trsm(st, wst, yp, panel=PANEL, block=BLOCK, accumulate_alpha=False,
                        sweep=sweep) is None
    jwst = jooc.HostPanelStore() if store == "host" else jooc.DevicePanelStore()
    jooc.ooc_trsm(jst, jwst, _j(yp), panel=PANEL, block=BLOCK, accumulate_alpha=False,
                  sweep=sweep)
    assert not any(j in st for j in range(nb))  # the TRSM consumed L
    for got, want in zip(_panels(wst, nb), _panels(jwst, nb)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-8)


@pytest.fixture(scope="module")
def jax_models(problem):
    """The JAX package's value and joint out-of-core fits, tiered with a
    budget of two full-width panels so that both spill."""
    x, y, noise, _ = problem
    jp = jkf.kernel_params(LS, SV)
    value = jooc.ooc_fit("rbf", _j(x), _j(y), _j(noise), jp, panel=PANEL, block=BLOCK,
                         store="tiered", device_budget=2 * PANEL * C * 8)
    xn = x[:200]
    joint = jooc.ooc_fit_joint("rbf", _j(xn), _j(y[:200]), _j(xn), _j(noise[:200]), 1e-2, jp,
                               panel=256, block=BLOCK, store="tiered",
                               device_budget=2 * 256 * 1024 * 8)
    return {"value": value, "joint": joint}


def _port_fit(kind, problem, store, budget=None):
    x, y, noise, _ = problem
    p = _params()[0]
    if kind == "value":
        return ooc.ooc_fit("rbf", _t(x), _t(y), _t(noise), p, panel=PANEL, block=BLOCK,
                           store=store, device_budget=budget)
    xn = x[:200]
    return ooc.ooc_fit_joint("rbf", _t(xn), _t(y[:200]), _t(xn), _t(noise[:200]), 1e-2, p,
                             panel=256, block=BLOCK, store=store, device_budget=budget)


@pytest.mark.parametrize("kind,store", [("value", "tiered"), ("value", "device"),
                                        ("joint", "tiered"), ("joint", "host")])
def test_ooc_fit_predict_matches_jax(problem, jax_models, kind, store):
    q = problem[3]
    jm = jax_models[kind]
    budget = 2 * jm.panel * jm.alpha.shape[0] * 8 if store == "tiered" else None
    m = _port_fit(kind, problem, store, budget)
    assert isinstance(m, ooc.OOCJointModel) == (kind == "joint")
    assert m.alpha.shape == jm.alpha.shape and m.capacity == jm.capacity
    if store == "tiered":
        # Both spilled the same panels, and the spilled ones sit in host RAM.
        jspilled = sorted(j for j, (on_dev, _) in jm.wstore._meta.items() if not on_dev)
        assert m.wstore.spilled() == jspilled and jspilled
    mean, var = m.predict(_t(q), chunk=128)
    jmean, jvar = jm.predict(_j(q), chunk=128)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=1e-6)
    # Routing: regression and the grid take the out-of-core query.
    np.testing.assert_allclose(gpr.predict_mean(m, _t(q)).numpy(), mean.numpy(), atol=1e-12)
    gmean, gvar = grid.evaluate_points_chunked(m, _t(q))
    np.testing.assert_allclose(gvar.numpy(), var.numpy(), atol=1e-12)
    if store == "tiered":  # serving mode: everything back on the device
        assert m.promote_for_serving() > 0 and not m.wstore.spilled()
        np.testing.assert_allclose(m.predict(_t(q))[1].numpy(), var.numpy(), atol=1e-12)
        m.wstore.clear()
        assert m.wstore._budget._used == 0


@pytest.mark.parametrize("kind", ["value", "joint"])
def test_ooc_predict_on_converted_jax_model(problem, jax_models, kind):
    jm = jax_models[kind]
    arrays = {"x": jm.x, "y": jm.y, "noise": jm.noise, "alpha": jm.alpha}
    if kind == "joint":
        arrays.update(meta=jm.meta, normals=jm.normals, noise_g=jm.noise_g)
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    nb = jm.alpha.shape[0] // jm.panel
    m = convert.ooc_model_from_arrays(arrays, _panels(jm.wstore, nb), kernel=jm.kernel,
                                      params={k: float(v) for k, v in jm.params.items()},
                                      panel=jm.panel, n_real=jm.n_real, device="cpu")
    q = problem[3]
    mean, var = ooc.ooc_predict(m, _t(q), chunk=100)
    jmean, jvar = jm.predict(_j(q), chunk=128)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-10)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=1e-10)


def _touch_batches(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(k, 3)) * 0.8 for k in (3, 2)]


@pytest.mark.parametrize("kind", ["value", "joint"])
def test_ooc_update_matches_jax(problem, jax_models, kind):
    """tests/test_outofcore.py's test_ooc_update_matches_incore_bordering
    and tests/test_ooc_joint.py's test_ooc_joint_update_matches_dense_bordering:
    two batches bordered into the tail of a tiered fit whose W spills (so
    the update streams host panels), held to JAX's update: the query with
    the tail's share, the mean alone, the tail's arrays and alpha."""
    q = problem[3]
    jm = jax_models[kind]
    m = _port_fit(kind, problem, "tiered", 2 * jm.panel * jm.alpha.shape[0] * 8)
    assert m.wstore.spilled() and m.u is not None
    mean0, var0 = m.predict(_t(q), chunk=128)
    for tx in _touch_batches(23):
        m = m.update(_t(tx), 0.0, 1e-6, tail_capacity=8)
        jm = jm.update(_j(tx), 0.0, 1e-6, tail_capacity=8)
    assert m.n_tail == jm.n_tail == 5
    mean, var = m.predict(_t(q), chunk=128)
    jmean, jvar = jm.predict(_j(q), chunk=128)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=1e-6)
    np.testing.assert_allclose(gpr.predict_mean(m, _t(q)).numpy(),
                               np.asarray(jgpr.predict_mean(jm, _j(q))), atol=1e-6)
    np.testing.assert_allclose(grid.evaluate_points_chunked(m, _t(q), want_var=False)[0].numpy(),
                               mean.numpy(), atol=1e-10)
    for key in ("alpha", "alpha0", "tail_x", "tail_y", "tail_noise", "tail_v", "tail_a",
                "tail_chol", "tail_alpha"):
        np.testing.assert_allclose(getattr(m, key).numpy(), np.asarray(getattr(jm, key)),
                                   atol=1e-6, err_msg=key)
    # The model the updates started from still predicts as before.
    first = _port_fit(kind, problem, "device")
    np.testing.assert_allclose(first.update(_t(_touch_batches(23)[0]), 0.0, 1e-6,
                                            tail_capacity=8).alpha0.numpy(),
                               first.alpha.numpy(), atol=0)
    np.testing.assert_allclose(first.predict(_t(q), chunk=128)[1].numpy(), var0.numpy(),
                               atol=1e-10)


def test_ooc_update_matches_incore_bordering(problem):
    """The out-of-core bordering against the JAX package's in-core one on
    the same points (the same system, the factor streamed)."""
    x, y, noise, q = problem
    m = _port_fit("value", problem, "device")
    jp = jkf.kernel_params(LS, SV)
    ref = jgpr.with_linv(jgpr.fit("rbf", _j(x), _j(y), _j(noise), jp, block=PANEL,
                                  touch_capacity=8), block=PANEL)
    for tx in _touch_batches(24):
        m = m.update(_t(tx), 0.0, 1e-6, tail_capacity=8)
        ref = jgpr.update(ref, _j(tx), jnp.zeros(len(tx)), 1e-6)
    mean, var = m.predict(_t(q), chunk=64)
    rmean, rvar = jgpr.predict(ref, _j(q))
    np.testing.assert_allclose(mean.numpy(), np.asarray(rmean), atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(rvar), atol=1e-6)
    _, var_t = m.predict(_t(_touch_batches(24)[0]), chunk=64)
    assert float(var_t.max()) < 1e-4


@pytest.mark.parametrize("case", ["full", "no_u"])
def test_ooc_update_guards_raise_as_jax(problem, jax_models, case):
    jm = jax_models["value"]
    m = _port_fit("value", problem, "device")
    rng = np.random.default_rng(5)
    if case == "full":
        first = rng.normal(size=(3, 3))
        m = m.update(_t(first), 0.0, 1e-6, tail_capacity=4)
        jm = jm.update(_j(first), 0.0, 1e-6, tail_capacity=4)
        tx = rng.normal(size=(2, 3))
    else:
        m, jm = dataclasses.replace(m, u=None), dataclasses.replace(jm, u=None)
        tx = np.zeros((1, 3))
    with pytest.raises(ValueError) as e:
        jm.update(_j(tx), 0.0, 1e-6)
    with pytest.raises(ValueError, match=f"^{re.escape(str(e.value))}$"):
        m.update(_t(tx), 0.0, 1e-6)


@pytest.mark.parametrize("kind", ["value", "joint"])
def test_touched_jax_ooc_model_converts_and_updates_alike(problem, jax_models, kind):
    """`convert.ooc_model_from_arrays` carries u, alpha0, n_tail and the
    tail: the touched JAX model predicts the same in the port, and one more
    update on each side agrees too."""
    t1, t2 = _touch_batches(25)
    jm = jax_models[kind].update(_j(t1), 0.0, 1e-6, tail_capacity=8)
    keys = ["x", "y", "noise", "alpha", "u", "alpha0", "n_tail", "tail_x", "tail_y",
            "tail_noise", "tail_v", "tail_a", "tail_chol", "tail_alpha"]
    if kind == "joint":
        keys += ["meta", "normals", "noise_g"]
    arrays = {k: np.asarray(getattr(jm, k)) for k in keys}
    nb = jm.alpha.shape[0] // jm.panel
    m = convert.ooc_model_from_arrays(arrays, _panels(jm.wstore, nb), kernel=jm.kernel,
                                      params={k: float(v) for k, v in jm.params.items()},
                                      panel=jm.panel, n_real=jm.n_real, device="cpu")
    assert m.n_tail == 3
    q = problem[3]
    for a, b in ((m, jm), (m.update(_t(t2), 0.0, 1e-6), jm.update(_j(t2), 0.0, 1e-6))):
        mean, var = a.predict(_t(q), chunk=100)
        jmean, jvar = b.predict(_j(q), chunk=128)
        np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-6)
        np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=1e-6)


def test_ooc_jitter_ladder_escalates():
    """Exact duplicate points and near-zero noise force a NaN factor first;
    the ladder escalates and the fit stays finite, as in the JAX package."""
    x = fibonacci_sphere(128)
    xd = np.concatenate([x, x])
    p = _params()[0]
    m = ooc.ooc_fit("rbf", _t(xd), torch.zeros(256, dtype=torch.float64), 1e-18, p,
                    panel=PANEL, block=BLOCK)
    assert float((m.noise[:256] - 1e-18).min()) > 0  # the jitter was folded in
    mean, var = m.predict(_t(np.random.default_rng(11).normal(size=(32, 3))))
    assert torch.isfinite(mean).all() and torch.isfinite(var).all()


# ---------------------------------------------------------------- session


@pytest.mark.parametrize("normals", [False, True])
def test_ooc_session_matches_jax_session(normals):
    cfg = config.ModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3, n_external=64,
                             dtype="float64")
    center = np.array([0.3, -0.2, 1.0])
    pts = fibonacci_sphere(120 if normals else 300) * 1.7 + center
    kw = {"normals": (pts - center) / 1.7} if normals else {}
    sess = ObjectModelSession(cfg, device="cpu").start(pts, out_of_core=True, **kw)
    jsess = JaxSession(JaxModelConfig(**dataclasses.asdict(cfg))).start(pts, out_of_core=True,
                                                                        **kw)
    assert type(sess.model).__name__ == type(jsess.model).__name__
    assert sess.model.panel == jsess.model.panel and sess.model.capacity == jsess.model.capacity
    verts, faces, vvar = sess.extract_surface(resolution=16, extent=1.3)
    jverts, jfaces, jvvar = jsess.extract_surface(resolution=16, extent=1.3)
    np.testing.assert_array_equal(faces, jfaces)
    np.testing.assert_allclose(verts, jverts, atol=1e-6)
    np.testing.assert_allclose(vvar, jvvar, atol=1e-6)
    qpts = np.concatenate([pts[:20], np.random.default_rng(1).uniform(-1, 1, (80, 3)) + center])
    np.testing.assert_allclose(sess.query(qpts), jsess.query(qpts), atol=1e-6)
    # Tactile updates border into the in-core tail of max(touch_capacity, 64)
    # slots, as in the JAX session.
    touch = pts[:3] * 1.02
    _, v0 = sess.query(touch)
    for s_ in (sess, jsess):
        s_.update(touch)
        s_.update(touch[:1] * 1.05, targets=np.array([0.1]))
    assert sess.model.n_tail == jsess.model.n_tail == 4
    assert sess.model.tail_x.shape[0] == jsess.model.tail_x.shape[0] == max(cfg.touch_capacity, 64)
    mean, var = sess.query(touch)
    assert np.all(var < v0)
    np.testing.assert_allclose(sess.query(qpts), jsess.query(qpts), atol=1e-6)


# ------------------------------------------------------------ the package


def test_model_config_matches_jax():
    assert dataclasses.asdict(config.ModelConfig()) == dataclasses.asdict(jconfig.ModelConfig())
    assert dataclasses.asdict(config.MeshConfig()) == dataclasses.asdict(jconfig.MeshConfig())


@pytest.mark.parametrize("call,item", [
    (lambda m: oho.ooc_mll_and_grad_solve_phase("spill", noise_base=m.noise), "item 15"),
    (lambda m: ooc.ooc_residual_check(m), "item 15"),
    (lambda m: ooc.plan_sweeps(m.capacity, m.panel), "item 15"),
    (lambda m: ooc.ooc_fit("rbf", m.x, m.y, m.noise, m.params, panel=128, w_dtype="float16"),
     "item 15"),
])
def test_unported_out_of_core_parts_raise(call, item):
    x = torch.as_tensor(fibonacci_sphere(100))
    m = ooc.ooc_fit("rbf", x, torch.zeros(100, dtype=torch.float64), 1e-3, _params()[0],
                    panel=PANEL, block=BLOCK)
    with pytest.raises(NotImplementedError, match=item):
        call(m)
