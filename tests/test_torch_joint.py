"""The port's config-2 joint (value + surface-normal) path against the JAX
package and the NumPy/SciPy oracle, on the CPU in float64 (the port's
wrappers take their plain twins for CPU tensors).  The Pallas side runs in
interpret mode, as tests/test_pallas_joint.py runs it, at joint sizes of
256-512 so each Pallas grid is a step or a few.  The bar for the slice is
BASELINE.md row 2: 1e-6 on posterior mean and variance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)
import torch_jax_native

import oracle
from gpis_tpu.api.session import ObjectModelSession as JaxSession
from gpis_tpu.config import ModelConfig
from gpis_tpu.data import synthetic
from gpis_tpu.gp import derivative as jgpd
from gpis_tpu.kernels import derivative as jkd
from gpis_tpu.kernels import functions as jkf
from gpis_tpu.kernels import pallas_joint as jpj
from gpis_tpu.utils import checkpoint as jckpt
from gpis_tpu_torch import _build, convert
from gpis_tpu_torch.api.session import ObjectModelSession
from gpis_tpu_torch.data.gpis import fibonacci_sphere
from gpis_tpu_torch.gp import derivative as gpd
from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.kernels import cuda_joint, cuda_query
from gpis_tpu_torch.kernels import derivative as kd
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.surface import grid

DERIV_KERNELS = ["rbf", "thin_plate", "inverse_multiquadric"]
# Thin plate's scale R must exceed the cloud's diameter to stay usable.
LENGTHSCALE = {"rbf": 0.8, "thin_plate": 3.0, "laplace": 0.8, "inverse_multiquadric": 0.8}


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _params(name, sv=1.2):
    return kf.kernel_params(LENGTHSCALE[name], sv), jkf.kernel_params(LENGTHSCALE[name], sv)


@pytest.mark.parametrize("name", ["rbf", "thin_plate", "laplace", "inverse_multiquadric"])
def test_derivative_functions_match_jax(name):
    rng = np.random.default_rng(2)
    r2 = np.concatenate([[0.0, 1e-40, 1e-20], rng.uniform(0, 9, size=200)])
    p, jp = _params(name)
    assert kf.supports_derivatives(name) == jkf.supports_derivatives(name)
    np.testing.assert_allclose(kf.dk_dr2(name, _t(r2), p).numpy(),
                               np.asarray(jkf.dk_dr2(name, _j(r2), jp)), rtol=1e-12, atol=1e-12)
    if name == "laplace":
        with pytest.raises(ValueError, match="second derivatives"):
            kf.d2k_dr2(name, _t(r2), p)
        return
    np.testing.assert_allclose(kf.d2k_dr2(name, _t(r2), p).numpy(),
                               np.asarray(jkf.d2k_dr2(name, _j(r2), jp)), rtol=1e-12, atol=1e-12)


def _meta_pair(meta, rows=None):
    """The port's and the JAX package's form of one metadata triple."""
    sel = (lambda a: a) if rows is None else (lambda a: a[rows])
    return (tuple(sel(m) for m in meta), tuple(_j(sel(m).numpy()) for m in meta))


@pytest.mark.parametrize("case", ["gram_touch", "band", "cross", "thin_plate_coincident"])
def test_joint_rows_twin_matches_joint_rows_pallas(case):
    rng = np.random.default_rng(5)
    name = "thin_plate" if case == "thin_plate_coincident" else "rbf"
    p, jp = _params(name)
    x = rng.normal(size=(60, 3))
    if case == "thin_plate_coincident":
        x[30:40] = x[:10]  # distinct indices, coincident points
    tx = rng.normal(size=(16, 3)) if case in ("gram_touch", "band") else None
    meta = cuda_joint.joint_meta(_t(x), None if tx is None else _t(tx))
    j = meta[0].shape[0]
    noise = _t(rng.uniform(1e-3, 1e-2, size=j))
    cmeta, jcmeta = _meta_pair(meta)
    if case == "cross":
        q = np.concatenate([x[:8], rng.normal(size=(40, 3))])  # 8 queries on data points
        rmeta, jrmeta = _meta_pair(cuda_joint.value_meta(_t(q)))
        got = cuda_joint.joint_rows(name, rmeta, cmeta, p)
        want = jpj.joint_rows_pallas(name, jrmeta, jcmeta, jp)
    elif case == "band":
        r0 = 100
        rmeta, jrmeta = _meta_pair(meta, slice(r0, r0 + 70))
        got = cuda_joint.joint_rows(name, rmeta, cmeta, p, noise_col=noise, row0=r0)
        want = jpj.joint_rows_pallas(name, jrmeta, jcmeta, jp, noise_col=_j(noise), row0=r0)
    else:
        got = cuda_joint.joint_rows(name, cmeta, cmeta, p, noise_col=noise)
        want = jpj.joint_rows_pallas(name, jcmeta, jcmeta, jp, noise_col=_j(noise), row0=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", DERIV_KERNELS)
def test_joint_gram_matches_jax_and_oracle(name):
    rng = np.random.default_rng(6)
    p, jp = _params(name)
    x, tx = rng.normal(size=(23, 3)), rng.normal(size=(7, 3))
    nf, ng, tn = (rng.uniform(1e-3, 1e-2, size=n) for n in (23, 23, 7))
    got = kd.joint_gram(name, _t(x), p, noise_f=_t(nf), noise_g=_t(ng), touch_x=_t(tx),
                        touch_noise=_t(tn))
    want = jkd.joint_gram(name, _j(x), jp, noise_f=_j(nf), noise_g=_j(ng), touch_x=_j(tx),
                          touch_noise=_j(tn))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    ref = kd.joint_gram_reference(name, _t(x), p, noise_f=_t(nf), noise_g=_t(ng))
    np.testing.assert_allclose(ref.numpy(), np.asarray(jkd.joint_gram_reference(
        name, _j(x), jp, noise_f=_j(nf), noise_g=_j(ng))), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[:92, :92].numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)
    want = oracle.gram_joint(name, x, LENGTHSCALE[name], 1.2, nf, np.tile(ng, 3))
    np.testing.assert_allclose(ref.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", DERIV_KERNELS)
def test_cross_blocks_match_jax(name):
    rng = np.random.default_rng(8)
    p, jp = _params(name)
    x, q = rng.normal(size=(30, 3)), rng.normal(size=(20, 3))
    q[:3] = x[:3]  # queries on data points: the masked d2k term
    for fn in ("cross_cov_value", "cross_cov_grad", "cross_cov_grad_value"):
        got = getattr(kd, fn)(name, _t(q), _t(x), p)
        want = getattr(jkd, fn)(name, _j(q), _j(x), jp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12,
                                   err_msg=fn)
    nrm = rng.normal(size=(30, 3))
    np.testing.assert_array_equal(kd.joint_targets(_t(x[:, 0]), _t(nrm)).numpy(),
                                  np.asarray(jkd.joint_targets(_j(x[:, 0]), _j(nrm))))


def test_laplace_is_refused_for_derivative_observations():
    p = kf.kernel_params(0.8, 1.0)
    x = torch.zeros((3, 3), dtype=torch.float64)
    for call in (lambda: kd.joint_gram("laplace", x, p),
                 lambda: kd.cross_cov_value("laplace", x, x, p),
                 lambda: gpd.fit_with_normals("laplace", x, x[:, 0], x, 1e-3, 1e-3, p)):
        with pytest.raises(ValueError, match="derivative"):
            call()


def _joint_model(name, touch, linv, c=64):
    """A fitted float64 joint model on a sphere of c points, the port's and
    the JAX package's, fitted alike."""
    x = fibonacci_sphere(c)
    p, jp = _params(name, 1.0)
    args = (x, np.zeros(c), x, 1e-4, 1e-3)
    model = gpd.fit_with_normals(name, *(_t(a) for a in args[:3]), *args[3:], p, block=64,
                                 touch_capacity=touch)
    jmodel = jgpd.fit_with_normals(name, *(_j(a) for a in args[:3]), *args[3:], jp, block=64,
                                   touch_capacity=touch)
    if linv:
        model, jmodel = gpd.with_linv_joint(model), jgpd.with_linv_joint(jmodel)
    return model, jmodel


@pytest.mark.parametrize("touch", [0, 128])
def test_joint_on_the_fly_twin_matches_fused_joint_query_pallas(touch):
    model, _ = _joint_model("rbf", touch, linv=True)
    q = np.random.default_rng(3).normal(size=(100, 3)) * 0.8
    mean, quad = cuda_joint.fused_joint_query("rbf", _t(q), model.x, model.params, model.alpha,
                                              model.linv, model.touch_x, staged=False)
    jmean, jquad = jpj.fused_joint_query_pallas(
        "rbf", _j(q), _j(model.x.numpy()), jkf.kernel_params(0.8, 1.0), _j(model.alpha.numpy()),
        _j(model.linv.numpy()), touch_x=None if touch == 0 else _j(model.touch_x.numpy()),
        staged=False)
    # float32-grade on the Pallas side (its v scratch and mean dot are
    # float32), as in test_torch_kernels' staged test.
    np.testing.assert_allclose(quad.numpy(), np.asarray(jquad), rtol=1e-5, atol=1e-5)
    scale = (gpd.joint_cross_value(model, _t(q)).abs() @ model.alpha.abs()).numpy()
    assert np.all(np.abs(mean.numpy() - np.asarray(jmean)) <= 1e-6 * scale + 1e-12)


@pytest.mark.parametrize("over_cap,staged,route", [
    (False, None, "staged_quad"), (True, None, "fused_quad"), (True, True, "staged_quad")])
def test_fused_joint_query_routes_by_staged_size(monkeypatch, over_cap, staged, route):
    model, _ = _joint_model("rbf", 0, linv=True)
    q = _t(np.random.default_rng(4).normal(size=(50, 3)))
    if over_cap:
        monkeypatch.setattr(cuda_query, "KQ_STAGE_MAX", 50 * 256 * 8 - 1)
    calls = []
    for fn in ("staged_quad", "fused_quad"):
        real = getattr(cuda_query, fn)
        monkeypatch.setattr(cuda_query, fn,
                            lambda *a, _real=real, _fn=fn: calls.append(_fn) or _real(*a))
    mean, quad = cuda_joint.fused_joint_query("rbf", q, model.x, model.params, model.alpha,
                                              model.linv, staged=staged)
    assert calls == [route]
    kq = gpd.joint_cross_value(model, q)
    want = cuda_query.staged_quad_reference(kq, model.linv, model.alpha)
    np.testing.assert_allclose(mean.numpy(), want[0].numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(quad.numpy(), want[1].numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name,touch,linv", [("rbf", 16, True), ("thin_plate", 0, False),
                                             ("inverse_multiquadric", 0, True)])
def test_fit_with_normals_matches_jax_and_oracle(name, touch, linv):
    pts, nrm = synthetic.ellipsoid_cloud(40, seed=9)
    ls = LENGTHSCALE[name]
    p, jp = kf.kernel_params(ls, 1.0), jkf.kernel_params(ls, 1.0)
    model = gpd.fit_with_normals(name, _t(pts), torch.zeros(40, dtype=torch.float64), _t(nrm),
                                 1e-4, 1e-3, p, block=8, touch_capacity=touch)
    jmodel = jgpd.fit_with_normals(name, _j(pts), jnp.zeros(40), _j(nrm), 1e-4, 1e-3, jp,
                                   block=8, touch_capacity=touch)
    assert model.chol.shape == jmodel.chol.shape and model.touch_capacity == jmodel.touch_capacity
    if linv:
        model, jmodel = gpd.with_linv_joint(model), jgpd.with_linv_joint(jmodel)
    q = np.random.default_rng(10).normal(size=(25, 3))
    mean, var = gpr.predict(model, _t(q))
    jmean, jvar = jgpd.predict(jmodel, _j(q))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=1e-6)
    om = oracle.fit_joint(name, pts, np.zeros(40), nrm, 1e-4, 1e-3, ls, 1.0)
    omean, ovar = oracle.predict_joint(om, q)
    np.testing.assert_allclose(mean.numpy(), omean, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), ovar, atol=1e-6)
    np.testing.assert_allclose(gpr.predict_mean(model, _t(q)).numpy(), omean, atol=1e-6)
    grad = gpd.predict_gradient(model, _t(q)).numpy()
    np.testing.assert_allclose(grad, np.asarray(jgpd.predict_gradient(jmodel, _j(q))), atol=1e-6)
    # The gradient of the oracle's posterior mean, by central differences.
    h = 1e-5
    fd = np.stack([(oracle.predict_joint(om, q + h * e)[0] - oracle.predict_joint(om, q - h * e)[0])
                   / (2 * h) for e in np.eye(3)], axis=1)
    np.testing.assert_allclose(grad, fd, atol=1e-6)


@pytest.mark.parametrize("touch", [0, 64])
def test_session_with_normals_matches_jax_session(monkeypatch, touch):
    cfg = ModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3, n_external=64,
                      touch_capacity=touch, dtype="float64")
    center = np.array([0.3, -0.2, 1.0])
    pts = fibonacci_sphere(100) * 1.7 + center
    nrm = (pts - center) / 1.7
    sess = ObjectModelSession(cfg, device="cpu").start(pts, normals=nrm)
    jsess = JaxSession(cfg).start(pts, normals=nrm)
    assert sess.model.chol.shape == jsess.model.chol.shape
    assert sess.model.linv is not None
    mean, var, _ = sess.evaluate_grid(16, 1.3)
    jmean, jvar, _ = jsess.evaluate_grid(16, 1.3)
    np.testing.assert_allclose(mean, jmean, atol=1e-6)
    np.testing.assert_allclose(var, jvar, atol=1e-6)
    torch_jax_native.require()  # the JAX soup in its native order
    verts, faces, vvar = sess.extract_surface(resolution=16, extent=1.3)
    jverts, jfaces, jvvar = jsess.extract_surface(resolution=16, extent=1.3)
    np.testing.assert_array_equal(faces, jfaces)
    np.testing.assert_allclose(verts, jverts, atol=1e-6)
    np.testing.assert_allclose(vvar, jvvar, atol=1e-6)
    qpts = np.concatenate([pts[:20], np.random.default_rng(1).uniform(-1, 1, (80, 3)) + center])
    want = jsess.query(qpts)
    np.testing.assert_allclose(sess.query(qpts), want, atol=1e-6)
    # The same query over the staging cap: the on-the-fly joint route.
    monkeypatch.setattr(cuda_query, "KQ_STAGE_MAX", 4096)
    np.testing.assert_allclose(sess.query(qpts), want, atol=1e-6)
    qm = sess.query(pts[:20])[0]
    np.testing.assert_allclose(qm, 0.0, atol=0.05)  # surface points sit on f = 0


@pytest.mark.parametrize("touch,linv", [(64, True), (0, False)])
def test_jax_joint_checkpoint_carries_across(tmp_path, touch, linv):
    model, jmodel = _joint_model("rbf", touch, linv, c=48)
    path = str(tmp_path / "joint.npz")
    jckpt.save_model(path, jmodel)
    loaded = convert.load_jax_checkpoint(path, device="cpu")
    assert isinstance(loaded, gpd.DerivGPModel)
    assert loaded.touch_capacity == touch and (loaded.linv is not None) == linv
    q = np.random.default_rng(12).normal(size=(40, 3))
    got = grid.evaluate_points_chunked(loaded, _t(q))
    want = jgpd.predict(jmodel, _j(q))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-10)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-10)
    np.testing.assert_allclose(gpd.predict_gradient(loaded, _t(q)).numpy(),
                               np.asarray(jgpd.predict_gradient(jmodel, _j(q))), atol=1e-10)


def test_joint_twins_launch_nothing_on_cpu():
    _build.LAUNCHES.clear()
    model, _ = _joint_model("rbf", 128, linv=True)
    q = _t(np.random.default_rng(0).normal(size=(30, 3)))
    for staged in (True, False):
        cuda_joint.fused_joint_query("rbf", q, model.x, model.params, model.alpha, model.linv,
                                     model.touch_x, staged=staged)
    gpd.predict_gradient(model, q)
    updated = gpd.update_joint(model, q[:1], 0.0, 1e-5)
    assert updated.n_touch == model.n_touch + 1
    assert sum(_build.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# Kernel E's arithmetic (csrc/joint.cu), written out in float64 torch: each
# row classified by its metadata, k, 2 dk and -4 d2k from one transcendental,
# and the blend collapsed by the row's kind.  Held to the plain twin and to
# the JAX kernel, so the collapse is the blend wherever callers lay rows out.

def _row_kinds(meta):
    """0 value (dirs 0, flag 1), 1-3 gradient along axis 0-2 (dirs e_a
    exactly, flag 0), 4 general: the CUDA body's `joint_kind`."""
    _, u, f = meta
    kinds = torch.full(f.shape, 4, dtype=torch.long)
    kinds[(u == 0).all(dim=1) & (f == 1)] = 0
    for a in range(3):
        e = torch.zeros(3, dtype=u.dtype)
        e[a] = 1.0
        kinds[(u == e).all(dim=1) & (f == 0)] = a + 1
    return kinds


def _one_transcendental(name, r2, params):
    """(k, g = 2 dk/dr2, h = -4 d2k/dr2^2): the CUDA body's `joint_derivs`."""
    ls, sv = params["lengthscale"], params["signal_variance"]
    if name == "rbf":
        b = 1.0 / (ls * ls)
        k = sv * torch.exp(-0.5 * b * r2)
        return k, -b * k, -b * b * k
    if name == "inverse_multiquadric":
        rs = torch.rsqrt(r2 + ls * ls)
        k = sv * rs
        return k, -k * rs * rs, -3.0 * k * rs**4
    r = torch.sqrt(r2)  # thin plate: h is infinite at r = 0, behind the mask
    return sv * (r2 * (2.0 * r - 3.0 * ls) + ls**3), 6.0 * sv * (r - ls), -6.0 * sv / r


def _collapsed_rows(name, rmeta, cmeta, params, noise_col=None, row0=0):
    (rc, ru, rf), (cc, cu, cf) = rmeta, cmeta
    diff = rc[:, None, :] - cc[None, :, :]
    r2 = (diff * diff).sum(-1)
    zero = r2 <= 1e-24
    k, g, h = _one_transcendental(name, r2, params)
    k = torch.where(zero, torch.as_tensor(float(kf.k_diag0(name, params)), dtype=r2.dtype), k)
    h = torch.where(zero, torch.zeros_like(h), h)
    vd = torch.einsum("sd,rsd->rs", cu, diff)
    fc = cf[None, :]
    kinds = _row_kinds(rmeta)[:, None]
    out = fc * k - g * vd  # value rows
    for a in range(3):  # gradient rows along axis a
        da = diff[..., a]
        out = torch.where(kinds == a + 1, g * (fc * da - cu[None, :, a]) + h * da * vd, out)
    ud = torch.einsum("rd,rsd->rs", ru, diff)
    blend = rf[:, None] * fc * k + g * (ud * fc - vd * rf[:, None] - ru @ cu.T) + h * ud * vd
    out = torch.where(kinds == 4, blend, out)
    if noise_col is not None:
        rows = row0 + torch.arange(out.shape[0])[:, None]
        out = torch.where(rows == torch.arange(out.shape[1])[None, :], out + noise_col, out)
    return out


@pytest.mark.parametrize("case", ["coincident", "ragged", "value_rows", "band", "general"])
@pytest.mark.parametrize("name", DERIV_KERNELS)
def test_collapsed_joint_rows_match_twin_and_jax(name, case):
    # ragged: C = 300, T = 63 (J = 1,263: kinds change mid-tile, J % 4 = 3);
    # band: 300 rows at row0 700 of that layout with noise; general: random
    # dirs and flags, which take the full blend.
    rng = np.random.default_rng(31)
    p, jp = _params(name)
    c, t = (60, 16) if case in ("coincident", "general") else (300, 63)
    x = rng.normal(size=(c, 3))
    x[c // 2:c // 2 + 10] = x[:10]  # distinct indices, coincident points
    meta = cuda_joint.joint_meta(_t(x), _t(rng.normal(size=(t, 3))))
    j = meta[0].shape[0]
    noise = _t(rng.uniform(1e-3, 1e-2, size=j))
    row0, noise_col = 0, noise
    if case == "general":
        meta = (meta[0], _t(rng.normal(size=(j, 3))), _t(rng.uniform(size=j)))
        meta[1][::7] = 0.0  # some value-like and gradient-like rows among them
        meta[2][::7] = 1.0
        meta[1][3::7] = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64)
        meta[2][3::7] = 0.0
        assert set(_row_kinds(meta).tolist()) == {0, 2, 4}
    rows = meta
    if case == "value_rows":
        rows = cuda_joint.value_meta(_t(np.concatenate([x[:8], rng.normal(size=(90, 3))])))
        noise_col = None
    elif case == "band":
        row0 = 700
        rows = tuple(m[row0:row0 + 300] for m in meta)
    elif case == "ragged":
        assert j == 1263 and j % 4 == 3
    got = _collapsed_rows(name, rows, meta, p, noise_col, row0)
    want = cuda_joint.joint_rows_reference(name, rows, meta, p, noise_col=noise_col, row0=row0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
    if case != "ragged":  # JAX's kernel in interpret mode: the band stands for the layout
        (jr, jc) = (tuple(_j(m.numpy()) for m in rows), tuple(_j(m.numpy()) for m in meta))
        kw = {} if noise_col is None else {"noise_col": _j(noise_col.numpy()), "row0": row0}
        jwant = jpj.joint_rows_pallas(name, jr, jc, jp, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-12, atol=1e-12)
