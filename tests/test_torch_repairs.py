"""Entry points of the port that the JAX package has, held to it on the CPU
in float64: the session's public names, the grid functions' `chunk=` and
`want_var=`, `fit` / `fit_inference`'s `dtype=` and `max_jitter_retries=`,
and `fit_sharded`'s `dtype=` and `jitter=` (one gloo rank against a mesh of
one virtual device).  The bar is BASELINE.md row 2: 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpis_tpu.api.session import ObjectModelSession as JaxSession
from gpis_tpu.gp import regression as jgpr
from gpis_tpu.gp import sharded_model as jgsm
from gpis_tpu.kernels import functions as jkf
from gpis_tpu.linalg import outofcore as jooc
from gpis_tpu.parallel import mesh as jpm
from gpis_tpu.surface import grid as jgrid
from gpis_tpu_torch.api.session import ObjectModelSession
from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.gp import sharded_model as gsm
from gpis_tpu_torch.gp.model import align_capacity, round_up
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.linalg import outofcore as ooc
from gpis_tpu_torch.surface import grid

LS = 0.7


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _problem(n=300, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x, rng.normal(size=n) * 0.3, rng.uniform(1e-3, 1e-2, size=n)


def _separated(n=40, seed=6):
    """Points far apart against the lengthscale, away from the origin (where
    padding rows sit): K = I to the last bit, so the factor's first pivot is
    1 + noise + jitter exactly and the ladder's rung is known."""
    rng = np.random.default_rng(seed)
    return rng.uniform(20.0, 400.0, size=(n, 3)), rng.normal(size=n) * 0.3


def test_session_has_every_public_name_of_the_jax_session():
    names = [n for n in dir(JaxSession) if not n.startswith("_")]
    missing = [n for n in names if not hasattr(ObjectModelSession, n)]
    assert not missing, missing


@pytest.mark.parametrize("verb, item", [("surface_points", 7), ("is_done", 8),
                                        ("export_exploration", 16), ("restore", 9)])
def test_session_verbs_added_as_stubs_name_their_item(verb, item):
    sess = ObjectModelSession(device="cpu")
    args = ("x.html",) if verb in ("export_exploration", "restore") else ()
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md §1 item {item}:"):
        getattr(sess, verb)(*args)


def test_session_constructor_takes_the_jax_positional_order():
    # The JAX caller's ObjectModelSession(cfg, None, mesh): explore second,
    # mesh third; a one-device mesh fits on the one device, as in JAX.
    from gpis_tpu.config import MeshConfig as JaxMeshConfig

    from gpis_tpu_torch.config import MeshConfig, ModelConfig

    cfg = ModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3, n_external=64,
                      touch_capacity=0, dtype="float64")
    pts = np.random.default_rng(12).normal(size=(300, 3))
    pts = pts / np.linalg.norm(pts, axis=1, keepdims=True) * 1.3 + 0.2
    sess = ObjectModelSession(cfg, None, MeshConfig(n_devices=1), device="cpu").start(pts)
    jsess = JaxSession(cfg, None, JaxMeshConfig(n_devices=1)).start(pts)
    assert sess.mesh is None and sess.mesh_config.n_devices == 1
    q = np.random.default_rng(13).uniform(-2.0, 2.0, size=(64, 3))
    np.testing.assert_allclose(sess.query(q), jsess.query(q), atol=1e-6)


def test_session_explore_config_names_its_item():
    from gpis_tpu_torch.config import ExploreConfig

    for make in (lambda: ObjectModelSession(None, ExploreConfig(), device="cpu"),
                 lambda: ObjectModelSession(explore=ExploreConfig(), device="cpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 8:"):
            make()


@pytest.fixture(scope="module")
def models():
    x, y, noise = _problem()
    p, jp = kf.kernel_params(LS, 1.0), jkf.kernel_params(LS, 1.0)
    jx, jy, jn = (jnp.asarray(a) for a in (x, y, noise))
    return {
        "incore": (gpr.fit_inference("rbf", _t(x), _t(y), _t(noise), p),
                   jgpr.fit_inference("rbf", jx, jy, jn, jp)),
        "ooc": (ooc.ooc_fit("rbf", _t(x), _t(y), _t(noise), p, panel=128, block=64),
                jooc.ooc_fit("rbf", jx, jy, jn, jp, panel=128, block=64)),
    }


@pytest.mark.parametrize("kind", ["incore", "ooc"])
@pytest.mark.parametrize("want_var", [True, False])
def test_evaluate_grid_chunk_and_want_var_match_jax(models, kind, want_var):
    model, jm = models[kind]
    mean, var, axis = grid.evaluate_grid(model, 11, 1.4, chunk=500, want_var=want_var)
    jmean, jvar, jaxis = jgrid.evaluate_grid(jm, 11, 1.4, chunk=500, want_var=want_var)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-6)
    np.testing.assert_allclose(axis.numpy(), np.asarray(jaxis), atol=1e-14)
    if want_var:
        np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=1e-6)
    else:
        assert var is None and jvar is None


@pytest.mark.parametrize("kind", ["incore", "ooc"])
@pytest.mark.parametrize("want_var", [True, False])
def test_evaluate_points_chunked_chunk_and_want_var_match_jax(models, kind, want_var):
    model, jm = models[kind]
    q = np.random.default_rng(8).uniform(-1.4, 1.4, size=(777, 3))
    mean, var = grid.evaluate_points_chunked(model, _t(q), chunk=256, want_var=want_var)
    jmean, jvar = jgrid.evaluate_points_chunked(jm, jnp.asarray(q), chunk=256,
                                                want_var=want_var)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-6)
    if want_var:
        np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=1e-6)
    else:
        assert var is None and jvar is None


@pytest.mark.parametrize("fn", ["fit", "fit_inference"])
def test_fit_dtype_casts_float32_inputs_as_jax_does(fn):
    x, y, noise = (a.astype(np.float32) for a in _problem(200, seed=9))
    q = np.random.default_rng(10).uniform(-1.3, 1.3, size=(64, 3))
    p, jp = kf.kernel_params(LS, 1.0), jkf.kernel_params(LS, 1.0)
    kw = {"touch_capacity": 64} if fn == "fit" else {}
    model = getattr(gpr, fn)("rbf", _t(x), _t(y), _t(noise), p, dtype=torch.float64, **kw)
    jm = getattr(jgpr, fn)("rbf", jnp.asarray(x), jnp.asarray(y), jnp.asarray(noise), jp,
                           dtype=jnp.float64, **kw)
    assert model.x.dtype == torch.float64 and jm.x.dtype == jnp.float64
    mean, var = gpr.predict(model, _t(q))
    jmean, jvar = jgpr.predict(jm, jnp.asarray(q))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=1e-6)


@pytest.mark.parametrize("fn", ["fit", "fit_inference"])
@pytest.mark.parametrize("retries", [2, 3])
def test_fit_max_jitter_retries_stops_where_jax_does(fn, retries):
    # In float32 the ladder's rungs are 0, j, 10 j, 100 j for j = 4 eps C k(0)
    # at the fit's capacity C: the pivot 1 + noise = -50 j needs the third
    # retry.  K = I, so both sides divide y by the same float32 pivot: alpha
    # agrees to a few float32 ulps.
    x, y = (a.astype(np.float32) for a in _separated())
    touch = 256 if fn == "fit" else 0
    cap = align_capacity(round_up(len(x), 128) + touch)
    j = 4.0 * float(np.finfo(np.float32).eps) * cap
    noise = np.full(len(x), -1.0 - 50.0 * j, np.float32)
    p, jp = kf.kernel_params(LS, 1.0), jkf.kernel_params(LS, 1.0)
    call = lambda: getattr(gpr, fn)("rbf", _t(x), _t(y), _t(noise), p,  # noqa: E731
                                    max_jitter_retries=retries)
    jcall = lambda: getattr(jgpr, fn)("rbf", jnp.asarray(x), jnp.asarray(y),  # noqa: E731
                                      jnp.asarray(noise), jp, max_jitter_retries=retries)
    if retries == 2:
        with pytest.raises(FloatingPointError):
            call()
        with pytest.raises(FloatingPointError):
            jcall()
        return
    model, jm = call(), jcall()
    np.testing.assert_array_equal(model.noise.numpy(), np.asarray(jm.noise))
    np.testing.assert_allclose(model.alpha.numpy(), np.asarray(jm.alpha), rtol=1e-5)


def test_fit_sharded_dtype_and_jitter_match_jax(tmp_path):
    import torch.distributed as dist

    from gpis_tpu_torch.parallel.mesh import make_row_mesh

    # noise -2.5 on K = I: the ladder's rungs 0 and 1 x jitter fail, 100 x
    # jitter (pivot 98.5) holds; float32 inputs fitted in float64.
    x, y = (a.astype(np.float32) for a in _separated())
    noise = np.float32(-2.5)
    q = np.random.default_rng(11).uniform(0.0, 400.0, size=(50, 3))
    q[:10] = x[:10]
    jm = jgsm.fit_sharded("rbf", jnp.asarray(x), jnp.asarray(y), noise, jkf.kernel_params(LS, 1.0),
                          mesh=jpm.make_row_mesh(1), block=64, dtype=jnp.float64, jitter=1.0)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        model = gsm.fit_sharded("rbf", _t(x), _t(y), float(noise), kf.kernel_params(LS, 1.0),
                                mesh=make_row_mesh(1, device="cpu"), block=64,
                                dtype=torch.float64, jitter=1.0)
        mean, var = model.predict(_t(q))
    finally:
        dist.destroy_process_group()
    assert model.x.dtype == torch.float64
    np.testing.assert_allclose(model.noise.numpy(), np.asarray(jm.noise), rtol=1e-12)
    np.testing.assert_allclose(model.noise.numpy()[:len(x)], 97.5, rtol=1e-12)
    jmean, jvar = jm.predict(jnp.asarray(q))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=1e-6)
