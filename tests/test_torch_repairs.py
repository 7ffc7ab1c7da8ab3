"""Entry points of the port that the JAX package has, held to it on the CPU
in float64: the session's public names, the grid functions' `chunk=` and
`want_var=`, `fit` / `fit_inference`'s `dtype=` and `max_jitter_retries=`,
and `fit_sharded`'s `dtype=` and `jitter=` (one gloo rank against a mesh of
one virtual device); `fit_with_normals`' `dtype=` and
`max_jitter_retries=`, `predict`'s and `ShardedGPModel.predict`'s
`precision=`, `build_training_set`'s positional `normals`, the session's
`expert_gate=` / `expert_beta=` and `fit` / `fit_padded`'s `chol_impl=`.
A guard compares every public signature of the two packages.  The bar is
BASELINE.md row 2: 1e-6."""

import importlib
import inspect
import pkgutil
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

import gpis_tpu
import gpis_tpu_torch
from gpis_tpu.api.session import ObjectModelSession as JaxSession
from gpis_tpu.config import ModelConfig as JaxModelConfig
from gpis_tpu.data import gpis as jgpis
from gpis_tpu.data import synthetic
from gpis_tpu.gp import derivative as jgpd
from gpis_tpu.gp import regression as jgpr
from gpis_tpu.gp import sharded_model as jgsm
from gpis_tpu.kernels import functions as jkf
from gpis_tpu.linalg import outofcore as jooc
from gpis_tpu.parallel import mesh as jpm
from gpis_tpu.surface import grid as jgrid
from gpis_tpu_torch.api.session import ObjectModelSession
from gpis_tpu_torch.config import ModelConfig
from gpis_tpu_torch.data import gpis
from gpis_tpu_torch.gp import derivative as gpd
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


@pytest.mark.parametrize("verb, item", [("is_done", 8), ("export_exploration", 16),
                                        ("restore", 9)])
def test_session_verbs_added_as_stubs_name_their_item(verb, item):
    sess = ObjectModelSession(device="cpu")
    args = ("x.html",) if verb in ("export_exploration", "restore") else ()
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md §1 item {item}:"):
        getattr(sess, verb)(*args)


@pytest.mark.parametrize("verb", ["surface_points", "update"])
def test_session_verbs_before_start_raise_as_jax(verb):
    args = () if verb == "surface_points" else (np.zeros((1, 3)),)
    with pytest.raises(RuntimeError) as e:
        getattr(JaxSession(), verb)(*args)
    with pytest.raises(RuntimeError, match=f"^{re.escape(str(e.value))}$"):
        getattr(ObjectModelSession(device="cpu"), verb)(*args)


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


# JAX parameters the port leaves out on purpose, each with its reason:
# (module, function or Class.method) -> {parameter names}.
_ALLOWED_GAPS = {
    # ROADMAP §3: torch.distributed has no mesh axis, and the sharded
    # functions take this rank's band under a name that says so.
    ("linalg.sharded", "sharded_gram"): {"axis"},
    ("linalg.sharded", "sharded_cholesky"): {"a", "axis", "precision", "use_pallas"},
    ("linalg.sharded", "sharded_solve_lower_vec"): {"l", "axis"},
    ("linalg.sharded", "sharded_solve_lower_t_vec"): {"l", "axis"},
    ("linalg.sharded", "sharded_cho_solve_vec"): {"l", "axis"},
    ("linalg.sharded", "sharded_linv"): {"l", "axis", "precision", "use_pallas"},
    ("linalg.sharded", "sharded_alpha_from_linv"): {"w", "axis"},
    # cross_fn: joint models on a mesh, ROADMAP §1 item 14.
    ("linalg.sharded", "sharded_predict_linv"): {"w", "axis", "cross_fn"},
    ("linalg.sharded", "sharded_linv_ll"): {"l", "axis", "precision"},
    ("linalg.sharded", "sharded_update_tail"): {"l", "w", "axis"},
    ("parallel.mesh", "make_row_mesh"): {"axis_name"},
    # ROADMAP §1 item 15: the out-of-core knobs kept as module constants or
    # refused until their features are ported (spill codecs, disk spill,
    # process-split phases).
    ("linalg.outofcore", "TieredPanelStore"): {"spill_dtype", "device_dtype", "spill_dir",
                                               "write_through", "tag", "spill_codec"},
    ("linalg.outofcore", "TieredPanelStore.__init__"): {"spill_dtype", "device_dtype",
                                                        "spill_dir", "write_through", "tag",
                                                        "spill_codec"},
    ("linalg.outofcore", "ooc_trsm"): {"width_quant", "start_panel", "end_panel",
                                       "progress_cb"},
    ("linalg.outofcore", "ooc_cholesky"): {"x", "noisep", "width_quant", "start_panel", "u0",
                                           "progress_cb", "end_panel"},
    ("linalg.outofcore", "ooc_residual_check"): {"n_blocks", "block", "tol", "tol_y"},
    ("linalg.outofcore", "plan_sweeps"): {"c", "panel", "itemsize", "limit", "w_itemsize",
                                          "l_itemsize", "width_quant", "max_sweep"},
    ("linalg.outofcore", "ooc_fit"): {"dtype", "max_jitter_retries", "initial_jitter",
                                      "width_quant", "sweep", "trsm_sweep"},
    ("linalg.outofcore", "ooc_factor_phase"): {
        "kernel", "x", "y", "noise", "params", "panel", "spill_dir", "block", "sweep",
        "width_quant", "pad_noise", "dtype", "max_jitter_retries", "initial_jitter",
        "device_budget", "resume", "normals", "noise_g", "l_codec", "defer_alpha"},
    ("linalg.outofcore", "ooc_solve_phase"): {"spill_dir", "w_dtype", "trsm_sweep",
                                              "device_budget", "resume", "stop_after",
                                              "fused_query", "keep_w"},
    # ROADMAP §1 item 16: the native marching library.
    ("surface.marching", "marching_tetrahedra"): {"native"},
}
_ALLOWED_GAPS[("linalg.outofcore", "ooc_fit_joint")] = _ALLOWED_GAPS[("linalg.outofcore",
                                                                      "ooc_fit")]
# The stream objectives factor through ooc_fit's path: the same knobs.
for _fn in ("ooc_mll_and_grad", "ooc_joint_mll_and_grad"):
    _ALLOWED_GAPS[("gp.ooc_hyperopt", _fn)] = {"dtype", "max_jitter_retries", "width_quant",
                                               "sweep", "trsm_sweep"}


def _modules(pkg) -> dict:
    out = {}
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        try:
            out[info.name.split(".", 1)[1]] = importlib.import_module(info.name)
        except ImportError:  # the JAX package's native library is not a module
            continue
    return out


def _parameters(fn):
    try:
        return inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return None


def _public_pairs(jmod, tmod):
    """(name, JAX callable, port callable) of every public function, class
    and method defined in the JAX module that the port's module has too."""
    for attr, jobj in vars(jmod).items():
        if attr.startswith("_") or getattr(jobj, "__module__", None) != jmod.__name__:
            continue
        tobj = getattr(tmod, attr, None)
        if tobj is None or not callable(jobj) or not callable(tobj):
            continue
        yield attr, jobj, tobj
        if inspect.isclass(jobj) and inspect.isclass(tobj):
            for meth, jm in vars(jobj).items():
                if (meth == "__init__" or not meth.startswith("_")) and callable(jm) \
                        and callable(getattr(tobj, meth, None)):
                    yield f"{attr}.{meth}", jm, getattr(tobj, meth)


def test_every_jax_parameter_is_in_the_port_or_allowed():
    jmods, tmods = _modules(gpis_tpu), _modules(gpis_tpu_torch)
    missing, compared = {}, 0
    for mod in sorted(set(jmods) & set(tmods)):
        for name, jfn, tfn in _public_pairs(jmods[mod], tmods[mod]):
            jp, tp = _parameters(jfn), _parameters(tfn)
            if jp is None or tp is None:
                continue
            compared += 1
            gap = {p for p in jp if p not in tp} - _ALLOWED_GAPS.get((mod, name), set())
            if gap:
                missing[f"{mod}.{name}"] = sorted(gap)
    assert compared > 100, compared
    assert not missing, missing


@pytest.mark.parametrize("mod, name", [
    ("kernels.functions", "register_kernel"), ("kernels.functions", "unregister_kernel"),
    ("kernels.gram", "gram_ad"), ("linalg.cholesky", "blocked_cholesky"),
    ("linalg.cholesky", "blocked_linv"), ("gp.regression", "with_inverse"),
    ("gp.regression", "log_marginal_likelihood"), ("gp.hyperopt", "optimize"),
    ("gp.hyperopt", "optimize_joint"), ("gp.ooc_hyperopt", "ooc_mll_and_grad"),
    ("gp.ooc_hyperopt", "optimize_ooc"), ("gp.ooc_hyperopt", "ooc_joint_mll_and_grad"),
    ("gp.ooc_hyperopt", "optimize_ooc_joint"), ("gp.sharded_hyperopt", "sharded_mll_and_grad"),
    ("gp.sharded_hyperopt", "optimize_sharded"), ("linalg.outofcore", "ooc_trsm"),
    ("linalg.outofcore", "ooc_cholesky"), ("linalg.outofcore", "OOCModel.__init__"),
])
def test_the_guard_compares_the_config3_signatures(mod, name):
    """Config 3's functions (and the item 2, 4 and 5 residues beside them)
    are among the pairs the signature guard compares."""
    jmod = importlib.import_module(f"gpis_tpu.{mod}")
    tmod = importlib.import_module(f"gpis_tpu_torch.{mod}")
    pairs = {n: (j, t) for n, j, t in _public_pairs(jmod, tmod)}
    assert name in pairs
    assert _parameters(pairs[name][0]) is not None and _parameters(pairs[name][1]) is not None


def test_allowed_gaps_are_still_gaps():
    # An allow-list entry whose parameter the port has gained is stale.
    jmods, tmods = _modules(gpis_tpu), _modules(gpis_tpu_torch)
    stale = []
    for (mod, name), allowed in _ALLOWED_GAPS.items():
        pairs = {n: (j, t) for n, j, t in _public_pairs(jmods[mod], tmods[mod])}
        jfn, tfn = pairs[name]
        jp, tp = _parameters(jfn), _parameters(tfn)
        stale += [f"{mod}.{name}:{p}" for p in allowed if p not in jp or p in tp]
    assert not stale, stale


def _joint_problem(n=40, seed=9):
    pts, nrm = synthetic.ellipsoid_cloud(n, seed=seed)
    return pts, np.zeros(n), nrm


def test_fit_with_normals_dtype_casts_float32_inputs_as_jax_does():
    pts, y, nrm = (a.astype(np.float32) for a in _joint_problem())
    p, jp = kf.kernel_params(0.5, 1.0), jkf.kernel_params(0.5, 1.0)
    model = gpd.fit_with_normals("rbf", _t(pts), _t(y), _t(nrm), 1e-4, 1e-3, p, block=8,
                                 dtype=torch.float64)
    jm = jgpd.fit_with_normals("rbf", jnp.asarray(pts), jnp.asarray(y), jnp.asarray(nrm), 1e-4,
                               1e-3, jp, block=8, dtype=jnp.float64)
    assert model.x.dtype == torch.float64 and jm.x.dtype == jnp.float64
    q = np.random.default_rng(10).normal(size=(25, 3))
    mean, var = gpd.predict(model, _t(q))
    jmean, jvar = jgpd.predict(jm, jnp.asarray(q))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=1e-6)


@pytest.mark.parametrize("retries", [1, 2])
def test_fit_with_normals_max_jitter_retries_stops_where_jax_does(retries):
    # Points far apart against the lengthscale: the joint Gram is diagonal,
    # k(0) on value rows and -2 dk(0) = 1 / ls^2 on gradient rows.  A value
    # noise of -k(0) - 5 j (j = 4 eps J k(0)) needs the ladder's third rung,
    # 10 j (rungs 0, j, 10 j): two retries.
    x, _ = _separated(16)
    y = np.random.default_rng(3).normal(size=len(x))
    nrm = np.zeros_like(x)
    p, jp = kf.kernel_params(LS, 1.0), jkf.kernel_params(LS, 1.0)
    jsize = 4 * round_up(len(x), 8)
    j = 4.0 * float(np.finfo(np.float64).eps) * jsize
    noise_f = -1.0 - 5.0 * j
    call = lambda: gpd.fit_with_normals("rbf", _t(x), _t(y), _t(nrm), noise_f, 1e-3, p,  # noqa
                                        block=8, max_jitter_retries=retries)
    jcall = lambda: jgpd.fit_with_normals("rbf", jnp.asarray(x), jnp.asarray(y),  # noqa: E731
                                          jnp.asarray(nrm), noise_f, 1e-3, jp, block=8,
                                          max_jitter_retries=retries)
    if retries == 1:
        with pytest.raises(FloatingPointError):
            call()
        with pytest.raises(FloatingPointError):
            jcall()
        return
    model, jm = call(), jcall()
    np.testing.assert_allclose(model.alpha.numpy(), np.asarray(jm.alpha), rtol=1e-6)
    q = np.random.default_rng(4).uniform(20.0, 400.0, size=(20, 3))
    np.testing.assert_allclose(gpd.predict(model, _t(q))[0].numpy(),
                               np.asarray(jgpd.predict(jm, jnp.asarray(q))[0]), atol=1e-6)


@pytest.mark.parametrize("kind", ["linv", "chol", "joint"])
def test_predict_precision_matches_jax(kind):
    # A joint model ignores precision in both packages: it keeps its route.
    x, y, noise = _problem(200, seed=14)
    q = np.random.default_rng(15).uniform(-1.3, 1.3, size=(64, 3))
    p, jp = kf.kernel_params(LS, 1.0), jkf.kernel_params(LS, 1.0)
    if kind == "joint":
        pts, yj, nrm = _joint_problem()
        model = gpd.with_linv_joint(gpd.fit_with_normals("rbf", _t(pts), _t(yj), _t(nrm), 1e-4,
                                                         1e-3, p, block=8))
        jm = jgpd.with_linv_joint(jgpd.fit_with_normals(
            "rbf", jnp.asarray(pts), jnp.asarray(yj), jnp.asarray(nrm), 1e-4, 1e-3, jp, block=8))
    else:
        model = gpr.fit("rbf", _t(x), _t(y), _t(noise), p, touch_capacity=0)
        jm = jgpr.fit("rbf", jnp.asarray(x), jnp.asarray(y), jnp.asarray(noise), jp,
                      touch_capacity=0)
        if kind == "linv":
            model, jm = gpr.with_linv(model), jgpr.with_linv(jm)
    mean, var = gpr.predict(model, _t(q), precision="highest")
    jmean, jvar = jgpr.predict(jm, jnp.asarray(q), precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=1e-6)
    fast = gpr.predict(model, _t(q))
    np.testing.assert_allclose(mean.numpy(), fast[0].numpy(), atol=1e-12)
    np.testing.assert_allclose(var.numpy(), fast[1].numpy(), atol=1e-12)


def test_sharded_predict_precision_matches_jax(tmp_path):
    import torch.distributed as dist

    from gpis_tpu_torch.parallel.mesh import make_row_mesh

    x, y, noise = _problem(200, seed=16)
    q = np.random.default_rng(17).uniform(-1.3, 1.3, size=(50, 3))
    jm = jgsm.fit_sharded("rbf", jnp.asarray(x), jnp.asarray(y), jnp.asarray(noise),
                          jkf.kernel_params(LS, 1.0), mesh=jpm.make_row_mesh(1), block=64)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        model = gsm.fit_sharded("rbf", _t(x), _t(y), _t(noise), kf.kernel_params(LS, 1.0),
                                mesh=make_row_mesh(1, device="cpu"), block=64)
        mean, var = model.predict(_t(q), precision="highest")
        fast = model.predict(_t(q))
    finally:
        dist.destroy_process_group()
    jmean, jvar = jm.predict(jnp.asarray(q), precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=1e-6)
    np.testing.assert_allclose(var.numpy(), fast[1].numpy(), atol=1e-12)


def test_build_training_set_takes_normals_third_as_jax_does():
    cfg = ModelConfig(n_external=32, n_internal=3, dtype="float64")
    jcfg = JaxModelConfig(n_external=32, n_internal=3, dtype="float64")
    pts, _, nrm = _joint_problem(60, seed=18)
    ts = gpis.build_training_set(pts, cfg, nrm, device="cpu")
    jts = jgpis.build_training_set(jnp.asarray(pts), jcfg, jnp.asarray(nrm))
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(jts.x), atol=1e-12)
    np.testing.assert_allclose(ts.y.numpy(), np.asarray(jts.y), atol=1e-12)
    np.testing.assert_allclose(ts.noise.numpy(), np.asarray(jts.noise), atol=1e-12)
    np.testing.assert_allclose(gpis.normalize_cloud(points=_t(pts))[0].numpy(),
                               np.asarray(jgpis.normalize_cloud(points=jnp.asarray(pts))[0]),
                               atol=1e-12)


def test_session_start_takes_expert_gate_and_beta():
    cfg = ModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3, n_external=64,
                      touch_capacity=0, dtype="float64")
    pts = np.random.default_rng(19).normal(size=(200, 3))
    pts = pts / np.linalg.norm(pts, axis=1, keepdims=True) * 1.2 - 0.1
    sess = ObjectModelSession(cfg, device="cpu").start(pts, experts=0, expert_gate=0,
                                                       expert_beta="rbcm")
    jsess = JaxSession(cfg).start(pts, experts=0, expert_gate=0, expert_beta="rbcm")
    q = np.random.default_rng(20).uniform(-1.5, 1.5, size=(64, 3))
    np.testing.assert_allclose(sess.query(q), jsess.query(q), atol=1e-6)
    for kw in ({"expert_gate": 2}, {"expert_beta": "bcm"}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 13:"):
            ObjectModelSession(cfg, device="cpu").start(pts, **kw)


@pytest.mark.parametrize("fn", ["fit", "fit_padded"])
def test_fit_chol_impl_matches_jax(fn):
    x, y, noise = _problem(150, seed=21)
    q = np.random.default_rng(22).uniform(-1.3, 1.3, size=(40, 3))
    p, jp = kf.kernel_params(LS, 1.0), jkf.kernel_params(LS, 1.0)
    calls = []

    def chol(a):
        calls.append(a.shape)
        return torch.linalg.cholesky(a)

    if fn == "fit":
        model = gpr.fit("rbf", _t(x), _t(y), _t(noise), p, touch_capacity=64, chol_impl=chol)
        jm = jgpr.fit("rbf", jnp.asarray(x), jnp.asarray(y), jnp.asarray(noise), jp,
                      touch_capacity=64, chol_impl=jnp.linalg.cholesky)
    else:
        cap = 256
        xp = np.zeros((cap, 3))
        xp[:150] = x
        yp = np.zeros(cap)
        yp[:150] = y
        npad = np.full(cap, 1e10)
        npad[:150] = noise
        model = gpr.fit_padded("rbf", _t(xp), _t(yp), _t(npad), p, n0=256, chol_impl=chol)
        jm = jgpr.fit_padded("rbf", jnp.asarray(xp), jnp.asarray(yp), jnp.asarray(npad), jp,
                             n0=256, chol_impl=jnp.linalg.cholesky)
    assert calls == [model.chol.shape]
    mean, var = gpr.predict(model, _t(q))
    jmean, jvar = jgpr.predict(jm, jnp.asarray(q))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=1e-6)
