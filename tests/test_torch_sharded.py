"""The port's row-sharded pipeline (config 5) against the JAX package's, on
the CPU in float64.

The port runs one process per rank on a gloo group: each P in (2, 4) is
spawned once (`tests/torch_sharded_rank.py`, which imports no jax) and its
results are held, one quantity a test, to the same JAX functions on a
`make_row_mesh(P)` of the suite's virtual CPU devices at 1e-6 (BASELINE.md
row 2).  The ranks' collectives time out after 60 s and the spawn kills
them after SPAWN_TIMEOUT, so a hung collective fails the tests of its P
instead of hanging the suite.  At P = 2 the ranks also run the distributed
MLL objective (held to the JAX package's dense autodiff gradient) and the
mesh session's two hyperopt methods (held to the JAX session's).  Kernel
L's twin is held to
`band_trail_update_pallas` in interpret mode, where `_dot3` is an exact dot.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

from gpis_tpu.api.session import ObjectModelSession as JaxSession
from gpis_tpu.config import MeshConfig as JaxMeshConfig
from gpis_tpu.config import ModelConfig as JaxModelConfig
from gpis_tpu.data import gpis as jgpis
from gpis_tpu.gp import sharded_model as jgsm
from gpis_tpu.kernels import functions as jkf
from gpis_tpu.kernels import gram as jkg
from gpis_tpu.linalg import sharded as jsh
from gpis_tpu.linalg.pallas_chol import band_trail_update_pallas
from gpis_tpu.parallel import mesh as jpm
from gpis_tpu_torch.linalg import cuda_chol

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, B = 1024, 64
LS, SV = 0.8, 1.2
TOUCH = 64
SESSION_LS, SESSION_BLOCK = 0.6, 64
SPAWN_TIMEOUT = 180  # seconds for all ranks of one P; a rank alone takes a few
MLL_N_REAL, MLL_SCALE = 1000, 1.3  # the distributed objective's padding and noise scale

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 (virtual) devices")


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(C, 3))
    noise = rng.uniform(1e-4, 1e-2, size=C)
    y = rng.normal(size=C) * 0.3
    params = jkf.kernel_params(LS, SV)
    k = np.asarray(jkg.gram("rbf", jnp.asarray(x), params, noise=jnp.asarray(noise)))
    l = np.linalg.cholesky(k)
    w = np.linalg.solve(l, np.eye(C))
    w = np.tril(w)
    alpha = w.T @ (w @ y)
    q = rng.normal(size=(512, 3))
    pts = np.asarray(jgpis.fibonacci_sphere(200, radius=0.5)) + np.array([1.0, 0.0, 0.0])
    return dict(x=x, y=y, noise=noise, l=l, w=w, alpha=alpha, q=q, q_odd=q[:301],
                ls=LS, sv=SV, block=B, touch_capacity=TOUCH, session_pts=pts,
                session_q=np.array([[1.0, 0.0, 0.0], [1.5, 0.0, 0.0], [1.2, 0.3, -0.1]]),
                session_ls=SESSION_LS, session_block=SESSION_BLOCK,
                touch_x=rng.normal(size=(8, 3)) * 0.8, touch_y=rng.normal(size=8) * 0.1,
                session_touch=pts[:3] * 1.03 - np.array([0.03, 0.0, 0.0]),
                mll_n_real=MLL_N_REAL, mll_scale=MLL_SCALE)


def _spawn(p: int, inputs: dict, out_dir) -> list[dict]:
    np.savez(out_dir / "inputs.npz", **inputs)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    script = os.path.join(REPO, "tests", "torch_sharded_rank.py")
    procs = []
    for r in range(p):
        log = open(out_dir / f"rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, script, str(out_dir), str(r), str(p)],
                                       cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT),
                      log))
    try:
        for proc, _ in procs:
            proc.wait(timeout=SPAWN_TIMEOUT)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    failed = [r for r, (proc, _) in enumerate(procs) if proc.returncode != 0]
    if failed:
        logs = "\n".join((out_dir / f"rank{r}.log").read_text()[-3000:] for r in failed)
        raise RuntimeError(f"ranks {failed} of {p} failed or were killed:\n{logs}")
    return [dict(np.load(out_dir / f"out{r}.npz")) for r in range(p)]


@pytest.fixture(scope="module")
def ranks(problem, jax_fits, jax_touched, tmp_path_factory):
    """ranks(P): the P ranks' results, spawned once per P.  The inputs carry
    the JAX fit_sharded model's arrays (jm_*) for `convert`."""
    done = {}

    def get(p):
        if p not in done:
            model = jax_fits(p)
            keys = ("x", "y", "noise", "l", "w", "alpha")
            jm = {f"jm_{k}": np.asarray(getattr(model, k)) for k in keys}
            touched = jax_touched(p, 1)
            jm.update({f"jmt_{k}": np.asarray(getattr(touched, k)) for k in keys})
            inputs = {**problem, **jm, "jm_n_real": model.n_real, "jmt_n_touch": touched.n_touch}
            done[p] = _spawn(p, inputs, tmp_path_factory.mktemp(f"sharded{p}"))
        return done[p]

    return get


@pytest.fixture(scope="module")
def jax_mesh():
    return {p: jpm.make_row_mesh(p) for p in (2, 4)}


def _bands(outs, key):
    return np.concatenate([o[key] for o in outs])


def _j(a):
    return jnp.asarray(np.asarray(a))


def _params():
    return jkf.kernel_params(LS, SV)


def _jax_l(problem, mesh):
    return jax.device_put(_j(problem["l"]), jpm.row_sharding(mesh))


P = pytest.mark.parametrize("p", [2, 4])


@P
def test_sharded_gram_matches_jax(p, problem, ranks, jax_mesh):
    want = jsh.sharded_gram("rbf", _j(problem["x"]), _params(), _j(problem["noise"]), jax_mesh[p])
    np.testing.assert_allclose(_bands(ranks(p), "gram"), np.asarray(want), atol=1e-12)


@P
@pytest.mark.parametrize("key", ["chol", "chol_kernels"])
def test_sharded_cholesky_matches_jax(p, key, problem, ranks, jax_mesh):
    mesh = jax_mesh[p]
    a = jsh.sharded_gram("rbf", _j(problem["x"]), _params(), _j(problem["noise"]), mesh)
    want = np.asarray(jsh.sharded_cholesky(a, mesh, block=B))
    got = _bands(ranks(p), key)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.all(np.triu(got, 1) == 0.0)


@P
@pytest.mark.parametrize("key, fn", [("solve_lower", jsh.sharded_solve_lower_vec),
                                     ("solve_lower_t", jsh.sharded_solve_lower_t_vec),
                                     ("cho_solve", jsh.sharded_cho_solve_vec)])
def test_sharded_solves_match_jax(p, key, fn, problem, ranks, jax_mesh):
    mesh = jax_mesh[p]
    want = np.asarray(fn(_jax_l(problem, mesh), _j(problem["y"]), mesh, block=B))
    for out in ranks(p):  # replicated: every rank holds the whole answer
        np.testing.assert_allclose(out[key], want, atol=1e-6)


@P
@pytest.mark.parametrize("key", ["linv", "linv_kernel"])
def test_sharded_linv_matches_jax(p, key, problem, ranks, jax_mesh):
    mesh = jax_mesh[p]
    want = np.asarray(jsh.sharded_linv(_jax_l(problem, mesh), mesh, block=B))
    np.testing.assert_allclose(_bands(ranks(p), key), want, atol=1e-6)


@P
def test_sharded_linv_ll_matches_jax(p, problem, ranks, jax_mesh):
    mesh = jax_mesh[p]
    want = np.asarray(jsh.sharded_linv_ll(_jax_l(problem, mesh), mesh, block=B))
    np.testing.assert_allclose(_bands(ranks(p), "linv_ll"), want, atol=1e-6)


@P
def test_sharded_alpha_from_linv_matches_jax(p, problem, ranks, jax_mesh):
    mesh = jax_mesh[p]
    w = jax.device_put(_j(problem["w"]), jpm.row_sharding(mesh))
    want = np.asarray(jsh.sharded_alpha_from_linv(w, _j(problem["y"]), mesh))
    for out in ranks(p):
        np.testing.assert_allclose(out["alpha"], want, atol=1e-6)


@P
@pytest.mark.parametrize("which", ["mean", "var"])
def test_sharded_predict_linv_matches_jax(p, which, problem, ranks, jax_mesh):
    mesh = jax_mesh[p]
    w = jax.device_put(_j(problem["w"]), jpm.row_sharding(mesh))
    mean, var = jsh.sharded_predict_linv("rbf", _j(problem["q"]), _j(problem["x"]), _params(),
                                         _j(problem["alpha"]), w, mesh)
    want = np.asarray(mean if which == "mean" else var)
    np.testing.assert_allclose(_bands(ranks(p), f"predict_{which}"), want, atol=1e-6)


@pytest.fixture(scope="module")
def jax_fits(problem, jax_mesh):
    done = {}

    def get(p):
        if p not in done:
            done[p] = jgsm.fit_sharded("rbf", _j(problem["x"]), _j(problem["y"]),
                                       _j(problem["noise"]), _params(), mesh=jax_mesh[p],
                                       block=B, touch_capacity=TOUCH)
        return done[p]

    return get


@P
@pytest.mark.parametrize("which", ["mean", "var"])
def test_fit_sharded_predict_matches_jax(p, which, problem, ranks, jax_fits):
    model = jax_fits(p)
    mean, var = model.predict(_j(problem["q_odd"]))
    want = np.asarray(mean if which == "mean" else var)
    for out in ranks(p):
        assert int(out["fit_capacity"]) == model.capacity
        np.testing.assert_allclose(out["fit_alpha"], np.asarray(model.alpha), atol=1e-6)
        np.testing.assert_allclose(out[f"fit_{which}"], want, atol=1e-6)


@P
@pytest.mark.parametrize("which", ["mean", "var"])
def test_converted_jax_model_predicts_as_jax(p, which, problem, ranks, jax_fits):
    """`convert.sharded_model_from_arrays` on the JAX model's arrays: the
    port's query on the JAX model's state."""
    mean, var = jax_fits(p).predict(_j(problem["q_odd"]))
    want = np.asarray(mean if which == "mean" else var)
    for out in ranks(p):
        np.testing.assert_allclose(out[f"converted_{which}"], want, atol=1e-9)


@pytest.fixture(scope="module")
def jax_touched(problem, jax_fits):
    """jax_touched(P, batches): the JAX model after the first touch batch
    (5 points) or both (then 3 more), as the ranks update theirs."""
    done = {}

    def get(p, batches):
        if (p, batches) not in done:
            tx, ty = _j(problem["touch_x"]), _j(problem["touch_y"])
            m = jax_fits(p).update(tx[:5], ty[:5], 1e-6)
            if batches == 2:
                m = m.update(tx[5:], 0.0, 1e-6)
            done[p, batches] = m
        return done[p, batches]

    return get


@P
@pytest.mark.parametrize("key", ["mean", "var", "alpha", "l", "w"])
def test_sharded_update_matches_jax(p, key, problem, ranks, jax_touched):
    """tests/test_sharded.py's sharded update: two batches bordered into the
    last band, held to ShardedGPModel.update on the virtual mesh."""
    model = jax_touched(p, 2)
    outs = ranks(p)
    for out in outs:
        assert int(out["update_n_touch"]) == model.n_touch == 8
    if key in ("mean", "var"):
        mean, var = model.predict(_j(problem["q_odd"]))
        want = np.asarray(mean if key == "mean" else var)
        for out in outs:
            np.testing.assert_allclose(out[f"update_{key}"], want, atol=1e-6)
    elif key == "alpha":
        for out in outs:
            np.testing.assert_allclose(out["update_alpha"], np.asarray(model.alpha), atol=1e-6)
    else:
        np.testing.assert_allclose(_bands(outs, f"update_{key}"),
                                   np.asarray(getattr(model, key)), atol=1e-6)


@P
@pytest.mark.parametrize("which", ["mean", "var"])
def test_converted_touched_jax_model_updates_as_jax(p, which, problem, ranks, jax_touched):
    """A JAX model after one batch, carried across by `convert` with its
    n_touch, then bordered once more on each side."""
    mean, var = jax_touched(p, 2).predict(_j(problem["q_odd"]))
    want = np.asarray(mean if which == "mean" else var)
    for out in ranks(p):
        np.testing.assert_allclose(out[f"converted_update_{which}"], want, atol=1e-6)


@P
def test_sharded_update_overflow_raises_as_jax(p, problem, ranks, jax_fits):
    model = jax_fits(p)
    band = model.capacity // p
    room = model.capacity - max(model.n_real, model.capacity - band)
    with pytest.raises(ValueError) as e:
        model.update(_j(problem["q"][:room + 1]), 0.0, 1e-6)
    for out in ranks(p):
        assert str(out["err_update"]) == f"ValueError: {e.value}"


@pytest.fixture(scope="module")
def jax_session(problem):
    cfg = JaxModelConfig(kernel="rbf", lengthscale=SESSION_LS, noise_surface=1e-4,
                         n_external=32, n_internal=1, dtype="float64")
    sess = JaxSession(cfg, mesh=JaxMeshConfig(n_devices=2, block=SESSION_BLOCK))
    return sess.start(problem["session_pts"])


@pytest.mark.parametrize("which", ["query", "grid"])
def test_mesh_session_matches_jax_session(which, problem, ranks, jax_session):
    outs = ranks(2)
    if which == "query":
        mean, var = jax_session.query(problem["session_q"])
        keys = ("session_mean", "session_var")
    else:
        mean, var, _ = jax_session.evaluate_grid(12, 1.5)
        keys = ("session_grid_mean", "session_grid_var")
    for out in outs:
        assert int(out["session_capacity"]) == jax_session.model.capacity
        np.testing.assert_allclose(out[keys[0]], np.asarray(mean), atol=1e-6)
        np.testing.assert_allclose(out[keys[1]], np.asarray(var), atol=1e-6)


def test_mesh_session_update_matches_jax_session(problem, ranks):
    cfg = JaxModelConfig(kernel="rbf", lengthscale=SESSION_LS, noise_surface=1e-4,
                         n_external=32, n_internal=1, dtype="float64")
    sess = JaxSession(cfg, mesh=JaxMeshConfig(n_devices=2, block=SESSION_BLOCK))
    sess.start(problem["session_pts"]).update(problem["session_touch"])
    mean, var = sess.query(problem["session_q"])
    for out in ranks(2):
        np.testing.assert_allclose(out["session_update_mean"], np.asarray(mean), atol=1e-6)
        np.testing.assert_allclose(out["session_update_var"], np.asarray(var), atol=1e-6)


def test_sharded_mll_and_grad_matches_dense_gradient(problem, ranks):
    """The distributed objective (P = 2, ring trace over gloo) against the
    JAX package's dense MLL and its autodiff gradient in (log lengthscale,
    log noise scale, log signal variance), at 1e-6."""
    from gpis_tpu.gp import regression as jgpr

    x, y, noise = (_j(problem[k]) for k in ("x", "y", "noise"))
    real = jnp.arange(C) < MLL_N_REAL

    def mll(theta):
        prm = {"lengthscale": jnp.exp(theta[0]), "signal_variance": jnp.exp(theta[2])}
        nz = jnp.where(real, noise * jnp.exp(theta[1]), noise)
        return jgpr.log_marginal_likelihood("rbf", x, y, nz, prm, n_real=MLL_N_REAL)

    theta = jnp.array([np.log(LS), np.log(MLL_SCALE), np.log(SV)])
    want, grad = jax.value_and_grad(mll)(theta)
    for out in ranks(2):
        np.testing.assert_allclose(float(out["mll"]), float(want), rtol=1e-6)
        np.testing.assert_allclose(out["mll_grad"], np.asarray(grad), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method", ["distributed", "subsample"])
def test_mesh_session_hyperopt_matches_jax_session(method, problem, ranks):
    cfg = JaxModelConfig(kernel="rbf", lengthscale=SESSION_LS, noise_surface=1e-4,
                         n_external=32, n_internal=1, dtype="float64")
    sess = JaxSession(cfg, mesh=JaxMeshConfig(n_devices=2, block=SESSION_BLOCK))
    kw = {"subsample": 64} if method == "subsample" else {}
    res = sess.start(problem["session_pts"]).optimize_hyperparameters(method=method, steps=2,
                                                                      **kw)
    mean, var = sess.query(problem["session_q"])
    for out in ranks(2):
        np.testing.assert_allclose(out[f"hyperopt_{method}_history"], res.history, rtol=1e-6)
        np.testing.assert_allclose(float(out[f"hyperopt_{method}_ls"]),
                                   float(res.params["lengthscale"]), rtol=1e-6)
        np.testing.assert_allclose(out[f"hyperopt_{method}_mean"], np.asarray(mean), atol=1e-6)
        np.testing.assert_allclose(out[f"hyperopt_{method}_var"], np.asarray(var), atol=1e-6)


def test_mesh_session_hyperopt_refuses_an_unknown_method_as_jax(ranks):
    for out in ranks(2):
        assert str(out["err_hyperopt"]) == (
            "ValueError: unknown hyperopt method 'stream' for a sharded model "
            "(use 'subsample' or 'distributed')")


@pytest.mark.parametrize("key, want", [
    ("err_world", "ValueError: requested 3 devices, the process group has 2 ranks"),
    ("err_out_of_core", "ValueError: out_of_core is the single-card"),
    ("err_normals", "NotImplementedError: normals= on a mesh"),
])
def test_sharded_refusals(key, want, ranks):
    for out in ranks(2):
        msg = str(out[key])
        assert msg.startswith(want), msg
        if key == "err_normals":
            assert "item 14" in msg, msg


@P
def test_ranks_import_no_jax(p, ranks):
    for out in ranks(p):
        assert str(out["imported"]) == ""


# ------------------------------------------------------------------ Kernel L


@pytest.mark.parametrize("row0, j0", [(0, 0), (0, 256), (512, 0)])
def test_band_trail_twin_matches_pallas(row0, j0):
    """Kernel L's twin against `band_trail_update_pallas` at the shapes of
    tests/test_linalg.py (its Pallas branch: R, C % 256 == 0)."""
    rng = np.random.default_rng(5)
    r, c, b = 512, 512, 256
    s = rng.normal(size=(r, c))
    l_col = rng.normal(size=(r, b))
    wj = rng.normal(size=(b, c))
    wj[:, j0 + b:] = 0.0  # a lower-triangular W row panel
    want = np.asarray(band_trail_update_pallas(_j(s), _j(l_col), _j(wj), j0, block=b, row0=row0))
    # A copy: the twin updates in place, and jax on the CPU may read s's memory.
    got = cuda_chol.band_trail(torch.tensor(s), torch.as_tensor(l_col), torch.as_tensor(wj),
                               j0, row0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10)


def test_band_trail_refuses_mismatched_shapes():
    s = torch.zeros((64, 128))
    with pytest.raises(ValueError, match="band_trail"):
        cuda_chol.band_trail(s, torch.zeros((64, 32)), torch.zeros((32, 64)), 0, 0)
