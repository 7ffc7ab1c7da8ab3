"""The port's sharded joint pipeline (config 2 at config 5's scale,
`gp/sharded_joint.py`, the joint objective of `gp/sharded_hyperopt.py`)
against the JAX package's, on the CPU in float64 at 1e-6.

The port runs one process per rank on a gloo group: each P in (2, 4) is
spawned once (`tests/torch_sharded_joint_rank.py`, which imports no jax)
and its results are held, one quantity a test, to the same JAX functions
on a `make_row_mesh(P)` of the suite's virtual CPU devices, after
tests/test_sharded.py:177-290 and 520-600: the band Gram against the dense
joint Gram too, the fit's predict, two tactile updates (against a
single-device refit with the touches as value rows as well), the joint
objective (against JAX's autodiff of the dense objective, as
tests/test_torch_sharded.py holds the value objective: JAX's sharded one
re-traces its collective at every call, ~13 s here); checkpoints both
ways; at P = 2 the Adam ascent, the mesh session with normals (its grid,
update, distributed hyperopt and restored query) and the CLI's
`fit --normals` on a mesh config.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

from gpis_tpu.api.session import ObjectModelSession as JaxSession
from gpis_tpu.cli.main import main as jax_main
from gpis_tpu.config import MeshConfig as JaxMeshConfig
from gpis_tpu.config import ModelConfig as JaxModelConfig
from gpis_tpu.gp import derivative as jgpd
from gpis_tpu.gp import regression as jgpr
from gpis_tpu.gp import sharded_hyperopt as jsho
from gpis_tpu.gp import sharded_joint as jgsj
from gpis_tpu.kernels import derivative as jkd
from gpis_tpu.kernels import functions as jkf
from gpis_tpu.kernels import gram as jkg
from gpis_tpu.linalg import cholesky as jlin
from gpis_tpu.parallel import mesh as jpm
from gpis_tpu.utils import checkpoint as jckpt
from torch_ranks import spawn_ranks

C, B, TOUCH = 60, 16, 8
LS, SV = 0.8, 1.0
SESSION_LS, SESSION_BLOCK = 0.9, 16
TOL = 1e-6

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 (virtual) devices")


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for the module: these sizes gain nothing from
    more, and the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _mll_problem(c=56, t=32, n_real=46, n_touch=2, seed=31):
    """tests/test_sharded.py's `_joint_problem`: padded core rows, touch
    slots with two occupied."""
    rng = np.random.default_rng(seed)
    xc = np.zeros((c, 3))
    xc[:n_real] = _unit(rng, n_real)
    y = np.zeros(c)
    y[:n_real] = rng.normal(size=n_real) * 0.1
    nf = np.full(c, 1e10)
    nf[:n_real] = 1e-3
    ng = np.full(c, 1e10)
    ng[:n_real] = 2e-3
    tx, tnf, ty = np.zeros((t, 3)), np.full(t, 1e10), np.zeros(t)
    tx[:n_touch] = _unit(rng, n_touch) * 1.02
    tnf[:n_touch], ty[:n_touch] = 5e-4, 0.05
    return dict(mll_x_all=np.concatenate([xc, tx]),
                mll_yj=np.concatenate([y, xc[:, 0], xc[:, 1], xc[:, 2], ty]),
                mll_nf_all=np.concatenate([nf, tnf]), mll_ng=ng, mll_c=c, mll_n_real=n_real,
                mll_n_touch=n_touch, mll_scale=1.4)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(13)
    x = _unit(rng, C)
    pts = _unit(rng, 60) * 0.5 + np.array([1.0, 0.0, 0.0])
    return dict(x=x, nrm=x.copy(), nf=rng.uniform(1e-4, 1e-3, C), ng=rng.uniform(1e-4, 1e-3, C),
                ls=LS, sv=SV, block=B, touch_capacity=TOUCH, q=rng.normal(size=(37, 3)),
                touch_x=np.concatenate([_unit(rng, 5) * 1.02, _unit(rng, 3) * 0.98]),
                session_pts=pts, session_nrm=(pts - np.array([1.0, 0.0, 0.0])) / 0.5,
                session_q=np.array([[1.0, 0.0, 0.0], [1.5, 0.0, 0.0], [1.2, 0.3, -0.1]]),
                session_touch=pts[:3] * 1.03 - np.array([0.03, 0.0, 0.0]),
                session_ls=SESSION_LS, session_block=SESSION_BLOCK, **_mll_problem())


def _j(a):
    return jnp.asarray(np.asarray(a))


def _params():
    return jkf.kernel_params(LS, SV)


@pytest.fixture(scope="module")
def jax_models(problem):
    """JAX's fit and its touched model on make_row_mesh(P), once per P."""
    done = {}

    def get(p):
        if p not in done:
            m = jgsj.fit_sharded_joint("rbf", _j(problem["x"]), jnp.zeros(C), _j(problem["nrm"]),
                                       _j(problem["nf"]), _j(problem["ng"]), _params(),
                                       mesh=jpm.make_row_mesh(p), block=B, touch_capacity=TOUCH)
            tx = _j(problem["touch_x"])
            touched = m.update(tx[:5], jnp.zeros(5), 1e-5).update(tx[5:], 0.0, 1e-5)
            done[p] = m, touched
        return done[p]

    return get


@pytest.fixture(scope="module")
def ranks(problem, jax_models, tmp_path_factory):
    """ranks(P): the P ranks' results and their directory, spawned once per
    P; the directory holds JAX's touched model saved (jax_joint.npz) and,
    at P = 2, the CLI's cloud and mesh config."""
    done = {}

    def get(p):
        if p not in done:
            d = tmp_path_factory.mktemp(f"sharded_joint{p}")
            jckpt.save_model(str(d / "jax_joint.npz"), jax_models(p)[1])
            pts = problem["session_pts"]
            np.savez(d / "cloudn.npz", points=pts, normals=problem["session_nrm"])
            (d / "mesh.json").write_text(json.dumps({"model": {"dtype": "float64"},
                                                     "mesh": {"n_devices": 2, "block": B}}))
            done[p] = spawn_ranks("torch_sharded_joint_rank.py", [], p, problem, d), d
        return done[p]

    return get


P = pytest.mark.parametrize("p", [2, 4])


def _bands(outs, key):
    return np.concatenate([o[key] for o in outs])


@P
def test_sharded_joint_gram_matches_jax_and_dense(p, problem, ranks):
    got = _bands(ranks(p)[0], "gram")
    want = jgsj.sharded_joint_gram("rbf", _j(problem["x"]), _params(), _j(problem["nf"]),
                                   _j(problem["ng"]), jpm.make_row_mesh(p))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-12)
    dense = jkd.joint_gram_reference("rbf", _j(problem["x"]), _params(),
                                     noise_f=_j(problem["nf"]), noise_g=_j(problem["ng"]))
    np.testing.assert_allclose(got, np.asarray(dense), atol=1e-10)


@P
@pytest.mark.parametrize("which", ["mean", "var"])
def test_fit_sharded_joint_predict_matches_jax(p, which, problem, ranks, jax_models):
    m = jax_models(p)[0]
    mean, var = m.predict(_j(problem["q"]))
    want = np.asarray(mean if which == "mean" else var)
    for out in ranks(p)[0]:
        assert (int(out["fit_n0"]), int(out["fit_touch_capacity"])) == (m.n0, m.touch_capacity)
        np.testing.assert_allclose(out["fit_alpha"], np.asarray(m.alpha), atol=TOL)
        np.testing.assert_allclose(out[f"fit_{which}"], want, atol=TOL)
    np.testing.assert_allclose(out["fit_predict_mean"],
                               np.asarray(jgpr.predict_mean(m, _j(problem["q"]))), atol=TOL)


@P
@pytest.mark.parametrize("which", ["mean", "var"])
def test_sharded_joint_update_matches_jax_and_refit(p, which, problem, ranks, jax_models):
    """Two touch batches bordered into the tail band, held to JAX's update
    and to a single-device joint refit with the touches as value-only rows
    (tests/test_sharded.py:209)."""
    m, touched = jax_models(p)
    q = _j(problem["q"])
    mean, var = touched.predict(q)
    floor = 4.0 * float(jnp.finfo(jnp.float64).eps) * (4 * m.n0 + m.touch_capacity)
    tx = _j(problem["touch_x"])
    ref = jgpd.fit_with_normals(
        "rbf", jnp.concatenate([_j(problem["x"]), tx]), jnp.zeros(C + 8),
        jnp.concatenate([_j(problem["nrm"]), jnp.zeros((8, 3))]),
        jnp.concatenate([_j(problem["nf"]), jnp.full((8,), max(1e-5, floor))]),
        jnp.concatenate([_j(problem["ng"]), jnp.full((8,), m.pad_noise)]), _params(),
        block=C + 8)
    rmean, rvar = jgpd.predict(ref, q)
    idx = 0 if which == "mean" else 1
    for out in ranks(p)[0]:
        assert int(out["update_n_touch"]) == 8
        got = out[f"update_{which}"]
        np.testing.assert_allclose(got, np.asarray((mean, var)[idx]), atol=TOL)
        np.testing.assert_allclose(got, np.asarray((rmean, rvar)[idx]), atol=TOL)
        assert str(out["err_overflow"]).startswith("ValueError: cumulative touches")
    want_l = np.asarray(touched.l)
    np.testing.assert_allclose(_bands(ranks(p)[0], "update_l"), want_l, atol=TOL)


def _dense_objective(x_all, yj, nf_all, ng, c: int, n_real: int, n_touch: int):
    """JAX's dense joint MLL (tests/test_sharded.py:547's oracle) as a jitted
    value-and-gradient in (log ls, log value-noise scale, log sv): the
    gradient by autodiff, no identity."""
    x_all, yj, nf_all, ng = (_j(a) for a in (x_all, yj, nf_all, ng))
    t = x_all.shape[0] - c
    j_tot = 4 * c + t
    core_real = jnp.arange(c) < n_real

    def mll(log_ls, log_s, log_sv):
        prm = {"lengthscale": jnp.exp(log_ls), "signal_variance": jnp.exp(log_sv)}
        nf_eff = jnp.where(core_real, nf_all[:c] * jnp.exp(log_s), nf_all[:c])
        k = jkd.joint_gram_reference("rbf", x_all[:c], prm, noise_f=nf_eff, noise_g=ng)
        if t:
            b = jkd.cross_cov_value("rbf", x_all[c:], x_all[:c], prm)
            d = jkg.gram_reference("rbf", x_all[c:], prm, noise=nf_all[c:])
            k = jnp.block([[k, b.T], [b, d]])
        l = jnp.linalg.cholesky(k)
        alpha = jlin.cho_solve(l, yj)
        val = (-0.5 * jnp.dot(yj, alpha) - jnp.sum(jnp.log(jnp.diagonal(l)))
               - 0.5 * j_tot * jnp.log(2.0 * jnp.pi))
        real_j = jnp.concatenate([core_real] * 4 + ([jnp.arange(t) < n_touch] if t else []))
        n_eff = jnp.concatenate([nf_eff, ng, ng, ng] + ([nf_all[c:]] if t else []))
        return val + jnp.sum(jnp.where(real_j, 0.0, 0.5 * jnp.log(2.0 * jnp.pi * n_eff)))

    vg = jax.jit(jax.value_and_grad(mll, argnums=(0, 1, 2)))

    def eval_fn(prm, scale):
        v, g = vg(jnp.log(jnp.asarray(prm["lengthscale"])), jnp.log(jnp.asarray(scale)),
                  jnp.log(jnp.asarray(prm["signal_variance"])))
        return v, dict(zip(("log_ls", "log_noise_scale", "log_sv"), g))

    return eval_fn


@P
def test_sharded_joint_mll_and_grad_matches_jax(p, problem, ranks):
    """The distributed identities against JAX's autodiff of the dense joint
    objective, with padded core rows and two occupied touch slots."""
    eval_fn = _dense_objective(problem["mll_x_all"], problem["mll_yj"], problem["mll_nf_all"],
                               problem["mll_ng"], problem["mll_c"], problem["mll_n_real"],
                               problem["mll_n_touch"])
    mll, g = eval_fn(_params(), problem["mll_scale"])
    want = np.array([float(g[k]) for k in ("log_ls", "log_noise_scale", "log_sv")])
    for out in ranks(p)[0]:
        np.testing.assert_allclose(float(out["mll"]), float(mll), rtol=TOL)
        np.testing.assert_allclose(out["mll_grad"], want, rtol=TOL)


def test_optimize_sharded_joint_matches_jax(problem, ranks, jax_models):
    """Two Adam steps: JAX's ascent loop on the dense objective of the
    same padded fit."""
    m = jax_models(2)[0]
    eval_fn = _dense_objective(m.x, m.y, m.noise_f, m.noise_g, m.n0, m.n_real, 0)
    res = jsho._mll_ascent(eval_fn, "rbf", _params(), jnp.float64, steps=2, learning_rate=0.1,
                           learn_noise=True, learn_signal=False)
    for out in ranks(2)[0]:
        np.testing.assert_allclose(out["opt_history"], np.asarray(res["history"]), rtol=TOL)
        np.testing.assert_allclose(float(out["opt_ls"]), float(res["params"]["lengthscale"]),
                                   rtol=TOL)
        np.testing.assert_allclose(float(out["opt_noise_scale"]), float(res["noise_scale"]),
                                   rtol=TOL)


@P
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_sharded_joint_checkpoint_both_ways(p, direction, problem, ranks, jax_models):
    """JAX's touched model saved and loaded by every rank, and the port's
    saved by its rank 0 and loaded by JAX: each predicts as the model it was
    saved from."""
    outs, d = ranks(p)
    touched = jax_models(p)[1]
    q = _j(problem["q"])
    if direction == "jax_to_port":
        mean, var = touched.predict(q)
        for out in outs:
            assert str(out["jax_ckpt_kind"]) == "ShardedJointModel"
            np.testing.assert_allclose(out["jax_ckpt_mean"], np.asarray(mean), atol=TOL)
            np.testing.assert_allclose(out["jax_ckpt_var"], np.asarray(var), atol=TOL)
    else:
        loaded = jckpt.load_model(str(d / "port_joint.npz"))
        assert type(loaded).__name__ == "ShardedJointModel" and loaded.n_touch == 8
        mean, var = loaded.predict(q)
        np.testing.assert_allclose(np.asarray(mean), outs[0]["update_mean"], atol=TOL)
        np.testing.assert_allclose(np.asarray(var), outs[0]["update_var"], atol=TOL)


@pytest.fixture(scope="module")
def jax_session(problem):
    cfg = JaxModelConfig(kernel="rbf", lengthscale=SESSION_LS, noise_surface=1e-4, n_external=32,
                         n_internal=1, touch_capacity=8, dtype="float64")
    sess = JaxSession(cfg, mesh=JaxMeshConfig(n_devices=2, block=SESSION_BLOCK))
    sess.start(problem["session_pts"], normals=problem["session_nrm"])
    out = {"kind": type(sess.model).__name__}
    out["mean"], out["var"] = sess.query(problem["session_q"])
    out["grid_mean"], out["grid_var"], _ = sess.evaluate_grid(10, 1.5)
    sess.update(problem["session_touch"])
    out["update_mean"], out["update_var"] = sess.query(problem["session_q"])
    # The session's method="distributed", its objective the dense one (JAX's
    # sharded objective re-traces its collective each call: ~13 s a step
    # here), then its refit with the touches bordered again.
    m = sess.model
    res = jsho._mll_ascent(_dense_objective(m.x, m.y, m.noise_f, m.noise_g, m.n0, m.n_real,
                                            m.n_touch), "rbf", m.params, jnp.float64, steps=2,
                           learning_rate=0.1, learn_noise=True, learn_signal=False)
    n, c, occ = m.n_real, m.n0, m.n_touch
    sess.model = jgsj.fit_sharded_joint(
        "rbf", m.x[:n], m.y[:n], m.normals[:n], m.noise_f[:n] * float(res["noise_scale"]),
        m.noise_g[:n], res["params"], mesh=m.mesh, block=m.block, touch_capacity=8,
        pad_noise=m.pad_noise).update(m.x[c:c + occ], m.y[4 * c:4 * c + occ],
                                      m.noise_f[c:c + occ])
    out["hyperopt_history"] = np.asarray(res["history"])
    out["hyperopt_mean"], out["hyperopt_var"] = sess.query(problem["session_q"])
    return out


@pytest.mark.parametrize("key", ["", "grid_", "update_", "hyperopt_"])
def test_mesh_session_with_normals_matches_jax(key, ranks, jax_session):
    """`start(normals=)` on a mesh fits the sharded joint model (rank 0's
    cloud), and its grid, update and distributed hyperopt (its ascent and
    its refit with the touches replayed) follow JAX's."""
    for out in ranks(2)[0]:
        assert str(out["session_kind"]) == jax_session["kind"] == "ShardedJointModel"
        if key == "hyperopt_":
            np.testing.assert_allclose(out["session_hyperopt_history"],
                                       jax_session["hyperopt_history"], rtol=TOL)
        for which in ("mean", "var"):
            np.testing.assert_allclose(out[f"session_{key}{which}"],
                                       np.asarray(jax_session[f"{key}{which}"]), atol=TOL)


def test_mesh_session_with_normals_restores_and_refuses(ranks):
    for out in ranks(2)[0]:
        np.testing.assert_allclose(out["session_restored_mean"], out["session_hyperopt_mean"],
                                   atol=1e-12)
        np.testing.assert_allclose(out["session_restored_var"], out["session_hyperopt_var"],
                                   atol=1e-12)
        assert str(out["err_hyperopt"]) == (
            "ValueError: unknown hyperopt method 'stream' for a sharded joint model "
            "(use 'subsample' or 'distributed')")


def test_cli_fit_normals_on_a_mesh_config_matches_jax(problem, ranks, monkeypatch, capsys):
    """`fit --normals --config mesh.json` (two ranks): the port's checkpoint,
    loaded by JAX, answers as the JAX CLI's own."""
    _, d = ranks(2)
    monkeypatch.chdir(d)
    assert jax_main(["fit", "cloudn.npz", "-o", "j_cli.npz", "--normals", "--lengthscale", "0.7",
                     "--noise", "1e-5", "--config", "mesh.json"]) == 0
    capsys.readouterr()
    jm, tm = jckpt.load_model("j_cli.npz"), jckpt.load_model("t_cli.npz")
    assert type(tm).__name__ == type(jm).__name__ == "ShardedJointModel"
    q = _j(problem["session_q"] - np.array([1.0, 0.0, 0.0]))
    for a, b in zip(tm.predict(q), jm.predict(q)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL)


def test_joint_ring_predict_runs_f_band_over_joint_columns(problem, tmp_path, monkeypatch):
    """Each ring hop of the joint predict takes Kernel F's band mode with
    the joint generator over the packed joint columns, at the rank's first
    row (the CPU twin would answer the same through the plain product, so
    the route is checked, on a one-rank gloo group)."""
    import torch.distributed as dist

    from gpis_tpu_torch.gp import sharded_joint as gsj
    from gpis_tpu_torch.kernels import cuda_query
    from gpis_tpu_torch.parallel.mesh import make_row_mesh

    calls = []
    quad_band = cuda_query.quad_band

    def spying(gen, name, q, cols, params, w_band, row0):
        calls.append((gen, cols.shape[1], row0, tuple(w_band.shape)))
        return quad_band(gen, name, q, cols, params, w_band, row0)

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        m = gsj.fit_sharded_joint("rbf", torch.as_tensor(problem["x"]),
                                  torch.zeros(C, dtype=torch.float64),
                                  torch.as_tensor(problem["nrm"]), torch.as_tensor(problem["nf"]),
                                  torch.as_tensor(problem["ng"]), {"lengthscale": LS,
                                                                   "signal_variance": SV},
                                  make_row_mesh(1, device="cpu"), block=B, touch_capacity=TOUCH)
        monkeypatch.setattr(cuda_query, "quad_band", spying)
        mean, var = m.predict(torch.as_tensor(problem["q"]))
    finally:
        dist.destroy_process_group()
    j = m.l.shape[1]
    assert calls == [("joint", 7, 0, (j, j))], calls
    want = jgsj.fit_sharded_joint(
        "rbf", _j(problem["x"]), jnp.zeros(C), _j(problem["nrm"]), _j(problem["nf"]),
        _j(problem["ng"]), _params(), mesh=jpm.make_row_mesh(1), block=B,
        touch_capacity=TOUCH).predict(_j(problem["q"]))
    for a, b in zip((mean, var), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)


@pytest.mark.parametrize("given", ["cross_fn", "band"])
def test_ring_predict_refuses_a_layout_half_given(given, problem):
    """A joint-layout cross_fn without Kernel F band's columns (or the
    columns without it) raises, never leaving the band kernel quietly."""
    from gpis_tpu_torch.gp import sharded_joint as gsj
    from gpis_tpu_torch.linalg import sharded as sh

    x = torch.as_tensor(problem["x"])
    kw = ({"cross_fn": lambda name, q, xx, pp: gsj.joint_cross(name, q, xx, pp, C)}
          if given == "cross_fn" else {"band": gsj.joint_band(x, C)})
    with pytest.raises(TypeError, match="cross_fn and band go together"):
        sh.sharded_predict_linv("rbf", torch.as_tensor(problem["q"]), x, _params(),
                                torch.zeros(4 * C), torch.zeros((4 * C, 4 * C)), None, **kw)


@P
def test_sharded_joint_ranks_import_no_jax(p, ranks):
    for out in ranks(p)[0]:
        assert str(out["imported"]) == ""
