"""The port's fit + dense-grid query slice (gpis_tpu_torch) against the JAX
package and the NumPy/SciPy oracle, on the CPU in float64 (the port's
wrappers take their plain twins for CPU tensors).  The bar is BASELINE.md
row 2: 1e-6 on posterior mean and variance."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)
import torch_jax_native

import oracle
from gpis_tpu.api.session import ObjectModelSession as JaxSession
from gpis_tpu.config import ModelConfig
from gpis_tpu.gp import regression as jgpr
from gpis_tpu.kernels import functions as jkf
from gpis_tpu.surface import grid as jgrid
from gpis_tpu.utils import checkpoint as jckpt
from gpis_tpu_torch import convert
from gpis_tpu_torch.api.session import ObjectModelSession
from gpis_tpu_torch.data import gpis
from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.linalg import cholesky as lin
from gpis_tpu_torch.surface import grid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _problem(name, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = rng.normal(size=n) * 0.3
    if name == "thin_plate":  # only conditionally PD: the GPIS sphere and more noise
        noise = rng.uniform(1e-2, 2e-2, size=n)
    else:
        x *= rng.uniform(0.8, 1.2, size=(n, 1))
        noise = rng.uniform(1e-3, 1e-2, size=n)
    q = rng.uniform(-1.5, 1.5, size=(97, 3))
    ls = 2.5 if name == "thin_plate" else 0.7
    return x, y, noise, q, ls


def _t(a):
    return torch.as_tensor(np.asarray(a))


# n=500 pads to capacity 512 (the in-place W pipeline); n=300 pads to 384,
# which takes fit + with_linv as in the JAX package.
@pytest.mark.parametrize("name,n", [("rbf", 500), ("rbf", 300), ("thin_plate", 500),
                                    ("laplace", 500), ("inverse_multiquadric", 300)])
def test_fit_inference_predict_matches_jax_and_oracle(name, n):
    x, y, noise, q, ls = _problem(name, n)
    model = gpr.fit_inference(name, _t(x), _t(y), _t(noise), kf.kernel_params(ls, 1.0))
    assert model.linv is not None
    mean, var = gpr.predict(model, _t(q))
    jm = jgpr.fit_inference(name, jnp.asarray(x), jnp.asarray(y), jnp.asarray(noise),
                            jkf.kernel_params(ls, 1.0))
    jmean, jvar = jgpr.predict(jm, jnp.asarray(q))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=1e-6)
    om = oracle.fit(name, x, y, noise, ls, 1.0)
    omean, ovar = oracle.predict(om, q)
    np.testing.assert_allclose(mean.numpy(), omean, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), ovar, atol=1e-6)


@pytest.mark.parametrize("path", ["solve", "kinv", "linv"])
def test_fit_predict_paths_match_oracle(path):
    x, y, noise, q, ls = _problem("rbf", 200, seed=1)
    model = gpr.fit("rbf", _t(x), _t(y), _t(noise), kf.kernel_params(ls, 1.0), block=64,
                    touch_capacity=64)
    if path == "kinv":
        eye = torch.eye(model.capacity, dtype=model.dtype)
        model = dataclasses.replace(model, kinv=lin.cho_solve(model.chol, eye))
    elif path == "linv":
        model = gpr.with_linv(model)
    mean, var = gpr.predict(model, _t(q))
    omean, ovar = oracle.predict(oracle.fit("rbf", x, y, noise, ls, 1.0), q)
    np.testing.assert_allclose(mean.numpy(), omean, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), ovar, atol=1e-6)
    np.testing.assert_allclose(gpr.predict_mean(model, _t(q)).numpy(), omean, atol=1e-6)


def test_jitter_ladder_rescues_an_indefinite_float32_fit():
    # A dense coherent float32 cloud with tiny noise: the first factor
    # attempt may come back NaN; the ladder must land on a finite model.
    pts = gpis.fibonacci_sphere(900).astype(np.float32)
    x = torch.as_tensor(pts)
    model = gpr.fit_inference("rbf", x, torch.zeros(900), torch.full((900,), 1e-7),
                              kf.kernel_params(0.9, 1.0))
    assert torch.isfinite(model.linv).all()
    assert torch.isfinite(gpr.predict(model, x[:10])[1]).all()


def test_training_set_and_grid_match_jax():
    from gpis_tpu.data import gpis as jgpis

    cfg = ModelConfig(n_external=37, n_internal=3, dtype="float64")
    pts = np.random.default_rng(2).normal(size=(150, 3)) + 4.0
    ts = gpis.build_training_set(pts, cfg, device="cpu")
    jts = jgpis.build_training_set(jnp.asarray(pts), cfg)
    for a, b in ((ts.x, jts.x), (ts.y, jts.y), (ts.noise, jts.noise),
                 (ts.frame.centroid, jts.frame.centroid), (ts.frame.scale, jts.frame.scale)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
    coords, axis = grid.make_grid(7, 1.3, dtype=torch.float64, device="cpu")
    jcoords, jaxis = jgrid.make_grid(7, 1.3, dtype=jnp.float64)
    np.testing.assert_allclose(coords.numpy(), np.asarray(jcoords), atol=1e-14)
    np.testing.assert_allclose(axis.numpy(), np.asarray(jaxis), atol=1e-14)


def test_session_extract_surface_matches_jax_session():
    cfg = ModelConfig(kernel="rbf", lengthscale=0.4, noise_surface=1e-3, n_external=64,
                      touch_capacity=0, dtype="float64")
    pts = gpis.fibonacci_sphere(500) * 1.7 + np.array([0.3, -0.2, 1.0])
    sess = ObjectModelSession(cfg, device="cpu").start(pts)
    jsess = JaxSession(cfg).start(pts)
    mean, var, _ = sess.evaluate_grid(24, 1.3)
    jmean, jvar, _ = jsess.evaluate_grid(24, 1.3)
    np.testing.assert_allclose(mean, jmean, atol=1e-6)
    np.testing.assert_allclose(var, jvar, atol=1e-6)
    torch_jax_native.require()  # the JAX soup in its native order
    verts, faces, vvar = sess.extract_surface(resolution=24, extent=1.3)
    jverts, jfaces, jvvar = jsess.extract_surface(resolution=24, extent=1.3)
    np.testing.assert_array_equal(faces, jfaces)
    np.testing.assert_allclose(verts, jverts, atol=1e-6)
    np.testing.assert_allclose(vvar, jvvar, atol=1e-6)
    qm, qv = sess.query(pts[:20])
    np.testing.assert_allclose(qm, 0.0, atol=0.05)  # surface points sit on f = 0
    np.testing.assert_allclose((qm, qv), jsess.query(pts[:20]), atol=1e-6)


def test_session_verbs_not_yet_ported_raise(tmp_path):
    # What stayed unported behind the session's verbs until item 14 (the
    # name is kept): out-of-core checkpoints round trip here to the bit, and
    # a JAX sharded joint checkpoint restores (on a one-rank group) and
    # answers as the JAX session restored from it.
    cfg = ModelConfig(touch_capacity=0, dtype="float64")
    sess = ObjectModelSession(cfg, device="cpu")
    pts = gpis.fibonacci_sphere(50)
    ooc = ObjectModelSession(cfg, device="cpu").start(pts, out_of_core=True)
    ooc_joint = ObjectModelSession(cfg, device="cpu").start(pts, normals=pts, out_of_core=True)
    for name, s in (("o", ooc), ("j", ooc_joint)):
        path = str(tmp_path / f"{name}.npz")
        s.save(path)
        np.testing.assert_array_equal(sess.restore(path).query(pts), s.query(pts))
    from gpis_tpu.gp import sharded_joint as jgsj
    from gpis_tpu.parallel import mesh as jpm
    from torch_codec_ckpt import one_rank_group

    path = str(tmp_path / "sharded_joint.npz")
    jm = jgsj.fit_sharded_joint("rbf", jnp.asarray(pts), jnp.zeros(50), jnp.asarray(pts), 1e-4,
                                1e-3, jkf.kernel_params(0.5, 1.0), mesh=jpm.make_row_mesh(1),
                                block=16, touch_capacity=8)
    jckpt.save_model(path, jm)
    np.savez(path + ".frame.npz", centroid=np.zeros(3), scale=np.ones(()))
    with one_rank_group(tmp_path):
        got = sess.restore(path).query(pts * 1.1)
    np.testing.assert_allclose(got, JaxSession(ModelConfig(dtype="float64")).restore(path)
                               .query(pts * 1.1), atol=1e-6)


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot be observed")
    with pytest.raises(RuntimeError, match="cuda"):
        ObjectModelSession(ModelConfig(), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        ObjectModelSession(ModelConfig())  # the default device is the card
    with pytest.raises(RuntimeError, match="cuda"):
        gpis.build_training_set(np.ones((4, 3)), ModelConfig())


@pytest.mark.parametrize("alias", [False, True])
def test_jax_checkpoint_carries_across(tmp_path, alias):
    x, y, noise, q, ls = _problem("rbf", 150, seed=3)
    jm = jgpr.with_linv(jgpr.fit("rbf", jnp.asarray(x), jnp.asarray(y), jnp.asarray(noise),
                                 jkf.kernel_params(ls, 1.0), touch_capacity=0))
    if alias:  # a fit_inference model stores W once, as its chol
        jm = dataclasses.replace(jm, chol=jm.linv)
    path = str(tmp_path / "m.npz")
    jckpt.save_model(path, jm)
    model = convert.load_jax_checkpoint(path, device="cpu")
    assert (model.linv is model.chol) == alias
    mean, var = gpr.predict(model, _t(q))
    jmean, jvar = jgpr.predict(jm, jnp.asarray(q))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-10)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=1e-10)


def test_port_runs_without_importing_jax():
    code = (
        "import sys, numpy as np\n"
        "from gpis_tpu_torch import ObjectModelSession, ModelConfig\n"
        "from gpis_tpu_torch.data.gpis import fibonacci_sphere\n"
        "cfg = ModelConfig(lengthscale=0.4, noise_surface=1e-3, touch_capacity=0)\n"
        "s = ObjectModelSession(cfg, device='cpu').start(fibonacci_sphere(300))\n"
        "v, f, var = s.extract_surface(resolution=16, extent=1.5)\n"
        "assert len(v) and np.isfinite(var).all()\n"
        "pts = fibonacci_sphere(200)\n"
        "j = ObjectModelSession(cfg, device='cpu').start(pts, normals=pts)\n"
        "v, f, var = j.extract_surface(resolution=16, extent=1.5)\n"
        "assert len(v) and np.isfinite(var).all()\n"
        "assert np.isfinite(j.query(pts[:10])[1]).all()\n"
        "for kw in ({}, {'normals': pts}):\n"
        "    o = ObjectModelSession(cfg, device='cpu').start(pts, out_of_core=True, **kw)\n"
        "    v, f, var = o.extract_surface(resolution=16, extent=1.5)\n"
        "    assert len(v) and np.isfinite(var).all()\n"
        "import gpis_tpu_torch.api.service, tempfile, os\n"
        "from gpis_tpu_torch.config import ExploreConfig\n"
        "e = ObjectModelSession(cfg, ExploreConfig(max_charts=4), device='cpu').start(pts)\n"
        "assert len(e.next_best_path().path) and e.is_done() in (True, False)\n"
        "path = os.path.join(tempfile.mkdtemp(), 'm.npz')\n"
        "e.save(path)\n"
        "assert ObjectModelSession.load(path, cfg, device='cpu').model.capacity\n"
        "ct = ModelConfig(lengthscale=0.4, noise_surface=1e-3, touch_capacity=64)\n"
        "c = ObjectModelSession(ct, ExploreConfig(max_charts=4), device='cpu')\n"
        "c.start(pts, experts=2, expert_gate=1).update(pts[:1])\n"
        "assert np.isfinite(c.extract_surface(resolution=16, extent=1.5)[2]).all()\n"
        "assert len(c.next_best_path().path)\n"
        "c.optimize_hyperparameters(method='poe', steps=1)\n"
        "c.save(path)\n"
        "assert ObjectModelSession.load(path, ct, device='cpu').model.n_experts == 2\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "jax_pkg = [m for m in sys.modules if m == 'gpis_tpu' or m.startswith('gpis_tpu.')]\n"
        "assert not jax_pkg, f'the JAX package was imported: {jax_pkg}'\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
