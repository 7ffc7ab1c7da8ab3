"""The port's checkpoint (`utils.checkpoint`, the session's save / load /
restore) against the JAX package's, on the CPU in float64: a checkpoint
written by either package loads in the other, with the same answers at
BASELINE.md row 2's 1e-6 (the port's own round trip to the bit), for
in-core value models (W aliased as the factor, W beside it, no W, and
saved without the factor) and joint models with touches; the sharded value
model on two gloo ranks (`tests/torch_session_rank.py`, no jax); the
crash-recovery drill of tests/test_recovery.py; and the kinds that still
raise, naming their ROADMAP.md item."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

from gpis_tpu.api.session import ObjectModelSession as JaxSession
from gpis_tpu.config import ModelConfig as JaxModelConfig
from gpis_tpu.data import gpis as jgpis
from gpis_tpu.data import synthetic
from gpis_tpu.gp import derivative as jgpd
from gpis_tpu.gp import regression as jgpr
from gpis_tpu.kernels import functions as jkf
from gpis_tpu.utils import checkpoint as jckpt
from gpis_tpu_torch import convert
from gpis_tpu_torch.api.session import ObjectModelSession
from gpis_tpu_torch.config import ModelConfig
from gpis_tpu_torch.gp import derivative as gpd
from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.parallel.mesh import RowMesh
from gpis_tpu_torch.utils import checkpoint as ckpt
from torch_codec_ckpt import code_panel, one_rank_group
from torch_ranks import spawn_ranks

TOL = 1e-6
LS, SV = 0.7, 1.1


def _problem(n=200, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x, rng.normal(size=n) * 0.3, rng.uniform(1e-4, 1e-2, size=n)


def _q(n=40, seed=9):
    return np.random.default_rng(seed).uniform(-1.5, 1.5, size=(n, 3))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _value_models(layout):
    """One value problem fitted by both packages in one of the layouts a
    checkpoint distinguishes: W aliased as the factor (fit_inference, at a
    capacity of 256, the in-place W route), W beside the factor (fit with
    touch slots, one touch bordered in), no W."""
    x, y, noise = _problem()
    p, jp = kf.kernel_params(LS, SV), jkf.kernel_params(LS, SV)
    if layout == "linv_is_chol":
        m = gpr.fit_inference("rbf", _t(x), _t(y), _t(noise), p)
        jm = jgpr.fit_inference("rbf", _j(x), _j(y), _j(noise), jp)
        # JAX's jitted fit returns W twice; aliased, it is saved once too.
        return m, dataclasses.replace(jm, chol=jm.linv)
    m = gpr.fit("rbf", _t(x), _t(y), _t(noise), p, block=64, touch_capacity=64)
    jm = jgpr.fit("rbf", _j(x), _j(y), _j(noise), jp, block=64, touch_capacity=64)
    if layout == "has_linv":
        m, jm = gpr.with_linv(m), jgpr.with_linv(jm)
    t = np.array([[0.3, -0.2, 0.9]])
    return gpr.update(m, _t(t), 0.0, 1e-5), jgpr.update(jm, _j(t), 0.0, 1e-5)


def _same_answers(model, jmodel, atol=TOL):
    q = _q()
    mean, var = gpr.predict(model, _t(q))
    jmean, jvar = jgpr.predict(jmodel, _j(q))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=atol)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=atol)


@pytest.mark.parametrize("layout", ["linv_is_chol", "has_linv", "no_linv"])
@pytest.mark.parametrize("factor", [True, False])
def test_value_checkpoint_crosses_both_ways(tmp_path, layout, factor):
    m, jm = _value_models(layout)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    ckpt.save_model(ours, m, factor=factor)
    jckpt.save_model(theirs, jm, factor=factor)
    with np.load(ours) as d, np.load(theirs) as jd:
        assert sorted(d.files) == sorted(jd.files)
        meta, jmeta = json.loads(str(d["meta"])), json.loads(str(jd["meta"]))
    assert meta == jmeta
    loaded = ckpt.load_model(theirs, device="cpu")
    assert (loaded.linv is loaded.chol) == (layout == "linv_is_chol")
    _same_answers(loaded, jm)
    assert loaded.n_touch == int(jm.n_touch)
    again = ckpt.load_model(ours, device="cpu")
    _same_answers(again, jm)
    if factor:  # the port's own round trip is exact
        for key in ("chol", "alpha", "x", "noise"):
            assert torch.equal(getattr(again, key), getattr(m, key))
        assert again.params == m.params
    if not (layout == "linv_is_chol" and not factor):
        # The JAX package reads the port's file; without its factor a W
        # aliased as the factor comes back there as L (its load reads
        # linv = chol), which the port re-forms as W.
        _same_answers(m, jckpt.load_model(ours))


def _joint_models(touch):
    x, y, noise = _problem(60, seed=4)
    nrm = x.copy()
    ng = np.full(60, 1e-3)
    p, jp = kf.kernel_params(LS, SV), jkf.kernel_params(LS, SV)
    m = gpd.with_linv_joint(gpd.fit_with_normals("rbf", _t(x), _t(y), _t(nrm), _t(noise), _t(ng),
                                                 p, block=16, touch_capacity=touch))
    jm = jgpd.with_linv_joint(jgpd.fit_with_normals("rbf", _j(x), _j(y), _j(nrm), _j(noise),
                                                    _j(ng), jp, block=16, touch_capacity=touch))
    if touch:
        t = np.array([[0.3, -0.2, 0.9], [-0.5, 0.5, 0.6]])
        m, jm = gpd.update_joint(m, _t(t), 0.0, 1e-5), jgpd.update_joint(jm, _j(t), 0.0, 1e-5)
    return m, jm


def _same_joint_answers(model, jmodel):
    q = _q()
    mean, var = gpd.predict(model, _t(q))
    jmean, jvar = jgpd.predict(jmodel, _j(q))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=TOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=TOL)


@pytest.mark.parametrize("touch", [16, 0])
def test_joint_checkpoint_crosses_both_ways(tmp_path, touch):
    m, jm = _joint_models(touch)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    ckpt.save_model(ours, m)
    jckpt.save_model(theirs, jm)
    with np.load(ours) as d, np.load(theirs) as jd:
        assert sorted(d.files) == sorted(jd.files)
        assert json.loads(str(d["meta"])) == json.loads(str(jd["meta"]))
    loaded = ckpt.load_model(theirs, device="cpu")
    assert loaded.touch_capacity == touch and loaded.n_touch == (2 if touch else None)
    _same_joint_answers(loaded, jm)
    _same_joint_answers(m, jckpt.load_model(ours))
    # Bordering continues from the loaded factor as from the saved one.
    t = np.array([[0.0, 0.8, -0.6]])
    if touch:
        _same_joint_answers(gpd.update_joint(loaded, _t(t), 0.0, 1e-5),
                            jgpd.update_joint(jm, _j(t), 0.0, 1e-5))


def test_joint_checkpoint_without_factor_refits_with_its_touch_slots(tmp_path):
    """factor=False refits the factor from the joint Gram with the touch
    slots in it (the JAX package's load leaves them out, so the port's
    file is held to the saved model here)."""
    m, jm = _joint_models(16)
    path = str(tmp_path / "port.npz")
    ckpt.save_model(path, m, factor=False)
    loaded = ckpt.load_model(path, device="cpu")
    assert loaded.chol.shape == m.chol.shape
    np.testing.assert_allclose(loaded.chol.numpy(), m.chol.numpy(), atol=1e-9)
    _same_joint_answers(loaded, jm)


def test_load_jax_checkpoint_is_load_model(tmp_path):
    m, jm = _value_models("has_linv")
    path = str(tmp_path / "jax.npz")
    jckpt.save_model(path, jm)
    got = convert.load_jax_checkpoint(path, device="cpu")
    want = ckpt.load_model(path, device="cpu")
    for key in ("x", "chol", "linv", "alpha"):
        assert torch.equal(getattr(got, key), getattr(want, key))


def test_float32_jax_parameters_are_read_as_float32(tmp_path):
    x, y, noise = _problem(100)
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731
    jm = jgpr.fit("rbf", f32(x), f32(y), f32(noise), {"lengthscale": f32(0.7),
                                                      "signal_variance": f32(1.1)},
                  block=64, touch_capacity=0)
    path = str(tmp_path / "f32.npz")
    jckpt.save_model(path, jm)
    m = ckpt.load_model(path, device="cpu")
    assert m.dtype == torch.float32
    assert m.params == {"lengthscale": float(np.float32(0.7)),
                        "signal_variance": float(np.float32(1.1))}


# ------------------------------------------------------------- the session

CFG = dict(kernel="rbf", lengthscale=0.7, noise_surface=1e-5, touch_capacity=16)
TOUCHES = [np.array([[0.0, 0.0, -1.02]]), np.array([[0.3, 0.0, -0.95]]),
           np.array([[0.0, 0.3, -0.95]])]  # the last is pending at the crash


def _cloud():
    return synthetic.partial_sphere_cloud(200, radius=1.0, cap_cos=-0.2, seed=11)[0]


def _probe():
    return jgpis.fibonacci_sphere(96, radius=1.0)


def test_session_crash_recovery_replays_pending_touch(tmp_path):
    """tests/test_recovery.py's drill: fit, two touches, save, crash, load,
    replay the pending touch; the same answers as an uninterrupted run,
    which answers as the JAX session's."""
    cfg = ModelConfig(**CFG, dtype="float64")
    s1 = ObjectModelSession(cfg, device="cpu").start(_cloud())
    s1.update(TOUCHES[0]).update(TOUCHES[1])
    path = str(tmp_path / "crashed.npz")
    s1.save(path)
    saved = s1.query(_probe())
    del s1
    s2 = ObjectModelSession.load(path, cfg, device="cpu")
    np.testing.assert_array_equal(s2.query(_probe()), saved)
    s2.update(TOUCHES[2])
    s3 = ObjectModelSession(cfg, device="cpu").start(_cloud())
    for t in TOUCHES:
        s3.update(t)
    np.testing.assert_allclose(s2.query(_probe()), s3.query(_probe()), atol=1e-8)
    j3 = JaxSession(JaxModelConfig(**CFG, dtype="float64")).start(_cloud())
    for t in TOUCHES:
        j3.update(t)
    np.testing.assert_allclose(s2.query(_probe()), j3.query(_probe()), atol=TOL)
    assert len(s2.next_best_path().path) >= 1


def test_session_recovery_joint_model(tmp_path):
    """The drill on the joint model: bordering continues from the
    checkpointed factor; a JAX session restores the port's file."""
    pts = _cloud()
    ctr = pts - pts.mean(axis=0)
    normals = ctr / np.linalg.norm(ctr, axis=1, keepdims=True)
    cfg = ModelConfig(**CFG, dtype="float64")
    s1 = ObjectModelSession(cfg, device="cpu").start(pts, normals=normals)
    s1.update(TOUCHES[0])
    path = str(tmp_path / "joint.npz")
    s1.save(path)
    del s1
    s2 = ObjectModelSession.load(path, cfg, device="cpu").update(TOUCHES[1])
    j2 = JaxSession.load(path, JaxModelConfig(**CFG, dtype="float64")).update(TOUCHES[1])
    s3 = ObjectModelSession(cfg, device="cpu").start(pts, normals=normals)
    s3.update(TOUCHES[0]).update(TOUCHES[1])
    np.testing.assert_allclose(s2.query(_probe()), s3.query(_probe()), atol=1e-7)
    np.testing.assert_allclose(s2.query(_probe()), j2.query(_probe()), atol=TOL)


def test_restored_joint_overflow_raises_clearly(tmp_path):
    """A restored joint session borders touches while its slots last; past
    them it cannot fold touches into a core it does not have, and says so,
    as the JAX session does."""
    cfg = ModelConfig(kernel="rbf", lengthscale=0.7, noise_surface=1e-5, block=8,
                      touch_capacity=2, dtype="float64")  # rounds up to 8 slots
    pts = _cloud()
    ctr = pts - pts.mean(axis=0)
    normals = ctr / np.linalg.norm(ctr, axis=1, keepdims=True)
    s1 = ObjectModelSession(cfg, device="cpu").start(pts, normals=normals)
    path = str(tmp_path / "ovf.npz")
    s1.save(path)
    del s1
    s2 = ObjectModelSession.load(path, cfg, device="cpu")
    cap = s2.model.touch_capacity
    batch = np.concatenate([TOUCHES[0], TOUCHES[1]])
    for _ in range(cap // len(batch)):
        s2.update(batch)
    with pytest.raises(ValueError, match="restored session"):
        s2.update(np.concatenate([batch, TOUCHES[2]]))
    # restore() into a started session drops its training set too.
    s3 = ObjectModelSession(cfg, device="cpu").start(pts, normals=normals).restore(path)
    with pytest.raises(ValueError, match="restored session"):
        for _ in range(cap // len(batch) + 1):
            s3.update(batch)


@pytest.mark.parametrize("what, item", [
    ("ooc_int16", 15), ("ooc_float16", 15), ("ooc_joint_int16", 15), ("sharded_joint", 14)])
def test_unported_checkpoints_name_their_item(tmp_path, what, item):
    # The checkpoints that raised naming their ROADMAP item until items 15
    # and 14 were ported (the name is kept): W panels in a spill codec (an
    # int16-coded one, or a float16 one, as the JAX package's store writes
    # them), and a sharded joint model; the port's load answers as JAX's
    # within 1e-6.
    path = str(tmp_path / "m.npz")
    q = _probe()
    if what.startswith("ooc"):
        cfg = ModelConfig(kernel="rbf", lengthscale=0.7, touch_capacity=0, dtype="float64")
        pts = _cloud()
        normals = pts / np.linalg.norm(pts, axis=1, keepdims=True) if "joint" in what else None
        ObjectModelSession(cfg, device="cpu").start(pts, normals=normals,
                                                    out_of_core=True).save(path)
        code_panel(path + ".w", 1, what.split("_")[-1])
        got = ckpt.load_model(path, device="cpu").predict(torch.as_tensor(q))
    else:
        from gpis_tpu.gp import sharded_joint as jgsj
        from gpis_tpu.parallel import mesh as jpm

        pts = _cloud()
        nrm = pts / np.linalg.norm(pts, axis=1, keepdims=True)
        jm = jgsj.fit_sharded_joint("rbf", jnp.asarray(pts[:60]), jnp.zeros(60),
                                    jnp.asarray(nrm[:60]), 1e-4, 1e-3,
                                    jkf.kernel_params(0.7, 1.0), mesh=jpm.make_row_mesh(1),
                                    block=16, touch_capacity=8)
        jckpt.save_model(path, jm)
        with one_rank_group(tmp_path):
            m = ckpt.load_model(path, device="cpu")
            assert type(m).__name__ == "ShardedJointModel"
            got = m.predict(torch.as_tensor(q))
    want = jckpt.load_model(path).predict(jnp.asarray(q))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


# --------------------------------------------------------- two gloo ranks

SHARDED_KW = dict(kernel="rbf", lengthscale=0.7, noise_surface=1e-5, n_external=32,
                  block=64, dtype="float64")


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Two ranks: save, restore and replay, and restore the JAX package's
    sharded checkpoint of the same session."""
    from gpis_tpu.config import MeshConfig as JaxMeshConfig

    out_dir = tmp_path_factory.mktemp("checkpoint_ranks")
    pts = _cloud()
    touch = np.array([[0.0, 0.0, -1.02], [0.3, 0.0, -0.95], [0.0, 0.3, -0.95]])
    jsess = JaxSession(JaxModelConfig(**SHARDED_KW, touch_capacity=8),
                       mesh=JaxMeshConfig(n_devices=2, block=64)).start(pts)
    jsess.update(touch[:2])
    jax_path = str(out_dir / "jax_sharded.npz")
    jsess.save(jax_path)
    inputs = dict(pts=pts, ls=0.7, touch_capacity=8, touch=touch, q=_probe(),
                  jax_path=np.array(jax_path))
    return spawn_ranks("torch_session_rank.py", ["checkpoint"], 2, inputs, out_dir), jsess, out_dir


def test_sharded_round_trip_on_two_ranks(sharded):
    outs, jsess, _ = sharded
    for out in outs:
        assert out["imported"] == "" and int(out["n_touch"]) == 2
        for key in ("mean", "var"):
            np.testing.assert_array_equal(out[f"restored_{key}"], out[f"saved_{key}"])
            np.testing.assert_allclose(out[f"replayed_{key}"], out[f"uninterrupted_{key}"],
                                       atol=1e-8)
    np.testing.assert_array_equal(outs[0]["saved_mean"], outs[1]["saved_mean"])


def test_sharded_checkpoint_crosses_both_ways(sharded):
    outs, jsess, out_dir = sharded
    jmean, jvar = jsess.query(_probe())
    for out in outs:  # the JAX file on the port's ranks
        np.testing.assert_allclose(out["jax_mean"], jmean, atol=TOL)
        np.testing.assert_allclose(out["jax_var"], jvar, atol=TOL)
    # The port's file in the JAX package, on a mesh of two virtual devices.
    jm = jckpt.load_model(str(out_dir / "sharded.npz"))
    assert jm.mesh.shape["row"] == 2 and jm.n_touch == 2
    np.testing.assert_allclose(np.asarray(jm.w), np.concatenate([o["band"] for o in outs]),
                               atol=0)
    # A group of another size refuses the file.
    mesh = RowMesh(rank=0, size=1, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(RuntimeError, match="fit on 2 devices"):
        ckpt.load_model(str(out_dir / "sharded.npz"), device="cpu", mesh=mesh)
