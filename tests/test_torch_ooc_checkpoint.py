"""The out-of-core checkpoint and the disk tier of the panel store
(`utils/checkpoint.py`, `linalg/outofcore.TieredPanelStore`) against the
JAX package, on the CPU in float64: checkpoints written by either package
load in the other (in-core value and joint, out-of-core value and joint
with a touch tail and their `.w/` panel directories); a restored model
saved back to its own path; `open_dir` skipping a missing panel, refusing
another problem's tag, reading JAX's int16-coded panels, and a JAX
checkpoint with float16 W panels; `ooc_fit` spilling to disk,
and its `dtype`, `initial_jitter` and `max_jitter_retries`, as JAX's.

Tolerance: 1e-6 across the packages (BASELINE.md row 2); a package's own
round trip to the bit."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

from gpis_tpu.api.session import ObjectModelSession as JaxSession
from gpis_tpu.config import ModelConfig as JaxModelConfig
from gpis_tpu.data import synthetic
from gpis_tpu.kernels import functions as jkf
from gpis_tpu.linalg import outofcore as jooc
from gpis_tpu_torch.api.session import ObjectModelSession
from gpis_tpu_torch.config import ModelConfig
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.linalg import outofcore as ooc
from gpis_tpu_torch.utils import checkpoint as ckpt

TOL = 1e-6
CFG = dict(kernel="rbf", lengthscale=0.7, noise_surface=1e-5, touch_capacity=16,
           dtype="float64")
TOUCH = np.array([[0.0, 0.0, -1.02], [0.3, 0.0, -0.95]])


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for the module: these sizes gain nothing from
    more, and the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud():
    pts = synthetic.partial_sphere_cloud(200, radius=1.0, cap_cos=-0.2, seed=11)[0]
    ctr = pts - pts.mean(axis=0)
    return pts, ctr / np.linalg.norm(ctr, axis=1, keepdims=True)


def _probe():
    return np.random.default_rng(2).uniform(-1.3, 1.3, size=(80, 3))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Each kind's JAX and port sessions, touched once, saved: kind ->
    {"jax": path, "torch": path, "query": {package: its own query}}."""
    d = tmp_path_factory.mktemp("ckpt")
    pts, nrm = _cloud()
    out = {}
    for kind in ("value", "joint", "ooc", "ooc_joint"):
        kw = dict(normals=nrm if "joint" in kind else None, out_of_core=kind.startswith("ooc"))
        sessions = {"jax": JaxSession(JaxModelConfig(**CFG)).start(pts, **kw),
                    "torch": ObjectModelSession(ModelConfig(**CFG), device="cpu").start(pts,
                                                                                       **kw)}
        out[kind] = {"query": {}}
        for pkg, sess in sessions.items():
            sess.update(TOUCH)
            path = str(d / f"{kind}_{pkg}.npz")
            sess.save(path)
            out[kind][pkg] = path
            out[kind]["query"][pkg] = sess.query(_probe())
        np.testing.assert_allclose(out[kind]["query"]["torch"], out[kind]["query"]["jax"],
                                   atol=TOL)
    return out


@pytest.mark.parametrize("kind", ["value", "joint", "ooc", "ooc_joint"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_both_ways(saved, kind, writer):
    path, want = saved[kind][writer], saved[kind]["query"][writer]
    if kind.startswith("ooc"):
        doc = json.load(open(path + ".w/manifest.json"))
        assert doc["compute_dtype"] == "float64" and len(doc["panels"]) >= 2
    got = {"torch": ObjectModelSession.load(path, ModelConfig(**CFG), device="cpu"),
           "jax": JaxSession.load(path, JaxModelConfig(**CFG))}
    if kind.startswith("ooc"):
        assert type(got["torch"].model).__name__ == ("OOCJointModel" if "joint" in kind
                                                     else "OOCModel")
        assert got["torch"].model.n_tail == len(TOUCH)
    for pkg, sess in got.items():
        q = sess.query(_probe())
        if pkg == writer:
            np.testing.assert_array_equal(q, want)
        else:
            np.testing.assert_allclose(q, want, atol=TOL)
    # The tail keeps bordering after a restore.
    for sess in got.values():
        sess.update(np.array([[0.0, 0.3, -0.95]]))
    np.testing.assert_allclose(got["torch"].query(_probe()), got["jax"].query(_probe()),
                               atol=TOL)


@pytest.mark.parametrize("how", ["load_model", "session"])
def test_saving_a_restored_model_to_its_own_path(saved, tmp_path, how):
    """The restored model's panels are its checkpoint's files (load_model
    leaves them on disk; the session promotes copies): saving it back to
    that path must rewrite them whole, not zero them."""
    src = saved["ooc"]["torch"]
    path = str(tmp_path / "m.npz")
    ObjectModelSession.load(src, ModelConfig(**CFG), device="cpu").save(path)
    want = saved["ooc"]["query"]["torch"]
    probe = torch.as_tensor(_probe())
    if how == "load_model":
        m = ckpt.load_model(path, device="cpu")
        assert m.wstore.spilled() == list(range(len(m.wstore._p)))  # all on disk
        frame = ObjectModelSession.load(path, ModelConfig(**CFG), device="cpu").frame
        before = [t.numpy().copy() for t in m.predict(frame.to_normalized(probe))]
        ckpt.save_model(path, m)
        after = [t.numpy() for t in m.predict(frame.to_normalized(probe))]
        for a, b in zip(after, before):
            np.testing.assert_array_equal(a, b)
    else:
        sess = ObjectModelSession.load(path, ModelConfig(**CFG), device="cpu")
        assert not sess.model.wstore.spilled()  # promoted at restore
        sess.save(path)
    again = ObjectModelSession.load(path, ModelConfig(**CFG), device="cpu")
    np.testing.assert_array_equal(again.query(_probe()), want)
    assert again.model.wstore.get(0).abs().max() > 0


def _store_dir(tmp_path, tag=None, nb=3):
    st = ooc.TieredPanelStore(ooc.DeviceBudget(0), "cpu", spill_dir=str(tmp_path / "w"), tag=tag)
    rng = np.random.default_rng(0)
    panels = [rng.normal(size=(4, 4 * (j + 1))) for j in range(nb)]
    for j, p in enumerate(panels):
        st.put_host(j, p)
    st.compute_dtype = torch.float64
    st.save_manifest()
    return st, panels


def test_open_dir_skips_a_missing_panel(tmp_path):
    st, panels = _store_dir(tmp_path)
    os.unlink(str(tmp_path / "w" / "panel_1.bin"))
    for cls, budget in ((ooc.TieredPanelStore, ooc.DeviceBudget(0)),
                        (jooc.TieredPanelStore, jooc.DeviceBudget(0))):
        back = cls.open_dir(budget, str(tmp_path / "w"),
                            **({"device": "cpu"} if cls is ooc.TieredPanelStore else {}))
        assert 1 not in back and 0 in back and 2 in back
        for j in (0, 2):
            np.testing.assert_array_equal(np.asarray(back.get(j).read()), panels[j])
    back = ooc.TieredPanelStore.open_dir(ooc.DeviceBudget(10**9), str(tmp_path / "w"),
                                         device="cpu")
    assert back.compute_dtype == torch.float64 and back.spilled() == [0, 2]
    assert back.promote() == sum(p.nbytes for j, p in enumerate(panels) if j != 1)
    np.testing.assert_array_equal(back.get(2).numpy(), panels[2])
    assert os.path.exists(str(tmp_path / "w" / "panel_2.bin"))  # promoting keeps the files


def test_open_dir_refuses_another_problems_panels(tmp_path):
    st, _ = _store_dir(tmp_path, tag="problem-a")
    for cls, budget, kw in ((ooc.TieredPanelStore, ooc.DeviceBudget(0), {"device": "cpu"}),
                            (jooc.TieredPanelStore, jooc.DeviceBudget(0), {})):
        with pytest.raises(ValueError, match="different problem"):
            cls.open_dir(budget, str(tmp_path / "w"), expect_tag="problem-b", **kw)
        assert cls.open_dir(budget, str(tmp_path / "w"), expect_tag="problem-a",
                            **kw).tag == "problem-a"
    st.clear()  # the files and the manifest go
    assert os.listdir(str(tmp_path / "w")) == []


def test_open_dir_refuses_an_int16_entry(tmp_path):
    """A store of int16-coded panels written by the JAX package (its L
    codec), which `open_dir` refused until the codec was ported (the name
    is kept), reopens in the port, whose fetch decodes each panel to
    JAX's."""
    rng = np.random.default_rng(3)
    jst = jooc.TieredPanelStore(jooc.DeviceBudget(0), spill_dir=str(tmp_path / "q"),
                                spill_codec="int16")
    panels = [rng.normal(size=(8, 600 * (j + 1))) for j in range(2)]
    for j, p in enumerate(panels):
        jst.put(j, jnp.asarray(p))
    jst.save_manifest()
    st = ooc.TieredPanelStore.open_dir(ooc.DeviceBudget(0), str(tmp_path / "q"), device="cpu")
    dev = jooc._compute_device()
    for j, p in enumerate(panels):
        got = ooc._fetch(st, j)[0].numpy()
        np.testing.assert_array_equal(got, np.asarray(jooc._fetch(jst, j, dev)))
        assert got.shape == p.shape and np.abs(got - p).max() < np.abs(p).max() / 32767


def test_a_jax_checkpoint_with_float16_w_panels_answers_as_jax(tmp_path):
    """An out-of-core JAX model fit with w_dtype=float16, checkpointed:
    its narrowed W panels load in the port and answer within 1e-6."""
    x, y, noise = _problem()
    jm = jooc.ooc_fit("rbf", jnp.asarray(x), jnp.asarray(y), jnp.asarray(noise),
                      jkf.kernel_params(0.7, 1.1), panel=128, block=64,
                      device_budget=2 * 128 * 384 * 8, w_dtype=jnp.float16)
    path = str(tmp_path / "f16.npz")
    from gpis_tpu.utils import checkpoint as jckpt

    jckpt.save_model(path, jm)
    with open(path + ".w/manifest.json") as f:
        assert "float16" in [e[1] for e in json.load(f)["panels"].values()]
    m = ckpt.load_model(path, device="cpu")
    assert m.wstore.has_compressed_panels()
    q = _probe()
    want = jm.predict(jnp.asarray(q), chunk=80)
    for got, w in zip(m.predict(torch.as_tensor(q)), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=TOL)
    # Reattached with no spill dtype configured, it still refuses an update.
    with pytest.raises(ValueError, match="w_dtype=None"):
        m.update(torch.tensor([[0.8, 0.0, 0.0]], dtype=torch.float64), 0.0, 1e-6)


def _problem(n=300, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x, rng.normal(size=n) * 0.3, rng.uniform(1e-4, 1e-2, size=n)


@pytest.mark.parametrize("kind", ["value", "joint"])
def test_ooc_fit_spills_to_disk_as_jax(tmp_path, kind):
    x, y, noise = _problem()
    p, jp = kf.kernel_params(0.7, 1.1), jkf.kernel_params(0.7, 1.1)
    panel, c = (128, 384) if kind == "value" else (256, 1536)
    kw = dict(panel=panel, block=64, store="tiered", device_budget=2 * panel * c * 8)
    t = [torch.as_tensor(a) for a in (x, y, noise)]
    j = [jnp.asarray(a) for a in (x, y, noise)]
    if kind == "value":
        m = ooc.ooc_fit("rbf", *t, p, spill_dir=str(tmp_path / "t"), **kw)
        jm = jooc.ooc_fit("rbf", *j, jp, spill_dir=str(tmp_path / "j"), **kw)
    else:
        m = ooc.ooc_fit_joint("rbf", t[0], t[1], t[0], t[2], 1e-2, p,
                              spill_dir=str(tmp_path / "t"), **kw)
        jm = jooc.ooc_fit_joint("rbf", j[0], j[1], j[0], j[2], 1e-2, jp,
                                spill_dir=str(tmp_path / "j"), **kw)
    spilled = m.wstore.spilled()
    assert spilled == sorted(k for k, (on, _) in jm.wstore._meta.items() if not on) and spilled
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) == \
        sorted(f"panel_{k}.bin" for k in spilled)
    for k in spilled:
        assert isinstance(m.wstore.get(k), ooc._DiskPanel)
        np.testing.assert_allclose(np.asarray(m.wstore.get(k).read()),
                                   np.asarray(jm.wstore.get(k).read()), atol=1e-8)
    q = np.random.default_rng(5).normal(size=(64, 3)) * 0.8
    got, want = m.predict(torch.as_tensor(q)), jm.predict(jnp.asarray(q))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)
    m.wstore.clear()
    assert os.listdir(tmp_path / "t") == []


def test_ooc_fit_dtype_and_jitter_options():
    x, y, noise = _problem(200)
    p, jp = kf.kernel_params(0.7, 1.1), jkf.kernel_params(0.7, 1.1)
    t = [torch.as_tensor(a) for a in (x, y, noise)]
    j = [jnp.asarray(a) for a in (x, y, noise)]
    kw = dict(panel=128, block=64, store="device")
    m = ooc.ooc_fit("rbf", *t, p, dtype=torch.float32, **kw)
    jm = jooc.ooc_fit("rbf", *j, jp, dtype=jnp.float32, **kw)
    assert m.dtype == torch.float32 and jm.x.dtype == jnp.float32
    q = np.random.default_rng(6).normal(size=(32, 3)) * 0.8
    np.testing.assert_allclose(m.predict(torch.as_tensor(q))[0].numpy(),
                               np.asarray(jm.predict(jnp.asarray(q))[0]), atol=2e-3)
    m = ooc.ooc_fit("rbf", *t, p, initial_jitter=1e-3, **kw)
    jm = jooc.ooc_fit("rbf", *j, jp, initial_jitter=1e-3, **kw)
    np.testing.assert_allclose(m.noise[:200].numpy(), noise + 1e-3, rtol=1e-12)
    np.testing.assert_allclose(m.noise.numpy(), np.asarray(jm.noise), rtol=1e-12)
    np.testing.assert_allclose(m.predict(torch.as_tensor(q))[1].numpy(),
                               np.asarray(jm.predict(jnp.asarray(q))[1]), atol=TOL)
    # An indefinite system (negative noise): no rung at all, then the ladder's end.
    bad = [t[0], t[1], torch.full((200,), -5.0, dtype=torch.float64)]
    jbad = [j[0], j[1], jnp.full((200,), -5.0)]
    for fit, args, pp in ((ooc.ooc_fit, bad, p), (jooc.ooc_fit, jbad, jp)):
        with pytest.raises(FloatingPointError, match="even with jitter"):
            fit("rbf", *args, pp, max_jitter_retries=0, **kw)
