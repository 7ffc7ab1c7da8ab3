"""The port's HTTP service (`api.service.make_server`) against the JAX
package's, on the CPU in float64: the JAX tests' drills
(tests/test_session.py's `test_http_service` and
`test_service_extended_endpoints`) on an ephemeral port, the exploration
routes answering as the JAX session does at BASELINE.md row 2's 1e-6, and
/save -> a new server -> /load -> the replayed /update (tests/test_recovery
.py's service drill)."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)
import torch_jax_native

from gpis_tpu.api.session import ObjectModelSession as JaxSession
from gpis_tpu.config import ExploreConfig as JaxExploreConfig
from gpis_tpu.config import ModelConfig as JaxModelConfig
from gpis_tpu.data import gpis as jgpis
from gpis_tpu.data import synthetic
from gpis_tpu_torch.api.service import make_server
from gpis_tpu_torch.api.session import ObjectModelSession
from gpis_tpu_torch.config import ExploreConfig, ModelConfig

TOL = 1e-6
CFG = dict(kernel="rbf", lengthscale=0.7, noise_surface=1e-5, n_external=32, touch_capacity=128,
           block=64, dtype="float64")
EXPLORE = dict(max_charts=8, n_disc_samples=12, variance_threshold=0.3)


class _Server:
    """A make_server on an ephemeral port, served from a thread."""

    def __init__(self, session):
        self.srv = make_server(session, port=0)
        self.port = self.srv.server_address[1]
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self.thread.start()

    def call(self, path, payload=None):
        url = f"http://127.0.0.1:{self.port}{path}"
        if payload is None:
            with urllib.request.urlopen(url, timeout=60) as r:
                return json.loads(r.read())
        req = urllib.request.Request(url, json.dumps(payload).encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    def error(self, path, payload=None):
        with pytest.raises(urllib.error.HTTPError) as e:
            self.call(path, payload)
        return e.value.code, json.loads(e.value.read())

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


@pytest.fixture()
def server():
    s = _Server(ObjectModelSession(ModelConfig(**CFG), ExploreConfig(**EXPLORE), device="cpu"))
    yield s
    s.close()


def test_http_service(server):
    """The JAX drill: health, start, query, update, a malformed body's 400."""
    assert server.call("/health") == {"ok": True, "fitted": False}
    pts = jgpis.fibonacci_sphere(80, radius=0.5)
    out = server.call("/start", {"points": pts.tolist()})
    jsess = JaxSession(JaxModelConfig(**CFG)).start(pts)
    assert out == {"ok": True, "capacity": jsess.model.capacity}
    assert server.call("/health")["fitted"]
    out = server.call("/query", {"points": [[0.0, 0.0, 0.0]]})
    assert out["mean"][0] < -0.5
    np.testing.assert_allclose((out["mean"], out["var"]), jsess.query([[0.0, 0.0, 0.0]]),
                               atol=TOL)
    assert server.call("/update", {"points": [[0.5, 0.0, 0.0]]}) == {"ok": True, "n_touch": 1}
    code, body = server.error("/query", {"wrong_key": 1})
    assert code == 400 and "error" in body
    assert server.error("/nowhere")[0] == 404


def test_service_extended_endpoints(tmp_path):
    """The JAX drill: /stats, /mesh and /save, loaded into a new session."""
    cfg = ModelConfig(kernel="rbf", lengthscale=0.7, noise_surface=1e-5, n_external=16, block=32,
                      dtype="float64")
    srv = _Server(ObjectModelSession(cfg, device="cpu"))
    try:
        pts = jgpis.fibonacci_sphere(60, radius=0.5)
        assert srv.call("/start", {"points": pts.tolist()})["ok"]
        assert srv.call("/stats")["fit_s"] > 0
        mesh = srv.call("/mesh?resolution=16")
        jsess = JaxSession(JaxModelConfig(**{**CFG, "n_external": 16, "block": 32,
                                             "touch_capacity": 256})).start(pts)
        torch_jax_native.require()  # the JAX soup in its native order
        verts, faces, var = jsess.extract_surface(resolution=16)
        assert len(mesh["verts"]) > 50 and len(mesh["faces"]) > 20
        assert mesh["faces"] == np.asarray(faces).tolist()
        np.testing.assert_allclose(mesh["verts"], np.round(verts, 5), atol=2e-5)
        np.testing.assert_allclose(mesh["variance"], np.round(var, 6), atol=2e-6)
        path = str(tmp_path / "srv_model.npz")
        assert srv.call("/save", {"path": path}) == {"ok": True, "path": path}
        m, _ = ObjectModelSession.load(path, device="cpu").query(np.array([[0.0, 0.0, 0.0]]))
        assert m[0] < -0.5
    finally:
        srv.close()


def test_exploration_routes_answer_as_the_jax_session(server):
    pts, _ = synthetic.partial_sphere_cloud(200, radius=1.0, cap_cos=-0.2, seed=11)
    pts = pts * 0.3 + np.array([2.0, -1.0, 0.5])
    server.call("/start", {"points": pts.tolist()})
    jsess = JaxSession(JaxModelConfig(**CFG), JaxExploreConfig(**EXPLORE)).start(pts)
    for _ in range(2):
        out = server.call("/next_best_path")
        jres = jsess.next_best_path()
        np.testing.assert_allclose(out["path"], np.asarray(jres.path), atol=TOL)
        np.testing.assert_allclose(out["normals"], np.asarray(jres.normals), atol=TOL)
        np.testing.assert_allclose(out["target_variance"], jres.target_variance, atol=TOL)
        assert out["reached_threshold"] == jres.reached_threshold
        assert server.call("/done") == {"done": jsess.is_done()}
        touch = np.asarray(jres.path)[-1:]
        assert server.call("/update", {"points": touch.tolist()})["ok"]
        jsess.update(touch)


def test_service_save_restart_load(tmp_path):
    """/start + /update + /save, the node dies, a fresh node /loads and
    replays the pending /update: the same posterior as a node that never
    stopped."""
    cfg = ModelConfig(kernel="rbf", lengthscale=0.7, noise_surface=1e-5, touch_capacity=16,
                      dtype="float64")
    pts = synthetic.partial_sphere_cloud(200, radius=1.0, cap_cos=-0.2, seed=11)[0].tolist()
    probe = jgpis.fibonacci_sphere(96, radius=1.0).tolist()
    touches = [[[0.0, 0.0, -1.02]], [[0.3, 0.0, -0.95]]]
    path = str(tmp_path / "service.npz")
    srv1 = _Server(ObjectModelSession(cfg, device="cpu"))
    try:
        assert srv1.call("/start", {"points": pts})["ok"]
        assert srv1.call("/update", {"points": touches[0]})["ok"]
        saved = srv1.call("/query", {"points": probe})
        assert srv1.call("/save", {"path": path})["ok"]
    finally:
        srv1.close()  # the crash
    srv2 = _Server(ObjectModelSession(cfg, device="cpu"))
    try:
        out = srv2.call("/load", {"path": path})
        assert out["ok"] and out["n_touch"] == 1 and out["capacity"] > 0
        assert srv2.call("/query", {"points": probe}) == saved
        assert srv2.call("/update", {"points": touches[1]})["n_touch"] == 2
        got = srv2.call("/query", {"points": probe})
    finally:
        srv2.close()
    srv3 = _Server(ObjectModelSession(cfg, device="cpu"))
    try:
        srv3.call("/start", {"points": pts})
        for t in touches:
            srv3.call("/update", {"points": t})
        want = srv3.call("/query", {"points": probe})
    finally:
        srv3.close()
    np.testing.assert_allclose(got["mean"], want["mean"], atol=1e-8)
    np.testing.assert_allclose(got["var"], want["var"], atol=1e-8)


def test_service_refusals(server, monkeypatch):
    """A call before any fit answers 400; /start with experts fits the
    committee (a 200 held to the JAX session, its touches summed over the
    experts, as the JAX node's np.sum does); a mesh session is not
    served."""
    code, body = server.error("/next_best_path")
    assert code == 400 and "no model fitted" in body["error"]
    pts = jgpis.fibonacci_sphere(60, radius=0.5)
    out = server.call("/start", {"points": pts.tolist(), "experts": 4, "expert_gate": 2})
    jsess = JaxSession(JaxModelConfig(**CFG)).start(pts, experts=4, expert_gate=2)
    assert out == {"ok": True, "capacity": jsess.model.capacity}
    probe = pts[:8] * 1.1
    got = server.call("/query", {"points": probe.tolist()})
    np.testing.assert_allclose((got["mean"], got["var"]), jsess.query(probe), atol=TOL)
    touch = [[0.5, 0.0, 0.0], [0.0, 0.0, -0.5]]
    assert server.call("/update", {"points": touch}) == {"ok": True, "n_touch": 2}
    sess = ObjectModelSession(ModelConfig(**CFG), device="cpu")
    monkeypatch.setattr(sess, "mesh", object())
    with pytest.raises(ValueError, match="not a rank of a mesh"):
        make_server(sess)


def test_hyperopt_route(server):
    pts = jgpis.fibonacci_sphere(60, radius=0.5)
    server.call("/start", {"points": pts.tolist()})
    out = server.call("/hyperopt", {"steps": 2})
    assert out["ok"] and np.isfinite(out["mll"]) and out["lengthscale"] > 0


def test_update_answers_a_joint_model_without_touch_slots():
    """The JAX node's /update reads n_touch with np.sum, which fails on a
    joint model without slots (None) after the refit went through; the
    port answers 0 there."""
    cfg = ModelConfig(kernel="rbf", lengthscale=0.7, noise_surface=1e-5, n_external=16,
                      touch_capacity=0, block=32, dtype="float64")
    srv = _Server(ObjectModelSession(cfg, device="cpu"))
    try:
        pts = jgpis.fibonacci_sphere(60, radius=0.5)
        assert srv.call("/start", {"points": pts.tolist(), "normals": pts.tolist()})["ok"]
        assert srv.call("/update", {"points": [[0.5, 0.0, 0.0]]}) == {"ok": True, "n_touch": 0}
    finally:
        srv.close()
