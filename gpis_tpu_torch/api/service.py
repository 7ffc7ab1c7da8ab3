"""JSON service over HTTP (port of gpis_tpu/api/service.py): the `.srv`
surface a robot stack drives, start-process / get-next-best-path / update,
on the stdlib's ThreadingHTTPServer, one lock serializing the calls on one
session, as the node's spin loop did.

    POST /start     {"points": [[x,y,z],...], "normals"?, "out_of_core"?, "experts"?,
                     "expert_gate"?}                   -> {"ok", "capacity"}
    POST /query     {"points": [[x,y,z],...]}          -> {"mean": [...], "var": [...]}
    POST /update    {"points": [[x,y,z],...]}          -> {"ok": true, "n_touch": k}
    POST /save      {"path": p}                        -> {"ok": true, "path": p}
    POST /load      {"path": p}                        -> {"ok", "capacity", "n_touch"}
    POST /hyperopt  {"steps"?, "method"?, "learn_*"?}  -> {"ok", "mll", "lengthscale"}
    GET  /next_best_path  -> {"path", "normals", "target_variance", "reached_threshold"}
    GET  /done            -> {"done": bool}
    GET  /stats           -> the session's stage timings
    GET  /mesh?resolution=R  -> {"verts", "faces", "variance"}
    GET  /health          -> {"ok": true, "fitted": bool}

A failing call answers 400 with {"error": message} (an unknown path 404).
`/start` with `experts` fits a committee (gated to `expert_gate` nearest
experts); `/update` and `/load` answer its touches summed over the experts.
The service serves one session on one device; a session on a mesh is not
served.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from gpis_tpu_torch.api.session import ObjectModelSession
from gpis_tpu_torch.utils.logging import get_logger

__all__ = ["serve", "make_server"]

log = get_logger("service")


def _n_touch(model) -> int:
    """Touches held by the model: its touch slots' count (a committee's
    summed over its experts), or an out-of-core model's tail."""
    n = getattr(model, "n_touch", None)
    return int(np.sum(getattr(model, "n_tail", 0) if n is None else n))


def make_server(session: ObjectModelSession, host: str = "127.0.0.1", port: int = 8731):
    """A ThreadingHTTPServer serving `session` (port 0: an ephemeral port,
    read back from `server_address`).  The caller runs `serve_forever`."""
    if session.mesh is not None:
        raise ValueError("the service serves one session on one device, not a rank of a mesh")
    lock = threading.Lock()  # one model: service calls are serialized

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def log_message(self, fmt, *args):  # route through structured logging
            log.info("%s %s", self.address_string(), fmt % args)

        def do_GET(self):
            try:
                with lock:
                    if self.path == "/health":
                        self._send(200, {"ok": True, "fitted": session.model is not None})
                    elif self.path == "/next_best_path":
                        res = session.next_best_path()
                        self._send(200, {
                            "path": res.path.tolist(),
                            "normals": res.normals.tolist(),
                            "target_variance": res.target_variance,
                            "reached_threshold": res.reached_threshold,
                        })
                    elif self.path == "/done":
                        self._send(200, {"done": session.is_done()})
                    elif self.path == "/stats":
                        self._send(200, dict(session.stats))
                    elif self.path == "/mesh" or self.path.startswith("/mesh?"):
                        qs = parse_qs(urlparse(self.path).query)
                        res_ = int(qs.get("resolution", ["32"])[0])
                        verts, faces, var = session.extract_surface(resolution=res_)
                        self._send(200, {
                            "verts": np.round(verts, 5).tolist(),
                            "faces": faces.tolist(),
                            "variance": np.round(var, 6).tolist(),
                        })
                    else:
                        self._send(404, {"error": f"unknown path {self.path}"})
            except Exception as e:  # noqa: BLE001 -- the service boundary answers every call
                log.exception("GET %s failed", self.path)
                self._send(400, {"error": str(e)})

        def do_POST(self):
            try:
                req = self._body()
                with lock:
                    if self.path == "/start":
                        kw = {}
                        if req.get("normals") is not None:
                            kw["normals"] = np.asarray(req["normals"], np.float64)
                        if req.get("out_of_core"):
                            kw["out_of_core"] = True
                        if req.get("experts"):
                            kw["experts"] = int(req["experts"])
                            kw["expert_gate"] = int(req.get("expert_gate", 0))
                        session.start(np.asarray(req["points"], np.float64), **kw)
                        self._send(200, {"ok": True, "capacity": session.model.capacity})
                    elif self.path == "/query":
                        mean, var = session.query(np.asarray(req["points"], np.float64))
                        self._send(200, {"mean": mean.tolist(), "var": var.tolist()})
                    elif self.path == "/update":
                        session.update(np.asarray(req["points"], np.float64))
                        self._send(200, {"ok": True, "n_touch": _n_touch(session.model)})
                    elif self.path == "/save":
                        session.save(req["path"])
                        self._send(200, {"ok": True, "path": req["path"]})
                    elif self.path == "/load":
                        # Crash recovery: a /save checkpoint into this
                        # (possibly fresh) node, which then serves from it.
                        session.restore(req["path"])
                        self._send(200, {"ok": True, "capacity": int(session.model.capacity),
                                         "n_touch": _n_touch(session.model)})
                    elif self.path == "/hyperopt":
                        kw = {"steps": int(req.get("steps", 100))}
                        if req.get("method"):
                            kw["method"] = str(req["method"])
                        for flag in ("learn_noise", "learn_noise_g", "learn_signal"):
                            if flag in req:
                                kw[flag] = bool(req[flag])
                        res = session.optimize_hyperparameters(**kw)
                        self._send(200, {"ok": True, "mll": res.mll,
                                         "lengthscale": float(res.params["lengthscale"])})
                    else:
                        self._send(404, {"error": f"unknown path {self.path}"})
            except Exception as e:  # noqa: BLE001 -- the service boundary answers every call
                log.exception("POST %s failed", self.path)
                self._send(400, {"error": str(e)})

    return ThreadingHTTPServer((host, port), Handler)


def serve(session: ObjectModelSession, host: str = "127.0.0.1", port: int = 8731):
    """Serve `session` until interrupted."""
    srv = make_server(session, host, port)
    log.info("serving on http://%s:%d", host, port)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()
    finally:
        srv.server_close()
