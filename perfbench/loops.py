"""The general traffic generator: one closed-loop client driving an
`ObjectModelSession` as a traffic file says.

A traffic file (`traffic/<name>.json`) names its `kind` and gives its
parameters; the configuration file gives the model and the cloud.  A kind
is a file of its own, `kinds/<kind>.py`, found by that name: it defines
`Kind`, a `Loop` that sets the session up and warms it on the cell's own
shapes, serves one request at a time in the window, reads what the program
produced once the window has closed, and compares that with the plain
reference; and `FAULTS`, the faults its timed path can have
(`perfbench.faults`).  A new kind is a new file; nothing here changes.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import math
import os
import time

import numpy as np
import torch

from perfbench.reference import gp as ref

__all__ = ["HERE", "Loop", "kind_module", "make_loop", "sample_points", "normalized", "gap",
           "tf32"]

HERE = os.path.dirname(os.path.abspath(__file__))
_KINDS: dict = {}


def sample_points(cloud, rng, n: int) -> np.ndarray:
    """n world-frame points about the object: half within 5 % of the true
    sphere's radius, half anywhere out to 1.5 radii."""
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    half = n // 2
    r = np.concatenate([rng.uniform(0.95, 1.05, size=half), rng.uniform(0.0, 1.5, size=n - half)])
    return (cloud.center + cloud.radius * r[:, None] * d).astype(np.float32)


def normalized(points_world, frame, device) -> torch.Tensor:
    c, s = frame
    return torch.as_tensor((np.asarray(points_world, np.float64) - c) / s, dtype=torch.float64,
                           device=device)


def gap(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = want.detach().cpu().numpy() if torch.is_tensor(want) else np.asarray(want)
    if got.shape != want.shape or not np.isfinite(got).all():
        return math.inf
    return float(np.abs(got - want).max())


@contextlib.contextmanager
def tf32():
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


class Loop:
    """One cell's client.  `spans` holds host seconds by name, `sizes` the
    problem's sizes for the operation counts (`n` observed rows, `m` queries
    a request), `unit` what a request completes."""

    unit = ""
    control = False  # answers from the control in place of the program's

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from gpis_tpu_torch import ModelConfig

        # SeedSequence takes non-negative integers of any size.
        self.config, self.traffic, self.seed = config, traffic, int(seed) % 2**64
        self.device = torch.device(device)
        self.model = {**config["model"], **traffic.get("model", {})}
        self.model_config = ModelConfig(**self.model)
        self.rng = np.random.default_rng([self.seed, 0])
        self.check_rng = np.random.default_rng([self.seed, 1])
        self.spans: dict[str, list[float]] = {}
        self.session = None
        # Observed rows: values at the cloud and label points, and with
        # normals three gradient components at each cloud point.
        shape = config["cloud"]
        n_rows = shape["n_surface"] + self.model["n_internal"] + self.model["n_external"]
        self.sizes = {"n": n_rows + (3 * shape["n_surface"] if shape.get("normals") else 0)}

    @contextlib.contextmanager
    def span(self, name: str):
        with torch.profiler.record_function("perfbench." + name):
            t0 = time.perf_counter()
            yield
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def normals(self, cloud):
        return cloud.normals if self.config["cloud"].get("normals") else None

    def collect(self):
        """Read what the program holds once the window has closed."""

    def release(self):
        """Drop the program's state so the reference has the card."""
        self.session = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def posterior(self, cloud, *, touches=None, ls=None, noise_scale=1.0, dtype=torch.float64):
        obs, frame = ref.observations(cloud.points, self.model, normals=self.normals(cloud),
                                      touches=touches, dtype=dtype, device=self.device)
        obs.noise = obs.noise * noise_scale
        post = ref.Posterior(obs, self.model["lengthscale"] if ls is None else ls,
                             self.model["signal_variance"])
        return post, frame

    def control_answer(self, cloud, q, **kw):
        """The control's answer at normalized points q: the reference in
        float32 with TF32 products allowed, in the program's place."""
        with tf32():
            try:
                post, _ = self.posterior(cloud, dtype=torch.float32, **kw)
            except FloatingPointError:
                # A factor that fails gives no answer: the control has failed.
                nan = np.full(q.shape[0], np.nan)
                return nan, nan
            m, v = post.predict(q.to(torch.float32))
        return m.double().cpu().numpy(), v.double().cpu().numpy()


def kind_module(kind: str, base: str = HERE):
    """The module of `kinds/<kind>.py` under `base`, loaded once."""
    path = os.path.join(base, "kinds", kind + ".py")
    if path not in _KINDS:
        if not os.path.isfile(path):
            known = sorted(f[:-3] for f in os.listdir(os.path.join(base, "kinds"))
                           if f.endswith(".py") and not f.startswith("_"))
            raise ValueError(f"unknown traffic kind {kind!r}; known: {known}")
        spec = importlib.util.spec_from_file_location("perfbench_kind_" + kind, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _KINDS[path] = mod
    return _KINDS[path]


def make_loop(config: dict, traffic: dict, seed: int, device, base: str = HERE) -> Loop:
    return kind_module(traffic["kind"], base).Kind(config, traffic, seed, device)
