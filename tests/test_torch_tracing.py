"""The port's tracing (`gpis_tpu_torch.utils.profiling`) on the CPU: a span
is a shared no-op while no profiler runs; under one, spans nest, share
their root's request id and land in the Chrome trace with their durations
and on its clock; the instrumented layers' spans and counters (the fit's
jitter attempts, the planner's charts and projections, the optimizer's
forward and pullback); and the benchmark's ten readers of the record
(`perfbench/metrics/`).  One test, marked `cuda`, resolves device spans on
a card and skips without one."""

import glob
import json
import os
import sys
import time
import types

import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)

from gpis_tpu_torch.api.session import ObjectModelSession
from gpis_tpu_torch.config import ExploreConfig, ModelConfig
from gpis_tpu_torch.data import gpis, synthetic
from gpis_tpu_torch.gp import hyperopt as ho
from gpis_tpu_torch.gp import regression as gpr
from gpis_tpu_torch.kernels import functions as kf
from gpis_tpu_torch.linalg import cholesky as lin
from gpis_tpu_torch.utils import profiling
from perfbench import harness

READERS = {  # metric: (the cell's unit, reads a device span)
    "plan_host_ms.explore": ("round", False),
    "plan_wait_ms.explore": ("round", False),
    "syncs_per_round.explore": ("round", False),
    "charts_per_round.explore": ("round", False),
    "project_yield.explore": ("round", False),
    "forward_ms.hyperopt": ("step", True),
    "pullback_ms.hyperopt": ("step", True),
    "syncs_per_step.hyperopt": ("step", False),
    "factor_ms.surface": ("surface", True),
    "fit_attempts.surface": ("surface", False),
}


@pytest.fixture(autouse=True)
def fresh_record():
    """An empty record, and one intra-op thread a test (these sizes gain
    nothing from more, and the suite's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.reset()
    yield
    profiling.reset()
    torch.set_num_threads(n)


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _by_name(snap, name):
    return [s for s in snap["spans"] if s[0] == name]


def _config(**kw):
    return ModelConfig(kernel="rbf", lengthscale=0.7, noise_surface=1e-5, dtype="float64", **kw)


@pytest.fixture(scope="module")
def cloud():
    pts, _ = synthetic.partial_sphere_cloud(150, radius=1.0, cap_cos=-0.2, seed=2)
    return pts


def test_span_is_a_shared_noop_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("touched while no profiler runs")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_Span", refuse)  # no span object is made
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(perf_counter_ns=refuse,
                                                                 time_ns=refuse))
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("a") is profiling.span("b", device=True) is profiling.wait("c")
    blocks = None
    for i in range(2):  # the second pass keeps no block the first did not
        if i:
            blocks = sys.getallocatedblocks()
        for _ in range(1000):
            with profiling.span("a", device=True), profiling.wait("c", 2):
                profiling.count("d")
    assert sys.getallocatedblocks() - blocks < 64

    @profiling.spanned("e")
    def f(x):
        return x + 1

    assert f(2) == 3
    snap = profiling.snapshot()
    assert snap["spans"] == [] and snap["counters"] == {} and snap["anchor"] is None


def test_spans_nest_and_land_in_the_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        for _ in range(2):
            with profiling.span("root"):
                with profiling.span("child"):
                    time.sleep(0.003)
                    with profiling.wait("site", 2):
                        torch.ones(64, 64) @ torch.ones(64, 64)
                profiling.count("things", 3)
        with profiling.span("other"):
            time.sleep(0.002)
    spans_file, = glob.glob(os.path.join(log_dir, "spans.*.json"))
    trace_file, = glob.glob(os.path.join(log_dir, "trace.*.json"))
    assert os.path.basename(spans_file)[len("spans."):] == os.path.basename(trace_file)[
        len("trace."):]
    snap = json.load(open(spans_file))
    names = [s[0] for s in snap["spans"]]
    assert names == ["root", "child", "wait.site"] * 2 + ["other"]
    parents = [s[1] for s in snap["spans"]]
    assert parents == [-1, 0, 1, -1, 3, 4, -1]
    requests = [s[2] for s in snap["spans"]]
    assert requests[:3] == [requests[0]] * 3 and requests[3:6] == [requests[3]] * 3
    assert len({requests[0], requests[3], requests[6]}) == 3
    assert snap["counters"] == {"things": 6, "sync.site": 4}
    assert all(s[3] <= s[4] for s in snap["spans"])
    assert snap["device_ms"] == [None] * 7
    # Each span's user_annotation event, on the trace's clock.
    chrome = json.load(open(trace_file))
    base = chrome["baseTimeNanoseconds"]
    events = sorted((e for e in chrome["traceEvents"] if e.get("cat") == "user_annotation"
                     and e.get("name", "").startswith("gpis.")), key=lambda e: e["ts"])
    assert [e["name"] for e in events] == ["gpis." + n for n in names]
    unix0, perf0 = snap["anchor"]
    for i, (s, e) in enumerate(zip(snap["spans"], events)):
        assert abs((s[4] - s[3]) * 1e-3 - e["dur"]) < 2000.0, (s, e)  # µs
        if i:
            assert abs(unix0 + (s[3] - perf0) - (base + 1e3 * e["ts"])) < 2e6, (s, e)


@pytest.mark.parametrize("route", ["fit", "fit_inference"])
def test_fit_attempts_count_the_jitter_ladder(route, cloud, monkeypatch):
    ts = gpis.build_training_set(cloud, _config(), device="cpu")
    params = kf.kernel_params(0.7, 1.0)
    calls = []

    def nan_first(a):
        l = real(a)
        calls.append(1)
        if len(calls) == 1:
            l.diagonal().fill_(float("nan"))
        return l

    def attempts(**kw):
        profiling.reset()
        with _profiled():
            if route == "fit":
                gpr.fit("rbf", ts.x, ts.y, ts.noise, params, touch_capacity=0, **kw)
            else:
                gpr.fit_inference("rbf", ts.x, ts.y, ts.noise, params)
        snap = profiling.snapshot()
        assert len(_by_name(snap, "fit.attempt")) == snap["counters"]["fit.attempts"]
        assert snap["counters"]["sync.fit.nan_check"] == snap["counters"]["fit.attempts"]
        return snap["counters"]["fit.attempts"]

    real = lin.cholesky
    assert attempts() == 1
    if route == "fit":
        assert attempts(chol_impl=nan_first) == 2
    else:
        monkeypatch.setattr(lin, "cholesky", nan_first)
        assert attempts() == 2


def test_planner_counts_its_charts_and_projections(cloud):
    s = ObjectModelSession(_config(touch_capacity=128), ExploreConfig(max_charts=8,
                                                                     variance_threshold=2.0),
                           device="cpu")
    s.start(cloud)
    with _profiled():
        res = s.next_best_path()
    snap = profiling.snapshot()
    c = snap["counters"]
    assert len(res.charts) > 1 and c["plan.charts"] == len(res.charts) - 1
    assert c["project.tried"] >= c["plan.charts"]
    root, = _by_name(snap, "session.next_best_path")
    assert root[1] == -1
    for name in ("plan.seed", "plan.candidates", "plan.score", "plan.chart", "plan.path"):
        got = _by_name(snap, name)
        assert got and all(sp[2] == root[2] for sp in got), name
    assert len(_by_name(snap, "plan.chart")) == c["project.tried"]
    assert c["sync.project.active"] == len(_by_name(snap, "wait.project.active"))


@pytest.mark.parametrize("optimizer", ["adam", "lbfgs"])
def test_optimizer_steps_split_forward_and_pullback(optimizer, cloud):
    ts = gpis.build_training_set(cloud[:60], _config(), device="cpu")
    xp, yp, noisep = gpr.pad_training(ts.x, ts.y, ts.noise, 128, 1e12)
    with _profiled():
        ho.optimize("rbf", xp, yp, noisep, kf.kernel_params(0.7, 1.0), n_real=ts.x.shape[0],
                    steps=2, optimizer=optimizer)
    snap = profiling.snapshot()
    steps = _by_name(snap, "hyperopt.step")
    fwd, back = _by_name(snap, "hyperopt.forward"), _by_name(snap, "hyperopt.pullback")
    assert len(steps) == 2
    if optimizer == "adam":
        assert len(fwd) == len(back) == 2
    else:  # each step's line search evaluates the loss again
        assert len(fwd) == len(back) >= 2
    for sp in fwd + back:
        assert snap["spans"][sp[1]][0] == "hyperopt.step" and sp[2] in {s[2] for s in steps}
    assert snap["device_ms"] == [None] * len(snap["spans"])  # no card


def _window(cloud):
    """One recorded CPU window with each cell's work: a surface, an
    optimizer call and an exploration round."""
    grid = ObjectModelSession(_config(touch_capacity=0), device="cpu")
    explore = ObjectModelSession(_config(touch_capacity=128), ExploreConfig(max_charts=6),
                                 device="cpu")
    explore.start(cloud)
    with _profiled():
        grid.start(cloud)
        grid.evaluate_grid(8)
        grid.optimize_hyperparameters(steps=2)
        res = explore.next_best_path()
        explore.update(res.path[-2:])


def test_readers_of_the_record(cloud):
    runs = {u: harness.Run(unit=u, units=2) for u in ("round", "step", "surface")}
    for name in READERS:  # nothing recorded
        assert harness.read_metric(name, runs[READERS[name][0]]) is None, name
    _window(cloud)
    for name, (unit, device) in READERS.items():
        got = harness.read_metric(name, runs[unit])
        if device:  # no card: no device milliseconds
            assert got is None, name
        else:
            assert got is not None and got["value"] >= 0, name
        assert harness.read_metric(name, harness.Run(unit="other", units=2)) is None, name
    snap = profiling.snapshot()
    host, waited = (harness.read_metric(n, runs["round"])["value"]
                    for n in ("plan_host_ms.explore", "plan_wait_ms.explore"))
    root, = _by_name(snap, "session.next_best_path")
    assert (host + waited) * 2 == pytest.approx((root[4] - root[3]) * 1e-6)
    assert waited > 0
    # Two starts (the optimizer's refit is no start), one attempt each.
    assert harness.read_metric("fit_attempts.surface", runs["surface"])["value"] == 1.0
    assert harness.read_metric("project_yield.explore", runs["round"])["value"] > 0


@pytest.mark.cuda
def test_device_spans_resolve_on_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device spans time the card's stream")
    a = torch.randn(2048, 2048, device="cuda")
    with torch.profiler.profile():
        with profiling.span("work", device=a.device):
            for _ in range(8):
                a = a @ a / 2048.0
        with profiling.span("idle", device=True):
            pass
        a = torch.randn(4096, 4096, device="cuda")
        k = a @ a.T + 4096 * torch.eye(4096, device="cuda")
        lin.cholesky(k)
    snap = profiling.snapshot()
    ms = dict(zip([s[0] for s in snap["spans"]], snap["device_ms"]))
    assert ms["work"] > ms["idle"] >= 0.0 and ms["chol.factor"] > 0.0
    assert snap["counters"]["chol.panels"] == 16 and snap["counters"]["sync.potrf"] == 16
    assert sum(v is not None for v in snap["device_ms"]) == 3
