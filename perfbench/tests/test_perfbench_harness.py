"""The harness on the CPU: a new configuration, traffic mix, traffic kind and
metric are new files only; the import guard; the refusals; the trace's
arithmetic."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness, loops, trace

ROOT = os.path.dirname(harness.HERE)

# A traffic kind of its own, as a later PR would add it: one started model,
# each request a batch of seeded points queried, checked against the
# reference.
QUERY_KIND = '''
import math

import numpy as np

from perfbench import clouds
from perfbench.loops import Loop, gap, normalized, sample_points


class Kind(Loop):
    unit = "batch"

    def setup(self):
        from gpis_tpu_torch import ObjectModelSession

        self.cloud = clouds.make_cloud(self.config["cloud"], self.rng)
        self.session = ObjectModelSession(self.model_config, device=self.device)
        self.session.start(self.cloud.points)
        self.sizes["m"] = self.traffic["points"]
        self.batches = []

    def request(self):
        q = sample_points(self.cloud, self.rng, self.traffic["points"])
        self.batches.append((q, self.session.query(q)))
        return 1

    def compare(self):
        if not self.batches:
            return {"mean_gap": math.inf}
        q, (mean, _) = self.batches[-1]
        post, frame = self.posterior(self.cloud)
        return {"mean_gap": gap(mean, post.predict(normalized(q, frame, self.device))[0])}


FAULTS = {}
'''


def test_a_new_cell_needs_only_new_files(tmp_path):
    """Copy the benchmark, add a configuration, two traffic mixes (one of a
    new kind), their limits and a per-layer metric as new files and
    BENCHMARK.json entries, and run the new cells: no file that was there is
    edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "value20k.json").read_text())
    cfg.update(name="tiny", cloud=dict(cfg["cloud"], n_surface=384))
    (pb / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "coarse.json").write_text(json.dumps(
        {"kind": "surface", "clouds": 2, "axes": [0.8, 1.0], "resolution": 8,
         "check": {"surfaces": 2, "points": 64}}))
    (pb / "limits" / "tiny.coarse.json").write_text(json.dumps({"mean_gap": 1e-3,
                                                                 "var_gap": 1e-3}))
    (pb / "kinds" / "query.py").write_text(QUERY_KIND)
    (pb / "traffic" / "points.json").write_text(json.dumps({"kind": "query", "points": 64}))
    (pb / "limits" / "tiny.points.json").write_text(json.dumps({"mean_gap": 1e-3}))
    (pb / "metrics" / "surfaces_done.coarse.py").write_text(
        "def read(run):\n    return run.units if run.unit == 'surface' else None\n")
    bench["configs"].append({"name": "tiny", "source": "https://example.org", "reduced": [],
                             "file": "perfbench/configs/tiny.json", "why": "test"})
    bench["workloads"].append({"name": "tiny.coarse", "config": "tiny", "traffic": "coarse",
                               "chips": 1, "why": "test"})
    bench["workloads"].append({"name": "tiny.points", "config": "tiny", "traffic": "points",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "batches_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["tiny.points"]})
    (pb / "metrics" / "batches_per_s.py").write_text(
        "def read(run):\n    return run.units / run.window_s if run.unit == 'batch' else None\n")
    for m in bench["end_to_end"]:
        if m["name"] == "surface_s":
            m["workloads"].append("tiny.coarse")
    bench["per_layer"].append({"name": "surfaces_done.coarse", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "session",
                               "moves": "surface_s", "workloads": ["tiny.coarse"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = harness.cell_spec(harness.load_bench(str(root)), "tiny.coarse", base=str(pb))
    for with_trace, names in ((False, {"surface_s", "peak_mem_gb", "setup_s"}),
                              (True, {"surfaces_done.coarse"})):
        result, compared, run = harness.run_cell(
            spec, 2**31 + 77, 0.5, with_trace, device="cpu", t_process=time.perf_counter(),
            base=str(pb), bench=harness.load_bench(str(root)))
        assert result["correct"], compared
        assert set(result["metrics"]) == names - {"peak_mem_gb"}  # no card: no peak
    assert result["metrics"]["surfaces_done.coarse"]["value"] == run.units
    spec = harness.cell_spec(harness.load_bench(str(root)), "tiny.points", base=str(pb))
    result, compared, run = harness.run_cell(
        spec, 5, 0.3, False, device="cpu", t_process=time.perf_counter(), base=str(pb),
        bench=harness.load_bench(str(root)))
    assert result["correct"], compared
    assert set(result["metrics"]) == {"batches_per_s", "setup_s"}
    assert run.unit == "batch" and run.units >= 1
    assert all(p.read_bytes() == b for p, b in before.items())


def test_an_unknown_kind_names_the_known_ones():
    with pytest.raises(ValueError, match="'explore', 'hyperopt', 'surface'"):
        loops.make_loop({}, {"kind": "nothing"}, 1, "cpu")


def test_guard_catches_the_jax_package_and_lets_the_port_through():
    mods = {"gpis_tpu_torch": 1, "gpis_tpu_torch.gp": 1, "numpy": 1}
    assert harness.forbidden_modules(mods) == []
    mods.update({"gpis_tpu": 1, "gpis_tpu.gp.regression": 1, "jaxlib.xla": 1, "jax_extra": 1})
    assert harness.forbidden_modules(mods) == ["gpis_tpu", "gpis_tpu.gp.regression", "jaxlib.xla"]


def _run(cwd, *args):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "perfbench/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_run_refuses_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    got = _run(ROOT, "--workload", "value20k.grid", "--seed", "1", "--seconds", "1")
    assert got.returncode != 0 and got.stdout == ""


def test_run_fails_beside_no_package(tmp_path):
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    got = _run(tmp_path, "--workload", "value20k.grid", "--seed", "1", "--seconds", "1")
    assert got.returncode != 0 and got.stdout == ""


def test_trace_busy_idle_and_gaps():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_SPAN, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.start", "ts": 0, "dur": 60},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 45, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "void gpis::cov_kernel<float, 0>(float const*)",
         "ts": 10, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "void gpis::tc::tc_kernel<1, 3, gpis::tc::TmaB>()",
         "ts": 20, "dur": 30},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 90, "dur": 20},
        {"ph": "X", "cat": "gpu_user_annotation", "name": trace.WINDOW_SPAN, "ts": 0, "dur": 100},
    ]
    t = trace.Trace(ev)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(50e-6)  # [10, 50] and [90, 100]
    assert t.kernel_s["gpis::cov_kernel<float, 0>"] == pytest.approx(30e-6)
    assert t.kernel_s["gpis::tc::tc_kernel<1, 3, gpis::tc::TmaB>"] == pytest.approx(30e-6)
    # Gaps: [0, 10] under start with no op, [50, 90] with its middle (70)
    # outside every span and op.
    assert t.gaps["start > python"] == pytest.approx(10e-6)
    assert t.gaps["between requests > python"] == pytest.approx(40e-6)
    t = trace.Trace(ev + [{"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 2,
                           "dur": 6}])
    assert t.gaps["start > aten::item"] == pytest.approx(10e-6)


def test_shared_readers_of_the_trace():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_SPAN, "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 30}]
    run = harness.Run(trace=trace.Trace(ev), unit="round", units=3)
    assert trace.idle_share(run) == pytest.approx(70.0)
    assert trace.busy_ms_per(run, "round") == pytest.approx(1e3 * 30e-6 / 3)
    assert trace.busy_ms_per(run, "step") is None
    for name in ("idle_share.explore", "round_busy_ms.explore"):
        assert harness.read_metric(name, run)["value"] > 0
    assert harness.read_metric("idle_share.surface", harness.Run(trace=None)) is None
