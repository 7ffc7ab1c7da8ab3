"""The port's command line (`gpis_tpu_torch.cli.main`, `--device cpu`)
against the JAX package's (`gpis_tpu.cli.main`), verb for verb on the same
150-point cloud in float64 (a `--config` JSON), after
tests/test_viz_cli.py's end-to-end drive: the `query` lines, the
`explore --json` path, the `mesh` PLY's vertices in order, `hyperopt`'s
`mll=` and its saved hyperparameters, each checkpoint loaded by the other
package's CLI; then the refusals (a mesh config without a process
group), the console entry as a subprocess, and the out-of-core and
committee fits.

Tolerance: 1e-6 (BASELINE.md row 2) on the numbers as printed, each
rounded to its last printed digit (six decimals; `mll=` four, so its
checkpoint's hyperparameters are held at 1e-6 as well)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)
import torch_jax_native

from gpis_tpu.cli.main import main as jax_main
from gpis_tpu_torch.cli.main import main as torch_main
from gpis_tpu_torch.data.gpis import fibonacci_sphere

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6
FIT = ["--lengthscale", "0.7", "--noise", "1e-5", "--config", "cfg.json"]


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for the module: these sizes gain nothing from
    more, and the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The cloud (with normals), the touches and the float64 config."""
    d = tmp_path_factory.mktemp("cli")
    pts = fibonacci_sphere(150, radius=0.5) + np.array([1.0, 0.0, 0.0])
    np.savez(d / "cloud.npz", points=pts)
    np.savez(d / "cloudn.npz", points=pts, normals=(pts - np.array([1.0, 0.0, 0.0])) / 0.5)
    np.savez(d / "touch.npz", points=pts[:3] * 1.0)
    (d / "cfg.json").write_text(json.dumps({"model": {"dtype": "float64"}}))
    (d / "mesh.json").write_text(json.dumps({"model": {"dtype": "float64"},
                                             "mesh": {"n_devices": 2}}))
    return d


def _run(main, argv, capsys, device: bool):
    """One CLI call; returns its standard output."""
    assert main(argv + (["--device", "cpu"] if device else [])) == 0
    return capsys.readouterr().out


def _both(argv_for, capsys):
    """(JAX output, port output) of one verb, each package on its own files
    ("j" or "t" prefixed)."""
    return (_run(jax_main, argv_for("j"), capsys, False),
            _run(torch_main, argv_for("t"), capsys, True))


def _printed(a, b, tol=TOL):
    """Numbers printed to a grid of `tol` that were within `tol` before
    printing land at most one grid step apart."""
    np.testing.assert_array_less(np.abs(np.asarray(a, float) - np.asarray(b, float)),
                                 tol * (1 + 1e-6))


def _query_numbers(out):
    rows = []
    for line in out.strip().splitlines():
        xyz, f, var = line.split()
        rows.append([*map(float, xyz.split(",")), float(f[2:]), float(var[4:])])
    return np.array(rows)


def _ply(path):
    """(vertex rows, face lines) of an ASCII PLY."""
    lines = open(path).read().splitlines()
    nv = int(next(ln for ln in lines if ln.startswith("element vertex")).split()[-1])
    body = lines[lines.index("end_header") + 1:]
    return np.array([[float(v) for v in ln.split()] for ln in body[:nv]]), body[nv:]


def test_cli_both_ways(workdir, capsys, monkeypatch):
    monkeypatch.chdir(workdir)
    torch_jax_native.require()  # the JAX soup in its native order
    for p in ("j", "t"):
        main = jax_main if p == "j" else torch_main
        out = _run(main, ["fit", "cloud.npz", "-o", f"{p}.npz", *FIT], capsys, p == "t")
        assert out.startswith(f"model saved to {p}.npz (capacity ")

    jout, tout = _both(lambda p: ["mesh", f"{p}.npz", "-o", f"{p}.ply", "--resolution", "24",
                                  "--extent", "1.4", "--html", f"{p}.html"], capsys)
    assert jout.replace("j.", "t.") == tout
    jv, jf = _ply("j.ply")
    tv, tf = _ply("t.ply")
    assert jf == tf and len(jv) > 100
    _printed(jv[:, :3], tv[:, :3])
    np.testing.assert_array_less(np.abs(jv[:, 3:] - tv[:, 3:]), 1.5)  # colors, 0-255
    assert "gpis-tpu viewer" in open("t.html").read()

    q = ["--points", "1,0,0;3,3,3;1.2,0.1,-0.3;1.5,0,0"]
    jout, tout = _both(lambda p: ["query", f"{p}.npz", *q], capsys)
    jq, tq = _query_numbers(jout), _query_numbers(tout)
    assert tq[0, 3] < -0.5 and tq[1, 4] > 0.5  # inside the sphere; far from it
    _printed(jq[:, :4], tq[:, :4])
    np.testing.assert_allclose(tq[:, 4], jq[:, 4], rtol=1e-6, atol=1e-12)
    # Each package's CLI reads the other's checkpoint.
    assert _run(torch_main, ["query", "j.npz", *q], capsys, True) == tout
    assert _run(jax_main, ["query", "t.npz", *q], capsys, False) == jout

    jout, tout = _both(lambda p: ["explore", f"{p}.npz", "--max-charts", "8", "--json"], capsys)
    jres, tres = json.loads(jout), json.loads(tout)
    assert len(tres["path"]) >= 1 and tres["reached_threshold"] == jres["reached_threshold"]
    for key in ("path", "normals", "target_variance"):
        np.testing.assert_allclose(tres[key], jres[key], atol=TOL)
    text = _run(torch_main, ["explore", "t.npz", "--max-charts", "8"], capsys, True)
    assert text.startswith(f"path with {len(tres['path'])} poses")

    jout, tout = _both(lambda p: ["update", f"{p}.npz", "touch.npz", "-o", f"{p}2.npz"], capsys)
    assert jout.replace("j2", "t2") == tout
    jout, tout = _both(lambda p: ["query", f"{p}2.npz", *q], capsys)
    _printed(_query_numbers(jout)[:, :4], _query_numbers(tout)[:, :4])

    jout, tout = _both(lambda p: ["explore-viz", f"{p}.npz", "-o", f"{p}v.html",
                                  "--resolution", "16"], capsys)
    assert jout.replace("jv.", "tv.") == tout
    payload = open("tv.html").read()
    assert '"charts": [{"center"' in payload and '"path": [[' in payload


def test_cli_hyperopt_both_ways(workdir, capsys, monkeypatch):
    monkeypatch.chdir(workdir)
    args = ["--steps", "5", "--normals", "--learn-noise-g", "--learn-signal", *FIT]
    jout, tout = _both(lambda p: ["hyperopt", "cloudn.npz", "-o", f"{p}3.npz", *args], capsys)
    assert "mll=" in tout and os.path.exists("t3.npz")
    jmll, tmll = (float(o.split("mll=")[1].split()[0]) for o in (jout, tout))
    _printed(jmll, tmll, 1e-4)
    assert tout.split()[1] == jout.split()[1]  # lengthscale=, four decimals
    with np.load("j3.npz") as jd, np.load("t3.npz") as td:
        for key in ("param_lengthscale", "param_signal_variance", "alpha"):
            np.testing.assert_allclose(td[key], jd[key], rtol=TOL, atol=TOL)


def test_cli_refusals(workdir, capsys, monkeypatch):
    monkeypatch.chdir(workdir)
    # A mesh config needs the caller's process group (the fit itself,
    # --normals too, is tests/test_torch_sharded_joint.py's, on two ranks).
    with pytest.raises(RuntimeError, match="torch.distributed is not initialized"):
        torch_main(["fit", "cloudn.npz", "-o", "m.npz", "--normals", "--config", "mesh.json",
                    "--device", "cpu"])
    with pytest.raises(SystemExit, match="no normals"):
        torch_main(["fit", "cloud.npz", "-o", "m.npz", "--normals", "--device", "cpu"])
    with pytest.raises(SystemExit, match="not found"):
        torch_main(["query", "missing.npz", "--points", "0,0,0"])


def test_cli_console_entry_and_fit_kinds(workdir, capsys, monkeypatch):
    """`python -m gpis_tpu_torch.cli.main` in a subprocess (no jax imported
    there), and the out-of-core and committee fits, each checkpoint queried
    by both CLIs."""
    monkeypatch.chdir(workdir)
    q = ["--points", "1,0,0;1.5,0,0"]
    outs = {}
    for extra, name in ((["--out-of-core"], "o"), (["--experts", "2", "--expert-gate", "1"], "e")):
        _run(torch_main, ["fit", "cloud.npz", "-o", f"{name}.npz", *FIT, *extra], capsys, True)
        outs[name] = _run(torch_main, ["query", f"{name}.npz", *q], capsys, True)
        assert _run(jax_main, ["query", f"{name}.npz", *q], capsys, False) == outs[name]
    assert os.path.isfile("o.npz.w/manifest.json")
    code = ("import sys; from gpis_tpu_torch.cli.main import main; rc = main(sys.argv[1:]); "
            "assert 'jax' not in sys.modules; sys.exit(rc)")
    proc = subprocess.run([sys.executable, "-c", code, "query", "o.npz", *q, "--device", "cpu"],
                          capture_output=True, text=True, cwd=workdir, timeout=120,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == outs["o"]
    proc = subprocess.run([sys.executable, "-m", "gpis_tpu_torch.cli.main", "-h"],
                          capture_output=True, text=True, cwd=workdir, timeout=120,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0 and "explore-viz" in proc.stdout
