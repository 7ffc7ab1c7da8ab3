"""The benchmark's four-rank cell, `sharded147k.grid`, on the CPU: its kind
(`perfbench/kinds/surface_sharded.py`), its plain banded reference
(`perfbench/reference/banded.py`) and what the cell reads of the sharded
session (`linalg/sharded.py`'s spans and counters, `start` dropping the
old model's bands before it fits).

The kind runs through `harness.run_cell` at a tiny override of the cell
(C 4,096, a 16^3 grid, float64, 512 check points): this process is rank
3 and starts ranks 0-2 itself, on gloo.  The session's spans are read at
P = 2 from ranks spawned by `tests/torch_ranks.py`.
"""

import contextlib
import time

import numpy as np
import pytest
import torch
import torch_exp_warm  # noqa: F401 -- warms torch.exp before any test (see the module)
from torch_ranks import spawn_ranks

from perfbench import faults, harness, loops
from perfbench.reference import banded
from perfbench.reference import gp as ref

CELL = "sharded147k.grid"
C = 4096


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread for the module (the ranks it starts inherit it):
    the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec():
    spec = harness.cell_spec(harness.load_bench(harness.os.path.dirname(harness.HERE)), CELL)
    model = spec["config"]["model"]
    spec["config"]["cloud"]["n_surface"] = C - model["n_internal"] - model["n_external"]
    model["dtype"] = "float64"
    spec["traffic"]["resolution"] = 16
    spec["traffic"]["check"]["points"] = 512
    return spec


@pytest.mark.parametrize("fault", [None, *loops.kind_module("surface_sharded").FAULTS])
def test_the_cell_is_correct_and_catches_each_fault(fault):
    """Sound: correct, and the mesh session within 1e-6 of the banded
    reference in float64; each fault, `ring_short` among them, planted in
    every rank: not correct."""
    spec = _spec()
    planted = faults.planted(fault, "surface_sharded") if fault else contextlib.nullcontext()
    with planted:
        result, compared, run = harness.run_cell(spec, 2**33 + 11, 0.0, False, device="cpu",
                                                 t_process=time.perf_counter())
    assert result["attempted"] == 1 and result["failed"] == 0
    assert result["correct"] == (fault is None), compared
    if fault is None:
        assert run.readings["mean_gap"] < 1e-6 and run.readings["var_gap"] < 1e-6, run.readings
        assert run.sizes["band"] == (3 * C // 4, C) and run.sizes["c"] == C


def test_the_kind_plants_surface_faults_and_the_exchange_fault():
    assert set(loops.kind_module("surface_sharded").FAULTS) == {*faults.NAMES, "ring_short"}


def test_banded_reference_matches_the_dense_factor_and_posterior():
    model = _spec()["config"]["model"]
    rng = np.random.default_rng(5)
    cloud = ref.fibonacci_sphere(1000 - 128) * rng.uniform(0.75, 1.0, size=3)
    obs, _ = ref.observations(cloud, model)
    post = banded.BandedPosterior(obs, model["lengthscale"], model["signal_variance"],
                                  ["cpu"] * 4, block=64)
    assert post.edges == [0, 256, 512, 768, 1000]
    chol = torch.linalg.cholesky(obs.gram(model["lengthscale"], model["signal_variance"]))
    for band, r0, r1 in zip(post.bands, post.edges, post.edges[1:]):
        assert torch.allclose(torch.tril(band, diagonal=r0), chol[r0:r1, :r1], rtol=0,
                              atol=1e-10)
    q = torch.as_tensor(rng.uniform(-1.5, 1.5, size=(300, 3)))
    mean, var = post.predict(q, rows=128)
    want_mean, want_var = ref.Posterior(obs, model["lengthscale"],
                                        model["signal_variance"]).predict(q)
    assert torch.allclose(mean, want_mean, rtol=0, atol=1e-10)
    assert torch.allclose(var, want_var, rtol=0, atol=1e-10)


def test_banded_reference_refuses_an_indefinite_gram():
    model = _spec()["config"]["model"]
    obs, _ = ref.observations(ref.fibonacci_sphere(200), model)
    obs.noise = obs.noise * 0.0 - 1.0
    with pytest.raises(FloatingPointError, match="block column 0"):
        banded.BandedPosterior(obs, model["lengthscale"], model["signal_variance"], ["cpu"] * 2,
                               block=64)


def _expected_bytes(rank, p, c, block, n_points, m, elt=8, chunk=8192):
    """The payload this rank puts into the collectives of a float64 `start`
    (rank 0's cloud broadcast, the factor's block rows and diagonal blocks,
    the ladder's NaN test, W's row panels, alpha) and of the grid (each
    chunk's P ring hops of (queries, 3 coordinates + quad), then the mean
    and variance all-gathered)."""
    rows = c // p
    total = 8 + 3 * n_points * elt if rank == 0 else 0
    for j0 in range(0, c, block):
        if j0 // rows == rank:
            total += (block * j0 + block * block + block * c) * elt
    total += elt + c * elt
    for a in range(0, m, chunk):
        per = -(-min(chunk, m - a) // p)
        total += p * per * 4 * elt + 2 * per * elt
    return total


def test_mesh_session_spans_counters_and_one_model_a_rank(tmp_path):
    """P = 2: a second start fits with no band of the first model alive;
    under a profiler the sharded path records its spans, waits and
    counters, and `comm.bytes` is the payload of every collective."""
    p, block, res, n_external = 2, 64, 16, 31
    rng = np.random.default_rng(3)
    first = ref.fibonacci_sphere(480) * rng.uniform(0.75, 1.0, size=3)
    second = ref.fibonacci_sphere(480) * rng.uniform(0.75, 1.0, size=3) + 0.5
    outs = spawn_ranks("torch_sharded_cell_rank.py", [], p,
                       dict(first=first, second=second, resolution=res, block=block,
                            n_external=n_external), tmp_path)
    for rank, out in enumerate(outs):
        assert out["old_alive"].tolist() == [False]
        assert out["forbidden"].size == 0
        assert {"shard.gram", "shard.factor", "shard.linv", "shard.hop", "comm.bcast",
                "comm.all_reduce", "comm.all_gather", "comm.ring", "wait.shard.potrf",
                "wait.shard.ring"} <= set(out["spans"].tolist())
        counters = dict(zip(out["counter_names"].tolist(), out["counter_values"].tolist()))
        c = int(out["capacity"])
        assert c == 512
        assert counters["fit.attempts"] == 1
        assert counters["shard.panels"] == counters["sync.shard.potrf"] == c // block
        assert counters["shard.hops"] == counters["sync.shard.ring"] == p
        assert counters["comm.bytes"] == _expected_bytes(rank, p, c, block, len(first), res**3)
