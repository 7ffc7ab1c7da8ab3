"""`correct` on the CPU at a size a test run holds: each cell's traffic with
its own limits reads correct on the program, and false with the timed path
broken underneath by each fault the cell can have (`perfbench.faults`); on
a card, at the cells' own sizes, the control (the reference in float32 with
TF32 products in the program's place) reads not correct."""

import contextlib
import time

import pytest
import torch

from perfbench import faults, harness, loops

CELLS = {
    "value20k.grid": {"resolution": 12, "clouds": 3},
    "value20k.hyperopt": {"steps": 3, "start_lengthscale": 0.8, "check": {"points": 128}},
    "value20k.explore": {"clouds": 2, "check": {"rounds": 2, "points": 128}},
}


def _spec(cell):
    spec = harness.cell_spec(harness.load_bench(harness.os.path.dirname(harness.HERE)), cell)
    spec["config"]["cloud"]["n_surface"] = 200 if spec["config"]["cloud"].get("normals") else 384
    spec["traffic"].update(CELLS[cell])
    return spec


def _cases():
    """Each cell with no fault and with each fault its traffic kind lists."""
    for cell in sorted(CELLS):
        kind = _spec(cell)["traffic"]["kind"]
        yield cell, None
        for fault in loops.kind_module(kind).FAULTS:
            yield cell, fault


@pytest.mark.parametrize(("cell", "fault"), list(_cases()))
def test_correct_reads_the_program_and_catches_each_fault(cell, fault):
    torch.set_num_threads(2)
    spec = _spec(cell)
    planted = (contextlib.nullcontext() if fault is None
               else faults.planted(fault, spec["traffic"]["kind"]))
    with planted:
        result, compared, _ = harness.run_cell(spec, 2**33 + 3, 0.5, False, device="cpu",
                                               t_process=time.perf_counter())
    assert result["correct"] == (fault is None), compared


def test_every_kind_plants_the_three_faults():
    for cell in CELLS:
        assert set(faults.NAMES) <= set(loops.kind_module(_spec(cell)["traffic"]["kind"]).FAULTS)


def test_a_kind_without_the_fault_refuses_it():
    with pytest.raises(ValueError, match="no fault"):
        faults.planted("exchange", "surface")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_reads_not_correct(cell):
    """At the cell's own sizes: one request of the window, then the control
    in the program's place."""
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 products need a CUDA card")
    spec = harness.cell_spec(harness.load_bench(harness.os.path.dirname(harness.HERE)), cell)
    _, _, run = harness.run_cell(spec, 5, 0.5, False, device="cuda:0",
                                 t_process=time.perf_counter(), control=True)
    assert any(run.control[k] > lim for k, lim in spec["limits"].items()), run.control
