"""Faults planted under the timed path, to show that `correct` catches them.

Each traffic kind (`kinds/<kind>.py`) lists in `FAULTS` the faults its
timed path can have, each a function returning a context manager that
patches the package under test in memory: `unchanged` (a step that returns
its state unchanged), `half` (half of the batch left out, the rest
standing for the whole) and `altered` (an answer altered where it is
produced), and any of the kind's own (the hyperopt's `unchanged_refit`).
The cells run on one card, so the fault of an exchange between cards has
no case.  Used by the fault test and by `calibrate.py --fault`:

    with faults.planted("half", "surface"):
        harness.run_cell(...)
"""

from __future__ import annotations

import contextlib

from perfbench import loops

__all__ = ["NAMES", "SHIFT", "patch", "half_predict", "planted"]

NAMES = ("unchanged", "half", "altered")
SHIFT = 1e-2  # how far an altered answer moves: a hundredth of the label scale


@contextlib.contextmanager
def patch(obj, name, new):
    """obj.name replaced by new(old) inside the context."""
    old = getattr(obj, name)
    setattr(obj, name, new(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def half_predict(old):
    """A predict over every other query, each answer standing for the next."""
    def predict(model, q, **kw):
        mean, var = old(model, q[::2].contiguous(), **kw)
        n = q.shape[0]
        return mean.repeat_interleave(2)[:n], var.repeat_interleave(2)[:n]
    return predict


def planted(fault: str, kind: str, base: str = loops.HERE):
    """The context that plants `fault` under traffic of `kind`."""
    table = loops.kind_module(kind, base).FAULTS
    if fault not in table:
        raise ValueError(f"traffic kind {kind!r} has no fault {fault!r}; it has {sorted(table)}")
    return table[fault]()
