"""Readings from which `sharded147k.grid`'s limits are set, a seed at a
time in one set-up of the cell's ranks, each verb run by every rank:

1. `start` on the second cloud with the model left unchanged (fault
   `unchanged`: the warm model of the first cloud stays), then its grid;
2. the sound surface on the second cloud;
3. that model's grid again under `half`, `altered` and `ring_short`;

then one banded float64 reference of the second cloud at the cell's check
points, against which the five grids and the control (the same reference
in float32 with TF32 products) are compared, as `correct` compares them.

    python3 perfbench/calibrate_sharded.py --seeds 11,12

One JSON line a seed (readings by fault, the control's, the jitter the
fit's ladder added, seconds by step, each rank's peak memory), then a
summary line: the largest program reading, the smallest control and fault
readings.  `--n-surface` and `--resolution` shrink the cloud and the grid
for a rehearsal.  Needs the cell's cards (or `--device cpu`).
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CELL = "sharded147k.grid"
FAULTS = ("unchanged", "half", "altered", "ring_short")


def calibrate(spec: dict, seed: int, device) -> dict:
    """The readings of one seed (see the module note)."""
    import torch

    from perfbench import loops

    loop = loops.make_loop(spec["config"], spec["traffic"], seed, device)
    seconds = {}
    t = time.perf_counter()
    loop.setup()
    seconds["setup"] = time.perf_counter() - t
    grids = {}
    for fault, step in [("unchanged", lambda: loop.surface(1, "unchanged")),
                        (None, lambda: loop.surface(1)),
                        ("half", lambda: loop.grid("half")),
                        ("altered", lambda: loop.grid("altered")),
                        ("ring_short", lambda: loop.grid("ring_short"))]:
        t = time.perf_counter()
        grids[fault] = step()
        seconds[fault or "sound"] = time.perf_counter() - t
    loop.collect()
    loop.release()
    chk, r, model = spec["traffic"]["check"], spec["traffic"]["resolution"], loop.model
    rng = np.random.default_rng([loop.seed, 2])
    idx = rng.choice(r**3, size=min(chk["points"], r**3), replace=False)
    axis = torch.linspace(-model["grid_extent"], model["grid_extent"], r,
                          dtype=torch.float32).double().numpy()
    i, j, k = np.unravel_index(idx, (r, r, r))
    q = torch.as_tensor(np.stack([axis[i], axis[j], axis[k]], axis=1), device=loop.device)
    t = time.perf_counter()
    post, _ = loop.posterior(loop.clouds[1])
    m_ref, v_ref = post.predict(q)
    del post
    seconds["reference"] = time.perf_counter() - t
    sv = model["signal_variance"]

    def readings(mean, var):
        return {"mean_gap": loops.gap(mean, m_ref), "var_gap": loops.gap(var, v_ref) / sv}

    got = {fault or "program": readings(mean.reshape(-1)[idx], var.reshape(-1)[idx])
           for fault, (mean, var) in grids.items()}
    t = time.perf_counter()
    got["control"] = readings(*loop.control_answer(loop.clouds[1], q))
    seconds["control"] = time.perf_counter() - t
    # The next seed's ranks need the cards the reference's bands held.
    gc.collect()
    for dev in {d for d in loop.devices if d.type == "cuda"}:
        with torch.cuda.device(dev):
            torch.cuda.empty_cache()
    return {"seed": seed, "readings": got, "jitter": loop.jitter, "seconds": seconds,
            "ranks": loop.reports}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--n-surface", type=int)
    ap.add_argument("--resolution", type=int)
    args = ap.parse_args(argv)

    from perfbench import harness
    from perfbench.calibrate import seeds

    spec = harness.cell_spec(harness.load_bench(ROOT), CELL)
    if args.n_surface:
        spec["config"]["cloud"]["n_surface"] = args.n_surface
    if args.resolution:
        spec["traffic"]["resolution"] = args.resolution
    summary: dict = {}
    for seed in seeds(args.seeds):
        line = calibrate(spec, seed, args.device)
        print(json.dumps(line), flush=True)
        for side, got in line["readings"].items():
            for k, v in got.items():
                best = summary.setdefault(side, {}).get(k)
                pick = max if side == "program" else min
                summary[side][k] = v if best is None else pick(best, v)
    print(json.dumps({"summary": summary, "workload": CELL}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
