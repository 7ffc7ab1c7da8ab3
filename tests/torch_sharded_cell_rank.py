"""One rank of a mesh session on the CPU (gloo), for
tests/test_torch_sharded_cell.py.  It imports torch and gpis_tpu_torch only.

    python tests/torch_sharded_cell_rank.py DIR RANK WORLD

reads DIR/inputs.npz (two clouds, the grid's resolution, the mesh's block),
joins a gloo group through the file store DIR/store (collectives time out
after 60 s), and on a `MeshConfig(n_devices=WORLD)` session in float64:
starts on the first cloud; starts on the second, noting as the fit begins
whether a band of the first model is still alive; then, with a profiler
running, starts on the first cloud again and evaluates the grid.  Writes
DIR/out<RANK>.npz: that note, the names of the recorded spans, the
counters, the model's capacity and whether jax or any gpis_tpu module was
imported.
"""

import datetime
import gc
import sys
import weakref

import numpy as np
import torch
import torch.distributed as dist

from gpis_tpu_torch.api.session import ObjectModelSession
from gpis_tpu_torch.config import MeshConfig, ModelConfig
from gpis_tpu_torch.gp import sharded_model as gsm
from gpis_tpu_torch.utils import profiling


def main(out_dir: str, rank: int, world: int) -> None:
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        run(out_dir, world)
    finally:
        dist.destroy_process_group()


def run(out_dir: str, world: int) -> None:
    inp = dict(np.load(f"{out_dir}/inputs.npz"))
    cfg = ModelConfig(lengthscale=0.4, noise_surface=1e-3, n_external=int(inp["n_external"]),
                      dtype="float64", touch_capacity=0)
    s = ObjectModelSession(cfg, mesh=MeshConfig(n_devices=world, block=int(inp["block"])),
                           device="cpu")
    s.start(inp["first"])
    bands = [weakref.ref(s.model.l), weakref.ref(s.model.w)]
    alive = []
    fit = gsm.fit_sharded

    def watched(*a, **kw):
        gc.collect()
        alive.append(any(b() is not None for b in bands))
        return fit(*a, **kw)

    gsm.fit_sharded = watched
    try:
        s.start(inp["second"])
    finally:
        gsm.fit_sharded = fit
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        s.start(inp["first"])
        s.evaluate_grid(int(inp["resolution"]), 1.5)
    snap = profiling.snapshot()
    names = sorted(snap["counters"])
    np.savez(f"{out_dir}/out{dist.get_rank()}.npz", old_alive=np.array(alive),
             spans=np.array(sorted({sp[0] for sp in snap["spans"]})),
             counter_names=np.array(names),
             counter_values=np.array([snap["counters"][k] for k in names], dtype=np.int64),
             capacity=s.model.capacity,
             forbidden=np.array(sorted(m for m in sys.modules
                                       if m.split(".")[0] in ("jax", "jaxlib", "gpis_tpu"))))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
