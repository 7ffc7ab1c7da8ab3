"""Traffic kind `surface_sharded`: `surface`'s request, `start` on a new
cloud and then `evaluate_grid(resolution)`, served by the row-sharded
session on a mesh of the configuration's `mesh.n_devices` ranks, one
process a rank.

This process is the rank that holds the last row band (rank P - 1, whose
band carries the most of the factor's, W's and the grid quad's work: the
critical path), on the benchmark's device, so that the trace and the peak
memory the benchmark reads are that rank's; the other ranks run no
profiler (one started when this rank's window opens would stall the first
collective while it starts).  `setup` starts ranks 0 .. P - 2 as child
processes of this file, each on a card of its own (on the CPU every rank
is on the CPU, with gloo); they join through a file store with a
collective timeout of `TIMEOUT` seconds, and each verb this process runs
it first tells them to run, so that every rank runs the same sequence.
Set-up warms the fit and one grid chunk (a `query` of one chunk's size)
on the first cloud; the window's surfaces start at the second cloud, so
that a model left unchanged shows.

A child dies with this process (PR_SET_PDEATHSIG, and at the end of its
input), and a child that exits before `release` ends this process at once
with a non-zero code, so a failed rank never leaves the others waiting on
a collective.  Each child reports the modules it loaded; the run fails if
a rank loaded JAX or the JAX package.  `release` frees every rank's bands
and ends the children, so that `compare` can run the plain banded
reference (`reference/banded.py`) over all P devices.

Faults are planted in every rank (a fault in one rank alone would
desynchronise the collectives): `surface`'s three and `ring_short`, the
query ring's last hop left out, so that one band's share of each variance
is missing.

    python3 perfbench/kinds/surface_sharded.py ARGS_JSON   # one child rank
"""

from __future__ import annotations

import contextlib
import ctypes
import datetime
import gc
import itertools
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import clouds, faults, harness, loops  # noqa: E402
from perfbench.reference import banded  # noqa: E402
from perfbench.reference import gp as ref  # noqa: E402

surface = loops.kind_module("surface", os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

TIMEOUT = 600  # seconds a collective may wait: more than a surface at C 147,456
_PLANTED: list[str] = []  # faults planted in this process, passed on to the ranks it starts


def _devices(device: torch.device, p: int) -> list[torch.device]:
    """Each rank's device: rank P - 1 on `device`, the others on the other
    cards in order (on the CPU, the CPU)."""
    if device.type != "cuda":
        return [device] * p
    here = device.index if device.index is not None else torch.cuda.current_device()
    others = [i for i in range(torch.cuda.device_count()) if i != here][:p - 1]
    if len(others) < p - 1:
        raise RuntimeError(f"a mesh of {p} ranks needs {p} cards; "
                           f"{torch.cuda.device_count()} are visible")
    return [torch.device("cuda", i) for i in others] + [torch.device("cuda", here)]


class Kind(surface.Kind):
    unit = "surface"

    def __init__(self, config: dict, traffic: dict, seed: int, device, rank: int | None = None,
                 store: str | None = None):
        super().__init__(config, traffic, seed, device)
        self.ranks = int(config["mesh"]["n_devices"])
        self.rank = self.ranks - 1 if rank is None else rank
        self.devices = _devices(self.device, self.ranks) if rank is None else None
        self.store, self.children = store, {}
        self._closing = False

    # -- the ranks -------------------------------------------------------

    def _spawn(self):
        self.store = tempfile.mkdtemp(prefix="perfbench-sharded-")
        env = dict(os.environ)
        if self.device.type == "cpu":
            env["OMP_NUM_THREADS"] = str(torch.get_num_threads())
        for r in range(self.ranks - 1):
            args = {"config": self.config, "traffic": self.traffic, "seed": self.seed,
                    "device": str(self.devices[r]), "rank": r, "store": self.store,
                    "faults": list(_PLANTED), "parent": os.getpid()}
            self.children[r] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), json.dumps(args)], cwd=ROOT,
                env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self):
        """End this process when a child exits before `release`."""
        while not self._closing:
            for r, proc in self.children.items():
                code = proc.poll()
                if code is not None and not self._closing:
                    print(f"rank {r} exited with code {code} before the run's end; ending the "
                          f"run", file=sys.stderr, flush=True)
                    self._kill()
                    os._exit(3)
            time.sleep(0.5)

    def _kill(self):
        for proc in self.children.values():
            if proc.poll() is None:
                proc.kill()

    def _tell(self, **verb):
        for proc in self.children.values():
            proc.stdin.write(json.dumps(verb) + "\n")
            proc.stdin.flush()

    def _hear(self) -> dict:
        """Each child's reply to the last verb, by rank."""
        got = {}
        for r, proc in self.children.items():
            line = proc.stdout.readline()
            if not line:
                raise RuntimeError(f"rank {r} ended without a reply")
            got[r] = json.loads(line)
        return got

    def _join(self):
        import torch.distributed as dist

        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        dist.init_process_group("nccl" if self.device.type == "cuda" else "gloo",
                                init_method=f"file://{self.store}/store", rank=self.rank,
                                world_size=self.ranks,
                                timeout=datetime.timedelta(seconds=TIMEOUT))

    # -- the verbs every rank runs -----------------------------------------

    def setup(self):
        from gpis_tpu_torch import MeshConfig, ObjectModelSession
        from gpis_tpu_torch.surface.grid import CHUNK

        if not hasattr(ObjectModelSession, "reset"):
            # A session that keeps its model while it refits holds two
            # models' bands a rank during the window's first start.
            raise RuntimeError("this gpis_tpu_torch keeps the old model while a mesh session "
                               "refits (no ObjectModelSession.reset): it cannot serve this cell")
        t = self.traffic
        self.clouds = [clouds.make_cloud(self.config["cloud"], self.rng, axes=t.get("axes"))
                       for _ in range(t["clouds"])]
        self.sizes["m"] = t["resolution"] ** 3
        if self.devices is not None:
            self._spawn()
        self._join()
        self.session = ObjectModelSession(self.model_config,
                                          mesh=MeshConfig(**self.config["mesh"]),
                                          device=self.device)
        self.outputs = []
        self.session.start(self.clouds[0].points)
        self.session.query(np.zeros((min(CHUNK, self.sizes["m"]), 3), np.float32))
        self._hear()
        model = self.session.model
        row0, rows = model.mesh.band(model.capacity)
        self.sizes.update(c=model.capacity, band=(row0, row0 + rows), block=model.block)
        self.spans.clear()
        self.i = 1

    def surface(self, k: int, fault: str | None = None):
        """start on cloud k and the grid, in every rank (with `fault`
        planted); (mean, var)."""
        self._tell(verb="surface", cloud=k, fault=fault)
        with FAULTS[fault]() if fault else contextlib.nullcontext():
            out = self._surface(self.clouds[k])
        self._hear()
        return out

    def grid(self, fault: str | None = None):
        """The grid alone on the model in place, in every rank (with `fault`
        planted); (mean, var)."""
        self._tell(verb="grid", fault=fault)
        with FAULTS[fault]() if fault else contextlib.nullcontext():
            mean, var, _ = self.session.evaluate_grid(self.traffic["resolution"],
                                                      self.model["grid_extent"])
        self._hear()
        return mean, var

    def request(self) -> int:
        k = self.i % len(self.clouds)
        self.i += 1
        mean, var = self.surface(k)
        self.outputs.append((k, mean, var))
        return 1

    def collect(self):
        """The jitter the fit's ladder added (0: its first attempt held)."""
        m, ts = self.session.model, self.session.training
        n = ts.noise.shape[0]
        self.jitter = float((m.noise[:n] - ts.noise.to(m.noise)).max())

    def release(self):
        """Free every rank's bands, end the children, and fail where a child
        loaded a forbidden module (the benchmark checks this process)."""
        import torch.distributed as dist

        peak = (torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda"
                else None)
        self._closing = True
        self._tell(verb="release")
        super().release()
        dist.barrier()
        dist.destroy_process_group()
        reports = self._hear()
        bad = {r: rep["forbidden"] for r, rep in reports.items() if rep["forbidden"]}
        reports[self.rank] = {"peak_bytes": peak, "jitter": getattr(self, "jitter", None)}
        for r, proc in self.children.items():
            if proc.wait(timeout=TIMEOUT) != 0:
                raise RuntimeError(f"rank {r} exited with code {proc.returncode}")
        shutil.rmtree(self.store, ignore_errors=True)
        self.reports = reports
        for r in sorted(reports):
            print(f"rank {r}: {json.dumps(reports[r])}", file=sys.stderr)
        if bad:
            raise RuntimeError(f"ranks loaded forbidden modules: {bad}")

    # -- the reference -----------------------------------------------------

    def posterior(self, cloud, *, dtype=torch.float64, **kw):
        """The plain banded reference over every rank's device."""
        if kw:
            raise TypeError(f"the banded reference takes no {sorted(kw)}")
        obs, frame = ref.observations(cloud.points, self.model, dtype=dtype, device=self.device)
        return banded.BandedPosterior(obs, self.model["lengthscale"],
                                      self.model["signal_variance"], self.devices), frame


def _ring_short():
    """The query ring's last hop left out: each shard misses one band's
    share of its variance."""
    import torch.distributed as dist

    from gpis_tpu_torch.kernels import cuda_query

    def quad_band(old):
        calls = itertools.count(1)

        def f(gen, name, q, *a, **kw):
            if next(calls) % dist.get_world_size():
                return old(gen, name, q, *a, **kw)
            return torch.zeros((q.shape[0],), dtype=q.dtype, device=q.device)
        return f
    return faults.patch(cuda_query, "quad_band", quad_band)


def _everywhere(name, plant):
    """`plant` here, and in the ranks started while it is planted."""
    @contextlib.contextmanager
    def planted():
        _PLANTED.append(name)
        try:
            with plant():
                yield
        finally:
            _PLANTED.remove(name)
    return planted


FAULTS = {name: _everywhere(name, plant) for name, plant in
          {**surface.FAULTS, "ring_short": _ring_short}.items()}


# -- a child rank ------------------------------------------------------------

def _child(args: dict) -> int:
    """Run rank args["rank"]: the same set-up, then each verb read from
    standard input, a JSON reply a verb on the original standard output."""
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG: die with the parent
    if os.getppid() != args["parent"]:
        return 1
    reply = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)  # the program's own prints go to standard error
    me = Kind(args["config"], args["traffic"], args["seed"], args["device"],
              rank=args["rank"], store=args["store"])

    def answer(**extra):
        reply.write(json.dumps({"forbidden": harness.forbidden_modules(), **extra}) + "\n")

    with contextlib.ExitStack() as stack:
        for name in args["faults"]:
            stack.enter_context(FAULTS[name]())
        me.setup()
        answer()
        for line in sys.stdin:
            verb = json.loads(line)
            if verb["verb"] == "release":
                break
            if verb["verb"] == "grid":
                me.grid(verb["fault"])
            else:
                me.surface(verb["cloud"], verb["fault"])
            answer()
        else:
            return 1  # the parent's input ended without a release
    import torch.distributed as dist

    peak = (torch.cuda.max_memory_allocated(me.device) if me.device.type == "cuda" else None)
    me.session = None
    gc.collect()
    if me.device.type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()
    answer(peak_bytes=peak)
    return 0


if __name__ == "__main__":
    sys.exit(_child(json.loads(sys.argv[1])))
