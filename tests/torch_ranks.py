"""Start the ranks of a gloo group as subprocesses, for the port's
multi-rank CPU tests (tests/test_torch_sharded.py, test_torch_explore.py,
test_torch_checkpoint.py).

`spawn_ranks(script, args, p, inputs, out_dir)` writes `inputs` to
out_dir/inputs.npz, runs `python script *args out_dir RANK p` for each of
the p ranks with only the repository on PYTHONPATH and one thread each,
kills them after SPAWN_TIMEOUT, and returns each rank's out_dir/out<RANK>.npz
as a dict; a rank that failed or was killed raises with the end of its
log.  The rank scripts time their collectives out after 60 s, so a hung
collective fails its tests instead of hanging the suite.
"""

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 180  # seconds for all ranks; a rank alone takes a few


def spawn_ranks(script: str, args, p: int, inputs: dict, out_dir) -> list[dict]:
    np.savez(out_dir / "inputs.npz", **inputs)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    path = os.path.join(REPO, "tests", script)
    procs = []
    for r in range(p):
        log = open(out_dir / f"rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, path, *args, str(out_dir), str(r), str(p)],
                                       cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT),
                      log))
    try:
        for proc, _ in procs:
            proc.wait(timeout=SPAWN_TIMEOUT)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    failed = [r for r, (proc, _) in enumerate(procs) if proc.returncode != 0]
    if failed:
        logs = "\n".join((out_dir / f"rank{r}.log").read_text()[-3000:] for r in failed)
        raise RuntimeError(f"ranks {failed} of {p} failed or were killed:\n{logs}")
    return [dict(np.load(out_dir / f"out{r}.npz")) for r in range(p)]
