#!/usr/bin/env python3
"""Does a process's first torch.exp on the CPU round differently from its
later ones?

    python3 scripts/torch_cpu_first_exp.py [PROCESSES] [ELEMENTS] [WARM]

Starts PROCESSES fresh Python processes (default 20) one after another.
Each one computes torch.exp twice on the same ELEMENTS (default 2**21)
values drawn from one seed in [-60, 0], in float64 and then, in a second
process, in float32, and reports whether the first result differs from
the second and each one's largest error relative to NumPy's float64 exp.
The last line counts, per dtype, the processes whose first call differed,
with the torch version and whether it was built with MKL.  WARM > 0 makes
each process first call torch.exp once on WARM elements of each dtype.  A large input
is split among the intra-op threads, so every thread makes its first call
within the first torch.exp.
"""

from __future__ import annotations

import json
import subprocess
import sys

CHILD = """
import json, sys
import numpy as np, torch
dt = getattr(torch, sys.argv[1])
if int(sys.argv[3]):
    for warm in (torch.float64, torch.float32):
        torch.exp(torch.linspace(-60.0, 0.0, int(sys.argv[3]), dtype=warm))
x = torch.as_tensor(np.random.default_rng(0).uniform(-60.0, 0.0, size=int(sys.argv[2]))).to(dt)
first, second = torch.exp(x), torch.exp(x)
exact = torch.as_tensor(np.exp(x.double().numpy()))
rel = lambda y: float(((y.double() - exact).abs() / exact).max())
print(json.dumps({"dtype": sys.argv[1], "differing": int((first != second).sum()),
                  "first_rel_err": rel(first), "second_rel_err": rel(second)}))
"""


def main() -> int:
    procs = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    n = sys.argv[2] if len(sys.argv) > 2 else str(1 << 21)
    warm = sys.argv[3] if len(sys.argv) > 3 else "0"
    seen = {"float64": 0, "float32": 0}
    for _ in range(procs):
        for dt in seen:
            out = subprocess.run([sys.executable, "-c", CHILD, dt, n, warm], capture_output=True,
                                 text=True, check=True).stdout
            row = json.loads(out.strip().splitlines()[-1])
            seen[dt] += row["differing"] > 0
            if row["differing"]:
                print(json.dumps(row), flush=True)
    import torch

    print(json.dumps({"torch": torch.__version__, "mkl": torch.backends.mkl.is_available(),
                      "threads": torch.get_num_threads(), "processes": procs, "elements": int(n),
                      "warm": int(warm),
                      "first_call_differed": seen}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
