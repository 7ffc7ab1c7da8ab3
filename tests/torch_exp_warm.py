"""Imported for its effect by the port's CPU tests: one torch.exp in
float64 and one in float32 before any test runs.

With PyTorch 2.13's CPU build (MKL, eight intra-op threads), a process's
first torch.exp on a large tensor was seen to come back off on the 1/8 of
the elements that one thread computed: up to 3.3e-9 in float64 and 1.5e-4
in float32, relative to NumPy, while the second call on the same input was
exact (`scripts/torch_cpu_first_exp.py` reproduces it; after a 4-element
exp it did not recur).  A test that holds a plain twin to the JAX package
at 1e-12 then fails when the twin's exp is its process's first.  The
warm-up is large enough to reach every intra-op thread as well.  Under
pytest-xdist every worker imports every test file at collection, so a
worker has warmed exp before its first test; a file run alone warms at its
own import.
"""

import torch

for _dtype in (torch.float64, torch.float32):
    torch.exp(torch.linspace(-60.0, 0.0, 1 << 21, dtype=_dtype))
