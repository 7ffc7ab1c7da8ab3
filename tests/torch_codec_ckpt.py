"""Checkpoints in the forms the out-of-core codecs and the sharded joint
model write, for the port's checkpoint tests (tests/test_torch_checkpoint.py,
test_torch_repairs.py).

`code_panel(wdir, j, codec)` rewrites W panel j of a checkpoint's `.w/`
directory in a spill codec, as the JAX package's store writes one:
"float16" (the panel narrowed) or "int16" (the blockwise codes and their
float32 scales, `outofcore._qpack`), with its manifest entry.
`one_rank_group(tmp)` joins a one-rank gloo group for a sharded load.
"""

import contextlib
import json
import os

import jax.numpy as jnp
import numpy as np
import torch.distributed as dist

from gpis_tpu.linalg import outofcore as jooc


def code_panel(wdir, j: int, codec: str) -> None:
    manifest = os.path.join(wdir, "manifest.json")
    with open(manifest) as f:
        doc = json.load(f)
    shape, dt = doc["panels"][str(j)][:2]
    path = os.path.join(wdir, f"panel_{j}.bin")
    arr = np.fromfile(path, dtype=dt).reshape(shape)
    if codec == "float16":
        arr.astype(np.float16).tofile(path)
        doc["panels"][str(j)] = [shape, "float16"]
    else:
        q, s = (np.asarray(a) for a in jooc._qpack(jnp.asarray(arr)))
        q.tofile(path)
        s.tofile(path + ".scale")
        doc["panels"][str(j)] = [list(q.shape), "int16", {
            "codec": "int16", "scale_shape": list(s.shape), "width": shape[1],
            "orig_dtype": dt}]
    with open(manifest, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def one_rank_group(tmp):
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
