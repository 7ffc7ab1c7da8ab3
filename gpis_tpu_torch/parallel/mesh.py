"""The row mesh of the sharded pipeline (port of gpis_tpu/parallel/mesh.py),
on torch.distributed: one process per rank, NCCL on CUDA and gloo on the
CPU.

The JAX package's mesh is one program over N devices; here each rank is a
process that the caller starts and joins to a process group itself
(`torch.distributed.init_process_group`, with an address, a world size and
a rank: nothing here reads a cluster's environment).  `make_row_mesh` then
describes that group as the one 'row' axis: this rank's index, the world
size, the device its tensors live on and the backend.  The Gram matrix,
its factor and W are sharded by contiguous row bands, rank p holding rows
[p C / P, (p + 1) C / P); every rank must call every sharded function in
the same order with the same shapes (SPMD), as shard_map's body runs on
every device.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from gpis_tpu_torch._build import resolve_device

__all__ = ["RowMesh", "make_row_mesh"]


@dataclasses.dataclass(frozen=True)
class RowMesh:
    """This rank's view of the row axis."""

    rank: int
    size: int
    device: torch.device
    backend: str

    def band(self, c: int) -> tuple[int, int]:
        """(first global row, rows) of this rank's band of a capacity-c matrix."""
        if c % self.size:
            raise ValueError(f"capacity {c} not divisible by mesh size {self.size}")
        rows = c // self.size
        return self.rank * rows, rows


def make_row_mesh(n_devices: int | None = None, device="cuda") -> RowMesh:
    """The row mesh over the initialized default process group.  Its size
    must be `n_devices` (when given): a mesh is the whole group.  device
    "cuda" puts this rank's tensors on cuda:<LOCAL_RANK> (or rank modulo
    the visible cards); "cpu" needs a backend that carries CPU tensors
    (gloo)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("torch.distributed is not initialized: start one process per rank "
                           "and call init_process_group before make_row_mesh")
    rank, world = dist.get_rank(), dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"requested {n} devices, the process group has {world} ranks")
    backend = str(dist.get_backend())
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
    elif dev.type == "cpu" and backend == "nccl":
        raise ValueError("a CPU row mesh needs the gloo backend: NCCL carries CUDA tensors only")
    return RowMesh(rank=rank, size=world, device=dev, backend=backend)
