"""Several processes, one mesh (port of
image_matching_tpu/parallel/multihost.py).

``init`` joins this process to a ``torch.distributed`` job (NCCL between
CUDA devices, gloo on the CPU); ``global_mesh`` is this process's devices
plus the job's default group, so ``parallel.sharded.psum_mod`` over that
mesh sums across the processes; ``local_rows`` is the part of the DB this
process enrolls.  As in the JAX package, only the modular reduction spans
processes: each process runs its own shards' scenario.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .sharded import Mesh, make_mesh


def init(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
         process_id: Optional[int] = None, backend: Optional[str] = None):
    """Join a job of ``num_processes`` processes at ``coordinator``
    ("host:port"), as rank ``process_id``.  The backend is NCCL where CUDA
    is available and gloo elsewhere unless given.  No-op for one process."""
    if num_processes is None or num_processes <= 1:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def _rank_and_world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """This process's devices (all its CUDA devices unless given) and, in a
    job of several processes, its default group."""
    group = dist.group.WORLD if _rank_and_world()[1] > 1 else None
    return make_mesh(devices=devices, group=group)


def local_rows(total_rows: int) -> slice:
    """Row range of the DB this process enrolls: equal contiguous shards
    by rank."""
    rank, world = _rank_and_world()
    per = (total_rows + world - 1) // world
    return slice(rank * per, min((rank + 1) * per, total_rows))
