"""Joining the process group: the port of `anakin_tpu/parallel/distributed.py`.

The JAX package joins a pod's runtime with `jax.distributed.initialize`,
after which one controller sees every host's devices.  The port runs one
process per rank: `initialize` joins the ranks into one
`torch.distributed` process group over a TCP store, and the meshes of
`parallel.mesh` lay those ranks out.  Nothing is read from the
environment: the coordinator's address, the world size, the rank and the
backend are given (NCCL where each rank has its own card, gloo where ranks
share a card or run on the CPU).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["initialize", "is_distributed", "local_device_count"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: str = "gloo") -> None:
    """Join the `num_processes`-rank group as rank `process_id`, rank 0's
    TCP store at `coordinator_address` ("host:port").  A second call, and a
    world of one process, do nothing."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("initialize: give the coordinator's address and this "
                         "process's id for a world of "
                         f"{num_processes} processes")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))


def is_distributed() -> bool:
    import torch.distributed as dist

    return dist.is_initialized() and dist.get_world_size() > 1


def local_device_count() -> int:
    """The CUDA cards this process sees (0 where there is none)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0
