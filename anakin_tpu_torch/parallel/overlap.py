"""Collective / compute overlap: the port of `anakin_tpu/parallel/overlap.py`.

The JAX package has two layers: XLA:TPU compiler options that make the
GSPMD collectives asynchronous and schedule them behind compute, and two
shard_map "collective matmul" rings.  XLA's options mean nothing to
PyTorch, so the port keeps the layers' roles, not their names:

1. **A process default** (`enable_collective_overlap(level)`, read by every
   tensor-parallel `Net` built after it, as the JAX `Net` reads its
   compiler options):
     * "default": a column-sharded node's all-gather is issued
       asynchronously (`async_op=True`) as soon as its output exists, and
       waited for at its first consumer that needs the whole tensor;
     * "aggressive": also a row-sharded float `dense` runs as
       `matmul_reducescatter` (its partial product's chunks ride the ring
       while the next chunk is multiplied) and then gathers its rows,
       where the plain path all-reduces one partial product.
2. **The rings**, on a rank's shards over a mesh axis:
   `allgather_matmul` (column-parallel: gather the row-sharded activations
   through the ring, each chunk multiplied while the next is in flight)
   and `matmul_reducescatter` (row-parallel: the accumulator rides the
   ring while the next chunk's partial product is computed).  int8
   operands give float32, as the JAX rings' dots do.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.nn import full_fp32
from .mesh import MODEL_AXIS, Axes, Mesh

__all__ = ["overlap_compiler_options", "enable_collective_overlap",
           "default_compiler_options", "allgather_matmul",
           "matmul_reducescatter", "LEVELS"]

# level -> the options it turns on (aggressive holds default's)
LEVELS = {
    "default": {"async_all_gather": True},
    "aggressive": {"async_all_gather": True, "collective_matmul_rings": True},
}

# the process default that tensor-parallel Nets read when they are built
_active_default: dict = {}


def overlap_compiler_options(level: str = "default") -> dict:
    """The options of a level ("default" or "aggressive")."""
    if level not in LEVELS:
        raise ValueError(f"overlap level {level!r}: one of {sorted(LEVELS)}")
    return dict(LEVELS[level])


def enable_collective_overlap(level: Optional[str] = "default") -> bool:
    """Install `level`'s options as the process default of every
    tensor-parallel `Net` built afterwards (None removes it).  True."""
    opts = {} if level is None else overlap_compiler_options(level)
    _active_default.clear()
    _active_default.update(opts)
    return True


def default_compiler_options() -> dict:
    """The options `enable_collective_overlap` installed ({} if none)."""
    return dict(_active_default)


def _dot(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    with full_fp32():
        return torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(dtype)


def allgather_matmul(x_shard: torch.Tensor, w: torch.Tensor,
                     axis: Axes = MODEL_AXIS, reverse: bool = False, *,
                     mesh: Mesh) -> torch.Tensor:
    """`all_gather(x, axis) @ w` without gathering x first: each of P steps
    posts the held chunk to the next rank of the ring, multiplies it into
    its rows of the output, then takes the chunk the previous rank sent.

    x_shard: [m, K], this rank's rows of a [P*m, K] tensor.
    w:       [K, N] (whole, or this rank's column shard).
    returns: [P*m, N], every row of the product (float32 for int8 w).
    """
    p = mesh.axis_size(axis)
    idx = mesh.axis_index(axis)
    m = x_shard.shape[0]
    dtype = torch.float32 if w.dtype == torch.int8 else w.dtype
    out = torch.empty((p * m, w.shape[1]), dtype=dtype, device=x_shard.device)
    shift = -1 if reverse else 1
    x_cur = x_shard
    for i in range(p):
        src = (idx - shift * i) % p  # the rank the held chunk came from
        wait = mesh.ring_send_recv(x_cur, axis, shift) if i != p - 1 else None
        out[src * m:(src + 1) * m] = _dot(x_cur, w, dtype)
        if wait is not None:
            x_cur = wait()
    return out


def matmul_reducescatter(x: torch.Tensor, w_shard: torch.Tensor,
                         axis: Axes = MODEL_AXIS, *, mesh: Mesh
                         ) -> torch.Tensor:
    """`reduce_scatter(x @ w_shard)` over rows, chunk by chunk: chunk c
    starts at rank c+1 and visits c+2, ..., c, each rank adding its partial
    product, so the last chunk a rank computes is its own.  The running sum
    is posted to the next rank before the next chunk's product, which
    overlaps the transfer.

    x:       [M, k], this rank's k = K/P columns of the activations.
    w_shard: [k, N], this rank's rows of the weight.
    returns: [M/P, N] float32, this rank's rows of the summed product.
    """
    p = mesh.axis_size(axis)
    idx = mesh.axis_index(axis)
    m = x.shape[0] // p

    def part(i):
        dst = (idx - 1 - i) % p
        return _dot(x[dst * m:(dst + 1) * m], w_shard, torch.float32)

    acc = part(0)
    for i in range(1, p):
        wait = mesh.ring_send_recv(acc, axis, 1)
        nxt = part(i)  # computed while the running sum is in flight
        acc = wait() + nxt
    return acc
