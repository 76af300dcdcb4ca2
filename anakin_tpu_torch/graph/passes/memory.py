"""Static arena planner: liveness-based buffer reuse over the topo order,
the port of `anakin_tpu/graph/passes/memory.py`.

Parity component for the reference's in-place memory scheduler
(`framework/graph/llvm/optimizer/memory_scheduler.cpp:187-444`) and the
`Net::init_memory` share_from chasing (`net.cpp:813-880`): simulate
execution, free each edge once all its consumers ran, and let a later edge
reuse the freed block.  Walk the nodes in exec order; an output claims the
smallest free block that holds it (or grows the arena); a block frees when
its edge's last consumer has executed.  The port's executor allocates
through PyTorch's caching allocator, so the plan is a report of the
activation working set (as the reference's `temp_mem_used` was) and a
sizing for staged host buffers, not what the `Net` allocates.

Sizes come from the port's `infer_shapes` (meta tensors), so the plan sizes
the dtypes the port's executor holds.  Where those are the JAX package's
(every float and int8 edge of the CNNs and the transformer) the plan equals
the JAX planner's, offset for offset.  int64 edges differ: an op of the
port keeps an int64 input int64 (a reshape or gather of int64 token ids)
where JAX, with 64-bit types off, gives int32, so such an edge takes twice
the JAX plan's bytes.  The ops' own index outputs (top-k, pooling indices,
CRF tags) are int32 in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ir import Graph, topological_order
from ..shape_infer import infer_shapes

__all__ = ["ArenaPlan", "plan_memory"]

_ALIGN = 512  # alignment of each edge's block


def _round_up(x: int, m: int = _ALIGN) -> int:
    return (x + m - 1) // m * m


@dataclass
class ArenaPlan:
    offsets: Dict[str, int]           # edge -> byte offset in the arena
    sizes: Dict[str, int]             # edge -> byte size (aligned)
    arena_bytes: int                  # total arena footprint
    naive_bytes: int                  # sum of all edge sizes (no reuse)
    share_from: Dict[str, str] = field(default_factory=dict)

    @property
    def reuse_ratio(self) -> float:
        return self.arena_bytes / max(self.naive_bytes, 1)

    def summary(self) -> str:
        return (
            f"arena {self.arena_bytes / 1e6:.2f} MB for "
            f"{len(self.offsets)} edges (naive {self.naive_bytes / 1e6:.2f} MB, "
            f"reuse x{self.naive_bytes / max(self.arena_bytes, 1):.2f})"
        )


def plan_memory(graph: Graph, batch_override: Optional[int] = None) -> ArenaPlan:
    """Greedy best-fit arena assignment over activation edges.

    Weights are excluded (they stay resident).  Graph outputs are pinned
    live to the end.  `batch_override` is accepted and unused, as in the
    JAX planner: the graph's input specs give the batch.
    """
    shapes = infer_shapes(graph)
    order = topological_order(graph)
    consumers = graph.consumers()

    # last use step per edge
    step_of = {n.name: i for i, n in enumerate(order)}
    last_use: Dict[str, int] = {}
    for e, cs in consumers.items():
        last_use[e] = max(step_of[c.name] for c in cs)
    n_steps = len(order)
    for e in graph.outputs:
        last_use[e] = n_steps  # pinned

    sizes: Dict[str, int] = {}
    for e, s in shapes.items():
        if e in graph.params:
            continue
        sizes[e] = _round_up(int(np.prod(s.shape)) * s.dtype.itemsize)

    # free list of (offset, size) blocks; allocated: edge -> (off, size)
    free: List[Tuple[int, int]] = []
    alloc: Dict[str, Tuple[int, int]] = {}
    offsets: Dict[str, int] = {}
    share_from: Dict[str, str] = {}
    block_owner: Dict[int, str] = {}
    top = 0

    def allocate(edge: str) -> None:
        nonlocal top
        size = sizes[edge]
        best = None
        for i, (off, bsz) in enumerate(free):
            if bsz >= size and (best is None or bsz < free[best][1]):
                best = i
        if best is not None:
            off, bsz = free.pop(best)
            alloc[edge] = (off, bsz)
            offsets[edge] = off
            prev = block_owner.get(off)
            if prev is not None:
                share_from[edge] = prev
            block_owner[off] = edge
        else:
            alloc[edge] = (top, size)
            offsets[edge] = top
            block_owner[top] = edge
            top += size

    # graph inputs live from step 0
    for e in graph.inputs:
        if e in sizes:
            allocate(e)

    for i, node in enumerate(order):
        for e in node.outputs:
            if e in sizes:
                allocate(e)
        # free edges whose last consumer just ran
        for e in list(alloc):
            if last_use.get(e, -1) == i:
                off, bsz = alloc.pop(e)
                free.append((off, bsz))

    naive = sum(sizes.values())
    return ArenaPlan(offsets=offsets, sizes=sizes, arena_bytes=top,
                     naive_bytes=naive, share_from=share_from)
