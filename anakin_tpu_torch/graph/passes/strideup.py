"""Stride-up: hoist a 1x1 stride-2 conv's stride into an earlier conv (the
port of `anakin_tpu/graph/passes/strideup.py`, numpy only).

A 1x1 stride-2 convolution reads only every other pixel of its input, so
when the chain back to the previous stride-1 convolution is pointwise and
nothing else reads it, the stride moves up: the earlier conv computes a
quarter of the positions and every node in between shrinks with it.  The
rewrite is exact (a stride-s conv's output is its stride-1 output
subsampled by s, same padding).  Exported, not in the default pipeline.
"""

from __future__ import annotations

from ..ir import Graph

__all__ = ["stride_up"]

# single-input ops that commute with spatial subsampling
_POINTWISE = {"activation", "relu", "elu", "scale", "batch_norm", "power",
              "prelu", "exp", "log", "dropout"}


def stride_up(graph: Graph) -> Graph:
    g = graph.clone()
    producers = g.producers()
    changed = False
    for node in list(g.nodes.values()):
        if node.op != "conv2d":
            continue
        w = g.params.get(node.inputs[1])
        if w is None or w.shape[0] != 1 or w.shape[1] != 1:
            continue
        if tuple(node.attr("strides", (1, 1))) != (2, 2):
            continue
        # walk the pointwise chain up to the previous conv
        chain = []
        e = node.inputs[0]
        src = producers.get(e)
        consumers = g.consumers()

        def sole_path_edge(edge: str) -> bool:
            # the full-resolution tensor must have NO other reader — one
            # node consumer and not a graph output
            return (len(consumers.get(edge, [])) == 1
                    and edge not in g.outputs)

        while src is not None and src.op in _POINTWISE:
            if not sole_path_edge(src.outputs[0]):
                src = None
                break
            chain.append(src)
            src = producers.get(src.inputs[0])
        if src is None or src.op != "conv2d":
            continue
        if tuple(src.attr("strides", (1, 1))) != (1, 1):
            continue
        if not sole_path_edge(src.outputs[0]):
            continue
        src.attrs["strides"] = (2, 2)
        node.attrs["strides"] = (1, 1)
        changed = True
    if changed:
        g.applied_passes.append("stride_up")
    return g
