"""Horizontal combine: merge sibling convs over the same input (the port of
`anakin_tpu/graph/passes/combine.py`, numpy only, so the rewritten graph
equals the JAX package's).

Sibling float convolutions that share the same input and hyper-parameters
(strides, padding, dilation, groups=1, activation, bias; no residual) are
merged into one wider conv whose output a `slice` node cuts back into the
original output edges, so consumers are untouched: one wide product in
place of several narrow ones (GoogLeNet's inception branches).  Exported,
not in the default pipeline.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..ir import Graph, Node

__all__ = ["horizontal_combine"]


def _combine_key(node: Node) -> Tuple:
    return (
        node.inputs[0],
        tuple(node.attr("strides", (1, 1))),
        tuple(node.attr("padding", (0, 0))),
        tuple(node.attr("dilation", (1, 1))),
        int(node.attr("groups", 1)),
        node.attr("activation"),
        float(node.attr("act_alpha", 0.0)),
        bool(node.attr("has_bias")),
    )


def horizontal_combine(graph: Graph, min_siblings: int = 2) -> Graph:
    g = graph.clone()
    groups: Dict[Tuple, List[Node]] = {}
    for node in g.nodes.values():
        if node.op != "conv2d" or node.attr("has_residual"):
            continue
        if int(node.attr("groups", 1)) != 1:
            continue
        w = g.params.get(node.inputs[1])
        if w is None:
            continue
        groups.setdefault(_combine_key(node), []).append(node)

    idx = 0
    for key, siblings in groups.items():
        if len(siblings) < min_siblings:
            continue
        # kernels must agree in spatial size and input channels
        ws = [g.params[n.inputs[1]] for n in siblings]
        if len({w.shape[:3] for w in ws}) != 1:
            continue
        idx += 1
        w_cat = np.concatenate(ws, axis=3)
        widths = [w.shape[3] for w in ws]
        first = siblings[0]
        has_bias = bool(first.attr("has_bias"))
        combo = f"hcombine_{idx}"
        w_edge = g.add_param(f"{combo}__w", w_cat)
        inputs = [first.inputs[0], w_edge]
        if has_bias:
            b_cat = np.concatenate([g.params[n.inputs[2]] for n in siblings])
            inputs.append(g.add_param(f"{combo}__b", b_cat))
        wide_out = f"{combo}:out"
        g.add_node(combo, "conv2d", inputs, [wide_out],
                   strides=key[1], padding=key[2], dilation=key[3],
                   groups=1, activation=key[5], act_alpha=key[6],
                   has_bias=has_bias)
        # slice back to the ORIGINAL output edges so consumers are untouched
        points = list(np.cumsum(widths)[:-1].astype(int))
        g.add_node(f"{combo}_split", "slice", [wide_out],
                   [n.outputs[0] for n in siblings],
                   axis=3, slice_points=points)
        for n in siblings:
            g.remove_node(n.name)
    if idx:
        g.applied_passes.append("horizontal_combine")
        g.validate()
    return g
