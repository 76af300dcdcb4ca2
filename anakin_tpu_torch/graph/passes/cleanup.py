"""Cleanup passes: identity removal, dead-node/param elimination.

Reference counterpart: the implicit graph hygiene inside `Graph::Optimize`
(`framework/graph/graph.cpp:350-470`) — fused-away nodes disappear, `split`
nodes are pure fan-out aliases (`framework/operators/split.cpp`).
"""

from __future__ import annotations

from typing import Dict

from ..ir import Graph

__all__ = ["replace_edge_uses", "remove_identity_nodes", "eliminate_dead_nodes"]

# ops that are pure pass-throughs at inference time when their attrs are
# trivial: edge alias only.
_IDENTITY_OPS = {"split", "dropout"}


def replace_edge_uses(graph: Graph, old: str, new: str) -> None:
    """Rewire every consumer of `old` (and graph outputs) to `new`."""
    for node in graph.nodes.values():
        node.inputs = [new if e == old else e for e in node.inputs]
    graph.outputs = [new if e == old else e for e in graph.outputs]
    if old in graph.scales and new not in graph.scales:
        graph.scales[new] = graph.scales[old]


def remove_identity_nodes(graph: Graph) -> Graph:
    """Drop alias nodes: `split` fan-out and no-op dropout (scale==1)."""
    g = graph.clone()
    changed = True
    while changed:
        changed = False
        for name, node in list(g.nodes.items()):
            if node.op == "split":
                src = node.inputs[0]
                for out in node.outputs:
                    replace_edge_uses(g, out, src)
                g.remove_node(name)
                changed = True
            elif node.op == "dropout" and float(node.attr("scale", 1.0)) == 1.0:
                replace_edge_uses(g, node.outputs[0], node.inputs[0])
                g.remove_node(name)
                changed = True
            elif node.op == "activation" and node.attr("activation", "relu") == "identity":
                replace_edge_uses(g, node.outputs[0], node.inputs[0])
                g.remove_node(name)
                changed = True
    g.applied_passes.append("remove_identity_nodes")
    return g


def eliminate_dead_nodes(graph: Graph) -> Graph:
    """Remove nodes whose outputs are never consumed, then unused params."""
    g = graph.clone()
    changed = True
    while changed:
        changed = False
        consumers = g.consumers()
        live = set(g.outputs)
        for name, node in list(g.nodes.items()):
            if not any(e in live or consumers.get(e) for e in node.outputs):
                g.remove_node(name)
                changed = True
    used = set()
    for node in g.nodes.values():
        used.update(node.inputs)
    for p in list(g.params):
        if p not in used and p not in g.outputs:
            del g.params[p]
    g.applied_passes.append("eliminate_dead_nodes")
    return g
