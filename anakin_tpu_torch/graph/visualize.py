"""Graph visualization: Graphviz dot, dashboard JSON and a text summary,
the port of `anakin_tpu/graph/visualize.py`.

Parity with the reference converter's web dashboard
(`tools/external_converter_v2/graph.py:12-98`, LaunchBoard JSON export):
`to_json` emits the node/edge structure for any web front-end, `to_dot`
renders with graphviz.  Shapes come from the port's `infer_shapes`; a
`torch.Size` prints as the JAX package's shape tuples do, so the text of
each function is the JAX package's for the same graph.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Optional

from .ir import Graph, topological_order
from .shape_infer import infer_shapes

__all__ = ["to_dot", "to_json", "summary_table"]

_OP_COLOR = {
    "conv2d": "lightblue", "conv2d_int8": "steelblue",
    "dense": "lightgreen", "dense_int8": "seagreen",
    "pool2d": "khaki", "pool2d_int8": "darkkhaki",
    "eltwise": "salmon", "concat": "plum", "softmax": "orange",
}


def to_dot(graph: Graph, with_shapes: bool = True) -> str:
    shapes = infer_shapes(graph) if with_shapes else {}
    lines = ["digraph G {", "  rankdir=TB;",
             '  node [shape=box, style=filled, fontname="monospace"];']
    for e in graph.inputs:
        lines.append(f'  "{e}" [fillcolor=white, shape=ellipse];')
    for node in graph.nodes.values():
        color = _OP_COLOR.get(node.op, "lightgray")
        extra = ""
        if node.attr("activation"):
            extra += f"\\n+{node.attr('activation')}"
        if node.attr("has_residual"):
            extra += "\\n+residual"
        lines.append(
            f'  "{node.name}" [label="{node.op}{extra}", fillcolor={color}];')
    producers = graph.producers()
    for node in graph.nodes.values():
        for e in node.inputs:
            if e in graph.params:
                continue
            src = producers[e].name if e in producers else e
            label = ""
            if with_shapes and e in shapes:
                label = f' [label="{list(shapes[e].shape)}"]'
            lines.append(f'  "{src}" -> "{node.name}"{label};')
    for e in graph.outputs:
        if e in producers:
            lines.append(f'  "{e}__out" [shape=ellipse, fillcolor=white, '
                         f'label="{e}"];')
            lines.append(f'  "{producers[e].name}" -> "{e}__out";')
    lines.append("}")
    return "\n".join(lines)


def to_json(graph: Graph, path: Optional[str] = None) -> str:
    """Dashboard JSON: nodes with attrs/shapes + edge list."""
    shapes = infer_shapes(graph)
    doc = {
        "name": graph.name,
        "inputs": graph.inputs,
        "outputs": graph.outputs,
        "applied_passes": graph.applied_passes,
        "nodes": [
            {
                "name": n.name,
                "op": n.op,
                "inputs": n.inputs,
                "outputs": n.outputs,
                "out_shapes": [list(shapes[e].shape) for e in n.outputs],
                "attrs": {k: (list(v) if isinstance(v, tuple) else v)
                          for k, v in n.attrs.items()},
            }
            for n in topological_order(graph)
        ],
    }
    text = json.dumps(doc, indent=1, default=str)
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


def summary_table(graph: Graph) -> str:
    """Per-node text summary (op, output shape, params): the quick look the
    reference printed at Net init."""
    shapes = infer_shapes(graph)
    rows = []
    op_count = Counter()
    for n in topological_order(graph):
        op_count[n.op] += 1
        out_s = ", ".join(str(tuple(shapes[e].shape)) for e in n.outputs)
        rows.append(f"{n.name:32s} {n.op:16s} -> {out_s}")
    rows.append("-" * 60)
    rows.append("op counts: " + ", ".join(
        f"{k}x{v}" for k, v in sorted(op_count.items())))
    n_params = sum(v.size for v in graph.params.values())
    rows.append(f"params: {len(graph.params)} tensors, {n_params/1e6:.2f} M elements")
    return "\n".join(rows)
