"""Graph IR — the central model representation.

TPU-native re-design of the reference's Graph/Node/Arc machinery
(`framework/graph/graph.h:36-190`, `node.h`, `arc.h`): instead of a mutable
digraph of ops with tensor-carrying edges plus a parallel "VGraph" mirror for
optimizer passes, we use ONE lightweight SSA-style IR:

  * every tensor (activation or weight) is a named *edge*;
  * a `Node` consumes input edge names and produces output edge names;
  * weights are just edges whose values live in `graph.params`;
  * passes are pure-Python functions Graph -> Graph.

There is no device/layout/lane state in the IR: XLA owns scheduling and
layout on TPU (SURVEY.md section 7 design mapping), so the IR only records
*what* to compute. Per-edge quantization scales (the reference's
`Tensor::_scale`, `saber/core/tensor.h:140-155`) live in `graph.scales`;
per-node precision overrides (the reference's `CalibratorParser` per-node
precision config, `framework/core/net/calibrator_parse.h:29-77`) live in
`graph.precisions`.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Node", "Graph", "GraphBuilder", "topological_order"]


@dataclass
class Node:
    """One operation.

    Mirrors the role of the reference's `NodeProto{attr map, Op}`
    (`framework/model_parser/proto/node.proto`) without lanes/need_wait —
    stream-lane parallelism is XLA's job on TPU.
    """

    name: str
    op: str
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    attrs: Dict[str, Any] = field(default_factory=dict)

    def attr(self, key: str, default: Any = None) -> Any:
        return self.attrs.get(key, default)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Node({self.name}: {self.op} {self.inputs} -> {self.outputs})"


class Graph:
    """A frozen-model graph.

    Replaces the reference's `Graph<Ttype, Ptype>` + `VGraph` dual
    representation with a single structure; `Ttype`/`Ptype` (compile-time
    target/precision template params, `framework/core/types.h:25-46`) become
    runtime arguments to the executor instead.
    """

    def __init__(self, name: str = "net") -> None:
        self.name = name
        self.nodes: Dict[str, Node] = {}  # insertion-ordered
        self.inputs: List[str] = []  # edge names fed by the user
        self.outputs: List[str] = []  # edge names returned to the user
        self.params: Dict[str, np.ndarray] = {}  # weight edge -> host value
        # Per-edge activation quantization scale (amax/127 convention),
        # filled by calibration (reference: scale table text file written by
        # `EntropyCalibrator::write_calibrator`).
        self.scales: Dict[str, float] = {}
        # Per-node precision override: node name -> "fp32"|"bf16"|"int8".
        self.precisions: Dict[str, str] = {}
        # Declared input specs: edge -> (shape tuple, dtype str).
        self.input_specs: Dict[str, Tuple[Tuple[int, ...], str]] = {}
        # Optimization record (reference round-trips `is_optimized` through
        # the model file, `graph.proto` Info field).
        self.applied_passes: List[str] = []

    # ---------------------------------------------------------------- edges
    def producers(self) -> Dict[str, Node]:
        """Map edge name -> node that produces it."""
        out: Dict[str, Node] = {}
        for node in self.nodes.values():
            for e in node.outputs:
                out[e] = node
        return out

    def consumers(self) -> Dict[str, List[Node]]:
        """Map edge name -> nodes that consume it."""
        out: Dict[str, List[Node]] = {}
        for node in self.nodes.values():
            for e in node.inputs:
                out.setdefault(e, []).append(node)
        return out

    def edges(self) -> List[str]:
        seen: Dict[str, None] = {}
        for e in self.inputs:
            seen.setdefault(e)
        for node in self.nodes.values():
            for e in list(node.inputs) + list(node.outputs):
                seen.setdefault(e)
        return list(seen)

    # ---------------------------------------------------------------- build
    def add_node(
        self,
        name: str,
        op: str,
        inputs: Sequence[str],
        outputs: Sequence[str],
        **attrs: Any,
    ) -> Node:
        if name in self.nodes:
            raise ValueError(f"duplicate node name: {name}")
        node = Node(name, op, list(inputs), list(outputs), dict(attrs))
        self.nodes[name] = node
        return node

    def add_param(self, edge: str, value: np.ndarray) -> str:
        self.params[edge] = np.asarray(value)
        return edge

    def add_input(self, edge: str, shape: Sequence[int], dtype: str = "float32") -> str:
        if edge not in self.inputs:
            self.inputs.append(edge)
        self.input_specs[edge] = (tuple(int(s) for s in shape), dtype)
        return edge

    def mark_output(self, *edge: str) -> None:
        for e in edge:
            if e not in self.outputs:
                self.outputs.append(e)

    def remove_node(self, name: str) -> None:
        del self.nodes[name]

    def clone(self) -> "Graph":
        g = Graph(self.name)
        g.nodes = {k: copy.deepcopy(v) for k, v in self.nodes.items()}
        g.inputs = list(self.inputs)
        g.outputs = list(self.outputs)
        g.params = dict(self.params)  # values shared (immutable by convention)
        g.scales = dict(self.scales)
        g.precisions = dict(self.precisions)
        g.input_specs = dict(self.input_specs)
        g.applied_passes = list(self.applied_passes)
        return g

    # ------------------------------------------------------------- sanity
    def validate(self) -> None:
        """Every consumed edge must be produced by a node, a param, or an input."""
        produced = set(self.inputs) | set(self.params)
        for node in self.nodes.values():
            produced.update(node.outputs)
        for node in self.nodes.values():
            for e in node.inputs:
                if e not in produced:
                    raise ValueError(f"node {node.name} consumes undefined edge {e!r}")
        for e in self.outputs:
            if e not in produced:
                raise ValueError(f"graph output {e!r} is not produced")
        # Output edges must be unique across nodes (SSA).
        seen: Dict[str, str] = {}
        for node in self.nodes.values():
            for e in node.outputs:
                if e in seen:
                    raise ValueError(
                        f"edge {e!r} produced by both {seen[e]} and {node.name}"
                    )
                if e in self.params or e in self.inputs:
                    raise ValueError(f"edge {e!r} is both produced and param/input")
                seen[e] = node.name

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"Graph({self.name}: {len(self.nodes)} nodes, "
            f"{len(self.params)} params, in={self.inputs}, out={self.outputs})"
        )


def topological_order(graph: Graph) -> List[Node]:
    """Dataflow topological sort.

    The TPU equivalent of the reference's exec-order Scheduler
    (`framework/graph/llvm/scheduler.cpp:26-130`): the reference simulates
    IO-readiness to derive a launch order; under XLA the order only fixes
    trace order, so a plain Kahn sort is enough.  Deterministic: ties break
    by node insertion order.
    """
    ready_edges = set(graph.inputs) | set(graph.params)
    remaining = list(graph.nodes.values())
    order: List[Node] = []
    while remaining:
        progressed = False
        still: List[Node] = []
        for node in remaining:
            if all(e in ready_edges for e in node.inputs):
                order.append(node)
                ready_edges.update(node.outputs)
                progressed = True
            else:
                still.append(node)
        remaining = still
        if not progressed:
            names = [n.name for n in remaining]
            raise ValueError(f"graph has a cycle or missing edges at: {names}")
    return order


class GraphBuilder:
    """Programmatic graph construction sugar.

    The TPU counterpart of the reference's `Graph::AddOp / AddOpAttr /
    Freeze` programmatic API (`framework/graph/graph.h:97-139`): the model
    functions in `anakin_tpu_torch.models` use this to assemble graphs without a
    model file.  Auto-generates edge/node names.
    """

    def __init__(self, name: str = "net") -> None:
        self.graph = Graph(name)
        self._counter = 0

    def _fresh(self, hint: str) -> str:
        self._counter += 1
        return f"{hint}_{self._counter}"

    def input(self, shape: Sequence[int], dtype: str = "float32", name: str = "input") -> str:
        return self.graph.add_input(name, shape, dtype)

    def param(self, value: np.ndarray, hint: str = "w") -> str:
        edge = self._fresh(hint)
        return self.graph.add_param(edge, value)

    def op(self, op: str, inputs: Sequence[str], n_out: int = 1, name: Optional[str] = None, **attrs: Any) -> Any:
        node_name = name or self._fresh(op)
        outputs = [f"{node_name}:out{i}" if n_out > 1 else f"{node_name}:out" for i in range(n_out)]
        self.graph.add_node(node_name, op, inputs, outputs, **attrs)
        return outputs[0] if n_out == 1 else outputs

    def output(self, *edges: str) -> None:
        self.graph.mark_output(*edges)

    def finish(self) -> Graph:
        self.graph.validate()
        return self.graph
