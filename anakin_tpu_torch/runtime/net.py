"""Net: the executor, the port of `anakin_tpu/runtime/net.py`.

The JAX `Net` traces the graph into one jitted program.  PyTorch runs
eagerly, so here `build_forward` returns a function that walks the nodes in
topological order and calls each op on tensors; the dtype rules are the
JAX package's, so that the two agree node by node:

  * float graph inputs and float params run in the net's compute dtype
    (`precision` "fp32" or "bf16"); int8 tensors stay int8;
  * a node pinned in `graph.precisions` gets its float inputs cast to its
    own dtype, and its float outputs cast back to the compute dtype;
  * every other node's float outputs keep the dtype the op gave them, and
    the next consumer casts them to what it wants.

A `Net` also prepares, once when it is built, the [N][K] copy of every int8
weight that the int8 GEMM kernels read (`ops.quantized.
prepare_int8_weights`), and hands it to the node's op, so that no step
transposes a weight.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import params_from_numpy
from ..graph.ir import Graph, Node, topological_order
from ..ops import get_op
from ..ops.quantized import prepare_int8_weights

__all__ = ["Net", "build_forward"]

_COMPUTE_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def build_forward(
    graph: Graph,
    precision: str = "fp32",
    stop_at: Optional[str] = None,
    start_from: Optional[str] = None,
    tap_edges: Sequence[str] = (),
) -> Tuple[Callable, List[Node]]:
    """Build `f(params, inputs, prepared=None) -> {edge: tensor}`, where
    `prepared` maps node names to the weights `prepare_int8_weights` made.

    `stop_at` / `start_from` cut the node order (with `start_from`, inputs
    feed the interior edges consumed at the cut); `tap_edges` adds interior
    edges to the outputs.
    """
    order = topological_order(graph)
    if start_from is not None:
        idx = [i for i, n in enumerate(order) if n.name == start_from]
        if not idx:
            raise KeyError(f"start_from node {start_from!r} not found")
        order = order[idx[0]:]
    if stop_at is not None:
        idx = [i for i, n in enumerate(order) if n.name == stop_at]
        if not idx:
            raise KeyError(f"stop_at node {stop_at!r} not found")
        order = order[: idx[0] + 1]

    compute_dtype = _COMPUTE_DTYPES[precision]
    if stop_at is not None or start_from is not None:
        outputs = list(order[-1].outputs)
    else:
        outputs = list(graph.outputs)
    outputs = list(dict.fromkeys(outputs + list(tap_edges)))

    node_prec: Dict[str, torch.dtype] = {
        n.name: _COMPUTE_DTYPES[graph.precisions[n.name]]
        for n in order if graph.precisions.get(n.name) in _COMPUTE_DTYPES}

    def forward(params: Dict[str, torch.Tensor],
                inputs: Dict[str, torch.Tensor],
                prepared: Optional[Dict[str, Any]] = None
                ) -> Dict[str, torch.Tensor]:
        prepared = prepared or {}
        env: Dict[str, torch.Tensor] = {
            k: v.to(compute_dtype) if v.is_floating_point() else v
            for k, v in inputs.items()}

        def lookup(e: str) -> torch.Tensor:
            if e in env:
                return env[e]
            v = params[e]
            return v.to(compute_dtype) if v.is_floating_point() else v

        for node in order:
            want = node_prec.get(node.name, compute_dtype)
            xs = []
            for e in node.inputs:
                v = lookup(e)
                if v.is_floating_point() and v.dtype != want:
                    v = v.to(want)
                xs.append(v)
            prep = prepared.get(node.name)
            ys = (get_op(node.op)(node, xs) if prep is None
                  else get_op(node.op)(node, xs, prepared=prep))
            for e, y in zip(node.outputs, ys):
                if (y.is_floating_point() and y.dtype != compute_dtype
                        and node.name in node_prec):
                    y = y.to(compute_dtype)
                env[e] = y
        return {e: lookup(e) for e in outputs}

    return forward, order


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("Net runs on CUDA by default and no CUDA device is "
                           "present; pass device='cpu' to run on the CPU")
    return dev


def _to_device(v: Any, device: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.from_numpy(np.array(v)).to(device)


class Net:
    """Inference executor over a Graph:

        graph = quantize_graph(optimize(build_resnet50(...)), scales)
        net = Net(graph, precision="bf16")          # on CUDA
        out = net.prediction({"input": x})

    `device=None` means CUDA and raises where there is none; the CPU is
    used only when asked for (`device="cpu"`).  Weights go to the device
    once, cast to the compute dtype, and the int8 GEMM weights are prepared
    once (`prepared`).
    """

    def __init__(
        self,
        graph: Graph,
        precision: str = "fp32",
        device=None,
        stop_at: Optional[str] = None,
        start_from: Optional[str] = None,
        tap_edges: Sequence[str] = (),
    ) -> None:
        graph.validate()
        self.graph = graph
        self.precision = precision
        self.device = _resolve_device(device)
        self.forward, self.order = build_forward(
            graph, precision, stop_at=stop_at, start_from=start_from,
            tap_edges=tap_edges)
        dtype = _COMPUTE_DTYPES[precision]
        self.params = {
            k: v.to(dtype) if v.is_floating_point() else v
            for k, v in params_from_numpy(graph.params, self.device).items()}
        self.prepared = prepare_int8_weights(self.order, self.params)

    def prediction(self, inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One forward step on numpy arrays or tensors; returns tensors on
        the net's device."""
        feed = {k: _to_device(v, self.device) for k, v in inputs.items()}
        with torch.inference_mode():
            return self.forward(self.params, feed, self.prepared)

    def __call__(self, inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return self.prediction(inputs)
