"""Shape and dtype inference over a Graph: the port of
`anakin_tpu/graph/shape_infer.py`.

The JAX package derives shapes from the op implementations with
`jax.eval_shape`.  Here the same ops run on tensors of PyTorch's `meta`
device, which carry a shape and a dtype but no data: one source of truth,
and nothing is computed.  The kernel wrappers take a meta tensor through
their plain versions (`kernels/_build.py::runs_plain`), which are written
without data-dependent shapes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops import get_op
from .ir import Graph, topological_order

__all__ = ["infer_shapes", "torch_dtype"]


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype or dtype name ("float32", "int8",
    ml_dtypes' "bfloat16")."""
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(name))).dtype


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=torch_dtype(dtype), device="meta")


def infer_shapes(graph: Graph) -> Dict[str, torch.Tensor]:
    """Return edge name -> a meta tensor (its `.shape` and `.dtype`) for
    every edge in the graph."""
    env: Dict[str, torch.Tensor] = {}
    for e in graph.inputs:
        shape, dtype = graph.input_specs[e]
        env[e] = _meta(shape, dtype)
    for e, v in graph.params.items():
        env[e] = _meta(v.shape, v.dtype)
    for node in topological_order(graph):
        run = get_op(node.op)
        ins = [env[e] for e in node.inputs]
        try:
            outs = run(node, list(ins))
        except Exception as exc:
            raise RuntimeError(
                f"shape inference failed at node {node.name} ({node.op}), "
                f"inputs={[(tuple(i.shape), str(i.dtype)) for i in ins]}: "
                f"{exc}") from exc
        for edge, s in zip(node.outputs, outs):
            env[edge] = s
    return env
