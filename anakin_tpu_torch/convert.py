"""Carry graphs and weights across from the JAX package without importing it.

`graph_from_jax` rebuilds a port `Graph` from any object with the JAX
`Graph`'s fields, so a test can hand the JAX package's own optimized and
quantized graph to the port's `Net`.  `params_from_numpy` moves host weights
to a device as they are (the dtype cast for a precision is `Net`'s job);
`to_numpy` brings a tensor back to the host as the JAX package's
`np.asarray` of a device array would.
"""

from __future__ import annotations

import copy
from typing import Dict

import numpy as np
import torch

from .graph.ir import Graph, Node

__all__ = ["graph_from_jax", "params_from_numpy", "to_numpy"]


def _to_tensor(v) -> torch.Tensor:
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, which numpy lacks
        return torch.from_numpy(np.array(a.view(np.int16))).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host array of its dtype; bf16 becomes ml_dtypes'
    bfloat16 (through an int16 view), which is what `np.asarray` of a JAX
    bf16 array gives and what `Tensor.numpy()` refuses."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(params: Dict[str, np.ndarray],
                      device) -> Dict[str, torch.Tensor]:
    """Host arrays -> tensors on `device`, dtype unchanged."""
    return {k: _to_tensor(v).to(device) for k, v in params.items()}


def graph_from_jax(g) -> Graph:
    """A port `Graph` with the same nodes, edges, params, precisions and
    scales as `g` (duck-typed: any object with the JAX `Graph`'s fields)."""
    out = Graph(getattr(g, "name", "net"))
    for name, n in g.nodes.items():
        out.nodes[name] = Node(n.name, n.op, list(n.inputs), list(n.outputs),
                               copy.deepcopy(dict(n.attrs)))
    out.inputs = list(g.inputs)
    out.outputs = list(g.outputs)
    out.input_specs = dict(g.input_specs)
    out.params = dict(g.params)
    out.precisions = dict(g.precisions)
    out.scales = dict(g.scales)
    out.applied_passes = list(getattr(g, "applied_passes", []))
    return out
