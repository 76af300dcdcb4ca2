"""Shape inference for the frontends: the port's counterpart of the JAX
frontends' `jax.ShapeDtypeStruct` and `jax.eval_shape`.

A spec is a tensor on PyTorch's `meta` device (a shape and a dtype, no
data), and a node's output specs come from running the port's own op on
its input specs, the route `graph/shape_infer.py` takes.  Dtypes are held
to what JAX gives with 64-bit types off (int64 -> int32, float64 ->
float32, ...), so that every op sees the dtypes it sees under the JAX
frontends.
"""

from typing import List, Sequence

import torch

from ...graph.shape_infer import _meta
from ...ops import get_op

__all__ = ["spec", "eval_shape"]

_JAX_32BIT = {torch.int64: torch.int32, torch.uint64: torch.uint32,
              torch.float64: torch.float32, torch.complex128: torch.complex64}


def _canonical(t: torch.Tensor) -> torch.Tensor:
    dt = _JAX_32BIT.get(t.dtype)
    return t if dt is None else t.to(dt)


def spec(shape: Sequence[int], dtype) -> torch.Tensor:
    """A meta tensor of `shape` and (JAX's 32-bit form of) `dtype`, a
    numpy dtype or its name."""
    return _canonical(_meta([int(s) for s in shape], dtype))


def eval_shape(node, ins: List[torch.Tensor]) -> List[torch.Tensor]:
    """The output specs of `node` on input specs `ins`."""
    return [_canonical(t) for t in get_op(node.op)(node, list(ins))]
