"""Op registry: an op is `run(node, xs) -> [torch.Tensor, ...]`, a function
of its input tensors with static attrs from the node (the JAX package's
`anakin_tpu/ops/registry.py`, same names and aliases)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List

__all__ = ["OPS", "ALIASES", "register", "alias", "get_op", "resolve_op_name"]

# op name -> run function: (node, [tensor]) -> [tensor]
OPS: Dict[str, Callable[..., List[Any]]] = {}

# reference (Anakin) op name -> our op name
ALIASES: Dict[str, str] = {}


def register(name: str, *ref_names: str) -> Callable:
    """Register `fn` as the implementation of op `name`; extra positional
    args are reference-framework op names mapped to this op."""

    def deco(fn: Callable) -> Callable:
        if name in OPS:
            raise ValueError(f"op {name!r} already registered")
        OPS[name] = fn
        for ref in ref_names:
            ALIASES[ref.lower()] = name
        return fn

    return deco


def alias(our_name: str, *ref_names: str) -> None:
    """Map reference-framework op names to op `our_name`."""
    for ref in ref_names:
        ALIASES[ref.lower()] = our_name


def resolve_op_name(name: str) -> str:
    if name in OPS:
        return name
    low = name.lower()
    if low in ALIASES:
        return ALIASES[low]
    raise KeyError(f"unknown op: {name!r}")


def get_op(name: str) -> Callable:
    return OPS[resolve_op_name(name)]
