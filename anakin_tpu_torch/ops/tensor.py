"""Tensor-layout ops of the ResNet and LLM paths (`anakin_tpu/ops/tensor.py`)."""

from __future__ import annotations

from typing import List

import torch

from .registry import register


@register("reshape")
def reshape(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Reshape to attr `shape`, where a 0 keeps that dim of the input."""
    x = xs[0]
    out = [x.shape[i] if s == 0 else s for i, s in enumerate(node.attr("shape"))]
    return [x.reshape(out)]


@register("flatten")
def flatten(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    axis = int(node.attr("axis", 1))
    x = xs[0]
    return [x.reshape(tuple(x.shape[:axis]) + (-1,))]


@register("space_to_depth")
def space_to_depth(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """NHWC space-to-depth: [n,h,w,c] -> [n,h/b,w/b,b*b*c], channel order
    (dr, dc, c), as the stem rewrite (`graph/passes/stem.py`) expects."""
    x = xs[0]
    b = int(node.attr("block", 2))
    n, h, w_, c = x.shape
    y = x.reshape(n, h // b, b, w_ // b, b, c).permute(0, 1, 3, 2, 4, 5)
    return [y.reshape(n, h // b, w_ // b, b * b * c)]
