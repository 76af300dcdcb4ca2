"""Tensor-layout ops of the ported paths (`anakin_tpu/ops/tensor.py`): they
move values and never change them, so they take int8 tensors as they take
float ones."""

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


@register("concat")
def concat(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Join along attr `axis`; mixed dtypes promote, as `jnp.concatenate`'s
    do."""
    return [torch.cat(xs, dim=int(node.attr("axis", -1)))]


@register("slice")
def slice_op(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Caffe-style slice along one axis at attr `slice_points`, or into
    equal sections, one per output, when it has none."""
    x = xs[0]
    axis = int(node.attr("axis", -1))
    points = node.attr("slice_points")
    n_out = len(node.outputs)
    if not points:
        size = x.shape[axis] // n_out
        points = [size * (i + 1) for i in range(n_out - 1)]
    return [p.contiguous()
            for p in torch.tensor_split(x, [int(v) for v in points], dim=axis)]


@register("shuffle_channel")
def shuffle_channel(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """ShuffleNet's channel shuffle: NHWC channels as [group, C / group],
    transposed."""
    x = xs[0]
    g = int(node.attr("group", 2))
    n, h, w_, c = x.shape
    y = x.reshape(n, h, w_, g, c // g).transpose(3, 4)
    return [y.reshape(n, h, w_, c)]
