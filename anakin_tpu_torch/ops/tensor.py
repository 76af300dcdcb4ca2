"""Tensor-layout ops of the ported paths (`anakin_tpu/ops/tensor.py`): they
move values and never change them, so they take int8 tensors as they take
float ones."""

from __future__ import annotations

from typing import List

import torch

from .registry import register

__all__ = ["top_k_lower_index"]


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """An int32 key that sorts floats in IEEE total order (-NaN < -inf <
    ... < -0.0 < +0.0 < ... < inf < NaN), the order `lax.top_k` sorts
    them in; integers are their own key."""
    if not x.is_floating_point():
        return x
    i = x.to(torch.float32).view(torch.int32)
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i)


def top_k_lower_index(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis, largest
    first, as `lax.top_k` gives them: floats in total order (+0.0 above
    -0.0, NaN above everything) and ties toward the lower index
    (`torch.topk` promises no order among equal values)."""
    key = _total_order_key(x)
    if k == 1:  # the first of the largest keys
        idx = torch.argmax(key, dim=-1, keepdim=True)
    else:
        idx = torch.sort(key, dim=-1, descending=True, stable=True).indices[
            ..., :k]
    return torch.gather(x, -1, idx), idx


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


@register("crop")
def crop(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Caffe crop: x cut from `axis` on to attr `shape` or the reference
    tensor's shape (xs[1]), at `offset` (one for every axis, or one per
    axis, missing ones 0)."""
    x = xs[0]
    ref = xs[1] if len(xs) > 1 else None
    axis = int(node.attr("axis", 1))
    target = node.attr("shape") or (tuple(ref.shape) if ref is not None
                                    else None)
    n_axes = x.dim() - axis
    offs = list(node.attr("offset", [0]))
    if len(offs) == 1:
        offs = offs * n_axes
    offs = offs + [0] * (n_axes - len(offs))
    idx = [slice(None)] * x.dim()
    for i, a in enumerate(range(axis, x.dim())):
        idx[a] = slice(offs[i], offs[i] + target[a])
    return [x[tuple(idx)]]


def _resize_out_hw(node, h: int, w: int):
    if node.attr("out_hw"):
        oh, ow = node.attr("out_hw")
        return int(oh), int(ow)
    scale = node.attr("scale", 1.0)
    return (int(round(h * float(node.attr("scale_h", scale)))),
            int(round(w * float(node.attr("scale_w", scale)))))


def _linspace_f32(stop: float, num: int, device) -> torch.Tensor:
    """`jnp.linspace(0.0, stop, num)` in float32, as JAX computes it:
    stop * (i / (num - 1)) for i < num - 1, then stop itself."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / div
    last = torch.full((1,), stop, dtype=torch.float32, device=device)
    return torch.cat([step * stop, last])


@register("resize", "interp")
def resize(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Spatial resize of NHWC x to `out_hw`, or by `scale` / `scale_h` /
    `scale_w` (rounded): nearest (source row i * h // oh), or bilinear in
    float32 with `align_corners` (caffe interp: the corners map onto each
    other) or half-pixel centres; the JAX op's formulas, exactly."""
    x = xs[0]
    _, h, w, _ = x.shape
    oh, ow = _resize_out_hw(node, h, w)
    dev = x.device
    if node.attr("method", "bilinear") == "nearest":
        ih = torch.clamp_max(torch.arange(oh, device=dev) * h // oh, h - 1)
        iw = torch.clamp_max(torch.arange(ow, device=dev) * w // ow, w - 1)
        return [x.index_select(1, ih).index_select(2, iw)]
    xf = x.to(torch.float32)
    if bool(node.attr("align_corners", True)) and oh > 1 and ow > 1:
        fh = _linspace_f32(h - 1.0, oh, dev)
        fw = _linspace_f32(w - 1.0, ow, dev)
    else:
        fh = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) \
            * (h / oh) - 0.5
        fw = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) \
            * (w / ow) - 0.5
    fh = torch.clamp(fh, 0, h - 1)
    fw = torch.clamp(fw, 0, w - 1)
    h0 = torch.floor(fh).to(torch.int64)
    w0 = torch.floor(fw).to(torch.int64)
    h1 = torch.clamp_max(h0 + 1, h - 1)
    w1 = torch.clamp_max(w0 + 1, w - 1)
    ah = (fh - h0)[None, :, None, None]
    aw = (fw - w0)[None, None, :, None]
    r0, r1 = xf.index_select(1, h0), xf.index_select(1, h1)
    top = r0.index_select(2, w0) * (1 - aw) + r0.index_select(2, w1) * aw
    bot = r1.index_select(2, w0) * (1 - aw) + r1.index_select(2, w1) * aw
    return [(top * (1 - ah) + bot * ah).to(x.dtype)]


@register("argmax", "arg_max")
def argmax(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """The indices of the `top_k` largest values along `axis` (over all but
    the batch axis when it is None), in x's dtype, as `lax.top_k` gives
    them (`top_k_lower_index`); with `out_max_val` the values too."""
    x = xs[0]
    top_k = int(node.attr("top_k", 1))
    axis = node.attr("axis")
    moved = x.reshape(x.shape[0], -1) if axis is None else x.movedim(axis, -1)
    vals, idxs = top_k_lower_index(moved, top_k)
    if axis is not None:
        vals, idxs = vals.movedim(-1, axis), idxs.movedim(-1, axis)
    if node.attr("out_max_val", False):
        return [idxs.to(x.dtype), vals]
    return [idxs.to(x.dtype)]
