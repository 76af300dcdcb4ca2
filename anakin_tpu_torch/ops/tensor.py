"""Tensor ops, the port of `anakin_tpu/ops/tensor.py`: the layout ops move
values and never change them, so they take int8 tensors as they take float
ones; the reductions, `cumsum` and `cast` keep the JAX ops' dtypes."""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from .registry import register

__all__ = ["nchw_axis_to_nhwc", "top_k_lower_index"]

_NCHW_TO_NHWC = {0: 0, 1: 3, 2: 1, 3: 2}


def nchw_axis_to_nhwc(axis: int) -> int:
    """Translate an axis index expressed for NCHW to the NHWC equivalent."""
    return _NCHW_TO_NHWC[axis]


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
    # by a tensor: CUDA divides by a Python number as a product with its
    # reciprocal, a bit off the quotient
    step = torch.arange(div, dtype=torch.float32, device=device) / torch.full(
        (), float(div), device=device)
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


@register("permute")
def permute(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    return [xs[0].permute(*node.attr("order")).contiguous()]


@register("transpose")
def transpose(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """The last two axes swapped."""
    return [xs[0].transpose(-1, -2).contiguous()]


@register("permute_power")
def permute_power(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Fused permute, then (shift + scale * x) ** power."""
    y = xs[0].permute(*node.attr("order"))
    p = float(node.attr("power", 1.0))
    y = float(node.attr("shift", 0.0)) + float(node.attr("scale", 1.0)) * y
    if p != 1.0:
        y = torch.pow(y, p)
    return [y.contiguous()]


@register("split")
def split(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Fan-out: the input itself, once per output (`num`)."""
    return [xs[0]] * int(node.attr("num", len(node.outputs)))


@register("slice_v2")
def slice_v2(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Start / end slicing per axis.  A negative start or end counts from
    the axis's end once, a positive end is clipped to the axis; neither is
    clamped further, as in the reference, so Python's slice rules take what
    is left (a start or end still negative counts from the end again)."""
    x = xs[0]
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(node.attr("axes"), node.attr("starts"), node.attr("ends")):
        dim = x.shape[a]
        s = s + dim if s < 0 else s
        e = e + dim if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    return [x[tuple(idx)]]


def _pad_index(n: int, lo: int, hi: int, mode: str, device) -> torch.Tensor:
    """The source index of each position of an axis of n padded by lo and
    hi: numpy's "reflect" (mirror without the edge, repeated) or "edge"."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge" or n == 1:
        return torch.clamp(i, 0, n - 1)
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j >= n, period - j, j)


@register("pad", "pad2d")
def pad(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """NHWC padding of H, W and C by attrs pad_h / pad_w / pad_c (before,
    after): `mode` constant (with `value`), reflect, or edge (torch's
    replicate), each axis by its own index map."""
    x = xs[0]
    widths = [tuple(node.attr(k, (0, 0))) for k in ("pad_h", "pad_w", "pad_c")]
    mode = node.attr("mode", "constant")
    if mode == "constant":
        (ht, hb), (wl, wr), (c0, c1) = widths
        return [F.pad(x, (c0, c1, wl, wr, ht, hb),
                      value=node.attr("value", 0.0))]
    if mode not in ("reflect", "edge"):
        raise KeyError(mode)
    for axis, (lo, hi) in zip((1, 2, 3), widths):
        if lo or hi:
            x = x.index_select(axis, _pad_index(x.shape[axis], lo, hi, mode,
                                                x.device))
    return [x]


@register("pixel_shuffle")
def pixel_shuffle(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Depth-to-space of NHWC x by `upscale_factor` r, channels split as
    (oc, r, r)."""
    x = xs[0]
    r = int(node.attr("upscale_factor", 2))
    n, h, w_, c = x.shape
    y = x.reshape(n, h, w_, c // (r * r), r, r).permute(0, 1, 4, 2, 5, 3)
    return [y.reshape(n, h * r, w_ * r, c // (r * r))]


@register("expand")
def expand(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Tiled by per-axis factors `expand_times` (`np.tile`'s rule: fewer
    factors than axes tile the last ones)."""
    x = xs[0]
    reps = list(node.attr("expand_times"))
    reps = [1] * (x.dim() - len(reps)) + reps
    return [x.repeat(*reps)]


def _take_fill(dtype: torch.dtype):
    """What `jnp.take` gives for an index out of range: NaN for floats,
    the most negative value of a signed integer, the largest of an
    unsigned one."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


@register("gather")
def gather(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """`jnp.take(x, idx, axis)` in its default mode: an index in [-n, 0)
    counts from the end, any other index outside [0, n) gives the fill
    value (`_take_fill`).  Selected with `index_select` on an index clipped
    into range, so that no index out of range reaches the device."""
    x, idx = xs[0], xs[1].to(torch.int64)
    axis = int(node.attr("axis", 0)) % x.dim()
    n = x.shape[axis]
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    y = x.index_select(axis, torch.where(ok, idx, 0).reshape(-1))
    y = y.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                  + tuple(x.shape[axis + 1:]))
    ok = ok.reshape((1,) * axis + tuple(idx.shape) + (1,) * (x.dim() - axis - 1))
    return [torch.where(ok, y, torch.full((), _take_fill(x.dtype),
                                          dtype=x.dtype, device=x.device))]


@register("cast")
def cast(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """x in the numpy dtype named by `dtype` (float32 by default)."""
    name = node.attr("dtype", "float32")
    if name != "bfloat16":
        name = np.dtype(name).name
    return [xs[0].to(getattr(torch, name))]


@register("one_hot")
def one_hot(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """float32 one-hot rows of `depth`; an index below 0 or from depth on
    gives a row of zeros, as `jax.nn.one_hot` does (where
    `F.one_hot` raises)."""
    depth = int(node.attr("depth"))
    classes = torch.arange(depth, dtype=torch.int64, device=xs[0].device)
    return [(xs[0].to(torch.int32).to(torch.int64)[..., None] == classes)
            .to(torch.float32)]


@register("topk")
def topk(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """`lax.top_k` of the last axis: the k largest values, largest first,
    and their int32 indices, ties toward the lower index."""
    vals, idx = top_k_lower_index(xs[0], int(node.attr("k", 1)))
    return [vals, idx.to(torch.int32)]


def _dims(axes, ndim: int):
    return tuple(axes) if axes else tuple(range(ndim))


@register("reduce", "reduce_min")
def reduce(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """A reduction over `axes` (all when none) by `mode` mean / sum / min /
    max / prod (mean for "reduce", min for "reduce_min" by default), with
    `keep_dims`; in JAX's dtypes: integer sums and products in int32, an
    integer mean in float32."""
    x = xs[0]
    mode = node.attr("mode", "mean" if node.op == "reduce" else "min")
    dims = _dims(node.attr("axes"), x.dim())
    keep = bool(node.attr("keep_dims", False))
    if mode == "mean":
        xf = x if x.is_floating_point() else x.to(torch.float32)
        return [torch.mean(xf, dim=dims, keepdim=keep)]
    if mode in ("min", "max"):
        fn = torch.amin if mode == "min" else torch.amax
        return [fn(x, dim=dims, keepdim=keep)]
    wide = x if x.is_floating_point() else x.to(torch.int64)
    if mode == "sum":
        y = torch.sum(wide, dim=dims, keepdim=keep)
    elif mode == "prod":
        y = wide
        for d in sorted(dims, reverse=True):
            y = torch.prod(y, dim=d, keepdim=keep)
    else:
        raise KeyError(mode)
    return [y if x.is_floating_point() else y.to(torch.int32)]


@register("mean")
def mean(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """The mean of all of x in float32, as a [1] tensor of x's dtype."""
    x = xs[0]
    return [torch.mean(x.to(torch.float32)).reshape(1).to(x.dtype)]


@register("cumsum")
def cumsum(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Cumulative sum along `axis` in x's dtype; `exclusive` shifts it by
    one (0 first); `reverse` sums from the end and, as in the reference,
    then ignores `exclusive`."""
    x = xs[0]
    axis = int(node.attr("axis", -1)) % x.dim()
    if node.attr("reverse", False):
        return [torch.flip(torch.cumsum(torch.flip(x, (axis,)), axis,
                                        dtype=x.dtype), (axis,))]
    y = torch.cumsum(x, axis, dtype=x.dtype)
    if node.attr("exclusive", False):
        y = torch.cat([torch.zeros_like(y.narrow(axis, 0, 1)),
                       y.narrow(axis, 0, x.shape[axis] - 1)], dim=axis)
    return [y]


@register("arithmetic")
def arithmetic(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """a + b, a - b or a * b by `mode` (sum / 1, sub / 2, anything else
    mul)."""
    mode = node.attr("mode", "sum")
    a, b = xs[0], xs[1]
    if mode in ("sum", 1):
        return [a + b]
    if mode in ("sub", 2):
        return [a - b]
    return [a * b]


@register("reverse_input")
def reverse_input(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each input flipped along axis 0."""
    return [torch.flip(x, dims=(0,)) for x in xs]


@register("im2sequence")
def im2sequence(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Conv-style patches of NHWC x as rows: [N OH OW, C KH KW], the columns
    ordered (C, KH, KW) with C major, as `lax.conv_general_dilated_patches`
    orders them (not the (KH, KW, C) of the int8 im2col)."""
    x = xs[0]
    kh, kw = node.attr("window", (1, 1))
    sh, sw = node.attr("strides", (1, 1))
    ph, pw = node.attr("padding", (0, 0))
    n, h, w_, c = x.shape
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (w_ + 2 * pw - kw) // sw + 1
    taps = [xp[:, dy:dy + sh * (oh - 1) + 1:sh, dx:dx + sw * (ow - 1) + 1:sw, :]
            for dy in range(kh) for dx in range(kw)]
    return [torch.stack(taps, dim=-1).reshape(n * oh * ow, c * kh * kw)]


@register("coord2patch")
def coord2patch(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """The reference's stub: the coordinates, unchanged."""
    return [xs[0]]
