"""Neural-net ops on NHWC activations and HWIO weights: the port of
`anakin_tpu/ops/nn.py`.

Float convolution and dense are plain matrix work that the JAX package
leaves to XLA, so here they go to `F.conv2d` / `torch.matmul`.  Both run in
float32 whatever the activation dtype, as the JAX ops accumulate in float32
(`preferred_element_type`) at "highest" precision: bf16 operands are widened
(their products are exact in float32) and TF32 is kept off: every float32
product of the port's ops runs inside `full_fp32()`, whatever precision the
caller set for the process.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from .registry import register

__all__ = ["apply_activation", "conv_f32", "conv_pads", "pair"]


def apply_activation(y: torch.Tensor, act: Optional[str],
                     alpha: float = 0.0) -> torch.Tensor:
    """Shared activation epilogue, with the JAX package's names."""
    if act is None or act == "identity":
        return y
    if act == "relu":
        return torch.clamp_min(y, 0)
    if act == "relu6":
        return torch.clamp(y, 0, 6)
    if act == "clipped_relu":
        return torch.clamp(y, 0, alpha)
    if act == "leaky_relu":
        return torch.where(y >= 0, y, y * alpha)
    if act == "elu":
        a = alpha if alpha else 1.0
        return torch.where(y >= 0, y, a * (torch.exp(y) - 1))
    if act == "sigmoid":
        return torch.sigmoid(y)
    if act == "tanh":
        return torch.tanh(y)
    if act == "swish":
        return y * torch.sigmoid((alpha if alpha else 1.0) * y)
    if act == "gelu":
        return F.gelu(y, approximate="tanh")  # jax.nn.gelu's default
    if act == "soft_sign":
        return y / (1.0 + torch.abs(y))
    if act == "softplus":
        return F.softplus(y)
    if act == "abs":
        return torch.abs(y)
    raise ValueError(f"unknown activation: {act!r}")


def _epilogue(node, y, bias, residual):
    """bias -> residual-add -> activation, all in accumulator dtype."""
    if bias is not None:
        y = y + bias.to(y.dtype)
    if residual is not None:
        y = y + residual.to(y.dtype)
    return apply_activation(y, node.attr("activation"), node.attr("act_alpha", 0.0))


def pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def conv_pads(node, in_hw, k_hw) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((top, bottom), (left, right)) pads of a conv node: "SAME" / "VALID"
    (XLA's rule), symmetric (ph, pw), or explicit asymmetric pairs."""
    pad = node.attr("padding", (0, 0))
    if isinstance(pad, str):
        if pad.upper() == "VALID":
            return (0, 0), (0, 0)
        strides = pair(node.attr("strides", (1, 1)))
        dil = pair(node.attr("dilation", (1, 1)))
        out = []
        for n, k, s, d in zip(in_hw, k_hw, strides, dil):
            total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
            out.append((total // 2, total - total // 2))
        return tuple(out)
    if (isinstance(pad, (tuple, list)) and len(pad) == 2
            and isinstance(pad[0], (tuple, list))):
        return tuple(int(v) for v in pad[0]), tuple(int(v) for v in pad[1])
    ph, pw = pair(pad)
    return (ph, ph), (pw, pw)


def _split_conv_inputs(node, xs):
    """inputs = [x, w] + [bias]? + [residual]? according to node flags."""
    it = iter(xs)
    x, w = next(it), next(it)
    bias = next(it) if node.attr("has_bias") else None
    residual = next(it) if node.attr("has_residual") else None
    return x, w, bias, residual


@contextlib.contextmanager
def full_fp32():
    """Float32 matmuls and cuDNN convolutions in full float32 inside the
    block (TF32 off), whatever the caller set with
    `torch.set_float32_matmul_precision` or `torch.backends.*.allow_tf32`;
    the caller's settings come back on exit."""
    prev = torch.get_float32_matmul_precision()
    cudnn = torch.backends.cudnn
    torch.set_float32_matmul_precision("highest")
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _requant(y: torch.Tensor, qs) -> torch.Tensor:
    """Requant of a float producer that feeds an all-int8 region: the op
    path's divide, not the kernels' reciprocal multiply."""
    return torch.clamp(torch.round(y / float(qs)), -127, 127).to(torch.int8)


def conv_f32(node, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The node's convolution of NHWC x by HWIO w (strides, dilation,
    padding and groups as the node says), both widened to float32, with
    TF32 off: float32 NHWC."""
    (pt, pb), (pl, pr) = conv_pads(node, x.shape[1:3], w.shape[:2])
    xt = F.pad(x.to(torch.float32).permute(0, 3, 1, 2), (pl, pr, pt, pb))
    with full_fp32():
        y = F.conv2d(xt, w.to(torch.float32).permute(3, 2, 0, 1),
                     stride=pair(node.attr("strides", (1, 1))),
                     dilation=pair(node.attr("dilation", (1, 1))),
                     groups=int(node.attr("groups", 1)))
    return y.permute(0, 2, 3, 1)


@register("conv2d", "convolution", "conv_act", "conv_relu", "conv_eltwise",
          "conv_batchnorm_scale_relu", "conv_fusion", "depwise_sep_convolution")
def conv2d(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """2D convolution with fused bias/residual/activation epilogue and the
    optional `quant_out_scale` requant.  x: NHWC, w: HWIO."""
    x, w, bias, residual = _split_conv_inputs(node, xs)
    y = _epilogue(node, conv_f32(node, x, w), bias, residual)
    qs = node.attr("quant_out_scale")
    if qs is not None:
        return [_requant(y, qs).contiguous()]
    return [y.to(x.dtype).contiguous()]


@register("deconv2d", "deconvolution", "deconv_relu", "deconv_batchnorm_scale",
          "deconv_batchnorm_scale_relu")
def deconv2d(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Transposed convolution, caffe output size `(in - 1) * stride +
    kernel - 2 * pad`, then the epilogue; w: HWIO with O the output
    channels of a group.  The JAX op's formula, exactly: x dilated by the
    stride (zeros between its pixels), padded by kernel - 1 - pad a side
    (a negative pad crops), then convolved with the flipped kernel at the
    node's dilation, in float32 with TF32 off."""
    x, w, bias, residual = _split_conv_inputs(node, xs)
    sh, sw = pair(node.attr("strides", (1, 1)))
    dh, dw = pair(node.attr("dilation", (1, 1)))
    ph, pw = pair(node.attr("padding", (0, 0)))
    groups = int(node.attr("groups", 1))
    kh, kw = int(w.shape[0]), int(w.shape[1])
    if groups != 1:
        # (kh, kw, in, out per group) -> (kh, kw, in per group, groups *
        # out per group), output channels group-major
        in_total, opg = int(w.shape[2]), int(w.shape[3])
        w = w.reshape(kh, kw, groups, in_total // groups, opg).permute(
            0, 1, 3, 2, 4).reshape(kh, kw, in_total // groups, groups * opg)
    n, h, w_, c = x.shape
    xd = torch.zeros((n, c, (h - 1) * sh + 1, (w_ - 1) * sw + 1),
                     dtype=torch.float32, device=x.device)
    xd[:, :, ::sh, ::sw] = x.to(torch.float32).permute(0, 3, 1, 2)
    pt, pl = kh - 1 - ph, kw - 1 - pw
    xd = F.pad(xd, (pl, pl, pt, pt))
    wf = torch.flip(w.to(x.dtype), (0, 1)).to(torch.float32).permute(3, 2, 0, 1)
    with full_fp32():
        y = F.conv2d(xd, wf, dilation=(dh, dw), groups=groups)
    y = _epilogue(node, y.permute(0, 2, 3, 1), bias, residual)
    return [y.to(x.dtype).contiguous()]


def _pool_out_dim(in_dim: int, k: int, s: int, p: int, ceil_mode: bool) -> int:
    if ceil_mode:
        return int(math.ceil((in_dim + 2 * p - k) / s)) + 1
    return int(math.floor((in_dim + 2 * p - k) / s)) + 1


def _windows(x, kh, kw, sh, sw, oh, ow):
    """The kh*kw strided views of a padded NHWC tensor, one per tap."""
    return [x[:, dy:dy + sh * (oh - 1) + 1:sh, dx:dx + sw * (ow - 1) + 1:sw, :]
            for dy in range(kh) for dx in range(kw)]


@register("pool2d", "pooling", "conv_relu_pool", "conv_batchnorm_scale_relu_pool")
def pool2d(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Max/avg pooling with caffe ceil-mode output sizing.  One code path
    for every device and dtype: pad with the identity of the reduction,
    then reduce over the kh*kw strided views (int8 max pooling included)."""
    x = xs[0]
    mode = node.attr("mode", "max")
    if node.attr("global_pooling", False):
        if mode == "max":
            return [torch.amax(x, dim=(1, 2), keepdim=True)]
        return [torch.mean(x.to(torch.float32), dim=(1, 2), keepdim=True)
                .to(x.dtype)]
    kh, kw = pair(node.attr("window", (2, 2)))
    sh, sw = pair(node.attr("strides", (2, 2)))
    pad = node.attr("padding", (0, 0))
    _, h, w_, _ = x.shape
    if (isinstance(pad, (tuple, list)) and len(pad) == 2
            and isinstance(pad[0], (tuple, list))):
        (pt, pb), (pl, pr) = ((int(a), int(b)) for a, b in pad)
    else:
        ph, pw = pair(pad)
        ceil_mode = bool(node.attr("ceil_mode", True))
        oh = _pool_out_dim(h, kh, sh, ph, ceil_mode)
        ow = _pool_out_dim(w_, kw, sw, pw, ceil_mode)
        # extra bottom/right padding so the windows give the ceil-mode size
        pt, pb = ph, ph + max(0, (oh - 1) * sh + kh - h - 2 * ph)
        pl, pr = pw, pw + max(0, (ow - 1) * sw + kw - w_ - 2 * pw)
    oh = (h + pt + pb - kh) // sh + 1
    ow = (w_ + pl + pr - kw) // sw + 1
    pads = (0, 0, pl, pr, pt, pb)
    if mode == "max":
        fill = (float("-inf") if x.is_floating_point()
                else torch.iinfo(x.dtype).min)
        views = _windows(F.pad(x, pads, value=fill), kh, kw, sh, sw, oh, ow)
        y = views[0]
        for v in views[1:]:
            y = torch.maximum(y, v)
        return [y.contiguous()]
    xf = F.pad(x.to(torch.float32), pads)
    ysum = sum(_windows(xf, kh, kw, sh, sw, oh, ow))
    if node.attr("exclusive", True):
        ones = F.pad(torch.ones((1, h, w_, 1), device=x.device), pads)
        cnt = sum(_windows(ones, kh, kw, sh, sw, oh, ow))
        return [(ysum / cnt).to(x.dtype)]
    return [(ysum / float(kh * kw)).to(x.dtype)]


@register("dense", "fc", "dense_dense")
def dense(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Fully-connected with fused epilogue; x flattened from `axis`,
    w: (in, out)."""
    x, w = xs[0], xs[1]
    xf = x.reshape(math.prod(x.shape[:int(node.attr("axis", 1))]), -1)
    with full_fp32():
        y = torch.matmul(xf.to(torch.float32), w.to(torch.float32))
    return [y if node.attr("partial_out", False) else finish_dense(node, y, xs)]


def finish_dense(node, y: torch.Tensor, xs: List[torch.Tensor]) -> torch.Tensor:
    """The end of a dense op (`dense`, `dense_w8`, `dense_w4`) on its
    float32 product y [rows, out] (`dense_w8`'s scale applied): bias ->
    residual -> activation, x's lead dims back, then a `dense`'s requant
    (attr `quant_out_scale`) or x's dtype.  With attr `partial_out` the ops
    return y itself: a tensor-parallel rank's partial product over its rows
    of w, which the rank all-reduces and then finishes here."""
    x = xs[0]
    rest = iter(xs[3 if node.op in ("dense_w8", "dense_w4") else 2:])
    bias = next(rest) if node.attr("has_bias") else None
    residual = next(rest) if node.attr("has_residual") else None
    lead = tuple(x.shape[:int(node.attr("axis", 1))])
    y = _epilogue(node, y, bias, residual).reshape(lead + (y.shape[-1],))
    qs = node.attr("quant_out_scale")
    if qs is not None and node.op not in ("dense_w8", "dense_w4"):
        return _requant(y, qs)
    return y.to(x.dtype)


@register("embedding")
def embedding(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Token embedding lookup; ids equal to `padding_idx` give zero rows."""
    ids, table = xs[0].to(torch.int64), xs[1]
    y = table.index_select(0, torch.clamp_min(ids, 0).reshape(-1)).reshape(
        tuple(ids.shape) + tuple(table.shape[1:]))
    pad_idx = node.attr("padding_idx", -1)
    if pad_idx is not None and pad_idx >= 0:
        y = torch.where((ids == pad_idx)[..., None], torch.zeros((), dtype=y.dtype,
                                                                 device=y.device), y)
    return [y]


@register("batch_norm", "batchnorm")
def batch_norm(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Inference BN: (x - mean) / sqrt(var + eps).  inputs: x, mean, var."""
    x, mean, var = xs[0], xs[1], xs[2]
    eps = float(node.attr("eps", 1e-5))
    inv = torch.rsqrt(var.to(torch.float32) + eps)
    return [((x.to(torch.float32) - mean) * inv).to(x.dtype)]


def _broadcast_trailing(p: torch.Tensor, ndim: int) -> torch.Tensor:
    return p.to(torch.float32).reshape((1,) * (ndim - p.dim()) + tuple(p.shape))


@register("layer_norm")
def layer_norm(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """LayerNorm over the axes from `begin_norm_axis` on, in float32.
    inputs: x, gamma, beta."""
    x, gamma, beta = xs[0], xs[1], xs[2]
    axis_from = int(node.attr("begin_norm_axis", -1))
    dims = tuple(range(axis_from if axis_from >= 0 else x.dim() + axis_from,
                       x.dim()))
    eps = float(node.attr("eps", 1e-5))
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=dims, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=dims, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * _broadcast_trailing(gamma, x.dim()) + _broadcast_trailing(beta, x.dim())
    return [y.to(x.dtype)]


@register("rms_norm")
def rms_norm(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """RMSNorm over the last axis, x * g / rms(x), in float32 (the llama
    recipe's norm).  inputs: x, gamma."""
    x, gamma = xs[0], xs[1]
    eps = float(node.attr("eps", 1e-6))
    xf = x.to(torch.float32)
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * _broadcast_trailing(gamma, x.dim())
    return [y.to(x.dtype)]


@register("scale", "batchnorm_scale")
def scale_op(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Per-channel y = x * gamma (+ beta), channel axis last."""
    x = xs[0]
    y = x * xs[1].to(x.dtype)
    if len(xs) > 2 and node.attr("bias_term", True):
        y = y + xs[2].to(x.dtype)
    return [y]


@register("activation", "relu", "elu", "prelu_op")
def activation(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    return [apply_activation(xs[0], node.attr("activation", "relu"),
                             node.attr("act_alpha", 0.0))]


@register("softmax")
def softmax(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    x = xs[0]
    return [torch.softmax(x.to(torch.float32), dim=int(node.attr("axis", -1)))
            .to(x.dtype)]


@register("eltwise", "eltwise_op", "eltwise_relu", "eltwise_prelu", "eltwise_act")
def eltwise(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """N-ary elementwise combine: sum (with coeffs) / prod / max / min /
    sub / div, then the activation."""
    mode = node.attr("mode", "sum")
    coeffs = node.attr("coeffs")
    ys = list(xs)
    if mode in ("sum", "add"):
        if coeffs:
            y = sum(c * v for c, v in zip(coeffs, ys))
        else:
            y = ys[0]
            for v in ys[1:]:
                y = y + v
    elif mode in ("prod", "mul"):
        y = ys[0]
        for v in ys[1:]:
            y = y * v
    elif mode == "max":
        y = ys[0]
        for v in ys[1:]:
            y = torch.maximum(y, v)
    elif mode == "min":
        y = ys[0]
        for v in ys[1:]:
            y = torch.minimum(y, v)
    elif mode == "sub":
        y = ys[0] - ys[1]
    elif mode == "div":
        y = ys[0] / ys[1]
    else:
        raise ValueError(f"unknown eltwise mode {mode!r}")
    return [apply_activation(y, node.attr("activation"), node.attr("act_alpha", 0.0))]


@register("lrn")
def lrn(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Local response norm across channels, in float32: x / (k + alpha /
    size * sum of x^2 over a window of `local_size` channels) ** beta, the
    window zero-padded by size // 2 below and the rest above."""
    x = xs[0]
    size = int(node.attr("local_size", 5))
    alpha = float(node.attr("alpha", 1e-4))
    beta = float(node.attr("beta", 0.75))
    k = float(node.attr("k", 1.0))
    xf = x.to(torch.float32)
    half = size // 2
    sq = F.pad(xf * xf, (half, size - 1 - half))
    c = x.shape[-1]
    acc = sq[..., 0:c]
    for i in range(1, size):
        acc = acc + sq[..., i:i + c]
    y = xf / torch.pow(k + (alpha / size) * acc, beta)
    return [y.to(x.dtype)]


@register("dropout")
def dropout(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Inference dropout: the identity, or x * `scale` where a model was
    trained without inverted dropout (`scale` != 1)."""
    scale = float(node.attr("scale", 1.0))
    y = xs[0]
    if scale != 1.0:
        y = y * scale
    return [y]


@register("l2_normalize", "normalize")
def l2_normalize(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """L2 (or, with p = 1, L1) normalization across the channels, or
    across C, H and W with `across_spatial`, in float32, then the optional
    per-channel scale (SSD's Norm layer): x * rsqrt(sum x^2 + eps) or
    x / (sum |x| + eps)."""
    x = xs[0]
    scale_w = xs[1] if len(xs) > 1 else None
    eps = float(node.attr("eps", 1e-6))
    dims = (1, 2, 3) if bool(node.attr("across_spatial", False)) else (3,)
    xf = x.to(torch.float32)
    if int(node.attr("p", 2)) == 1:
        y = xf / (torch.sum(torch.abs(xf), dim=dims, keepdim=True) + eps)
    else:
        y = xf * torch.rsqrt(torch.sum(xf * xf, dim=dims, keepdim=True) + eps)
    if scale_w is not None:
        y = y * scale_w
    return [y.to(x.dtype)]


@register("pool2d_with_index", "pooling_with_index")
def pool2d_with_index(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Max pooling that also gives each maximum's flat spatial index h W + w
    (int32), the windows padded with (-inf, -1); a later tap replaces the
    kept one only when strictly larger, so a tie keeps the first in window
    order."""
    x = xs[0]
    kh, kw = pair(node.attr("window", (2, 2)))
    sh, sw = pair(node.attr("strides", (2, 2)))
    ph, pw = pair(node.attr("padding", (0, 0)))
    n, h, w_, c = x.shape
    idx = (torch.arange(h, dtype=torch.int32, device=x.device)[:, None] * w_
           + torch.arange(w_, dtype=torch.int32, device=x.device)[None, :])
    idx = idx[None, :, :, None].expand(n, h, w_, c)
    pads = (0, 0, pw, pw, ph, ph)
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (w_ + 2 * pw - kw) // sw + 1
    vals = _windows(F.pad(x, pads, value=float("-inf")), kh, kw, sh, sw, oh, ow)
    idxs = _windows(F.pad(idx, pads, value=-1), kh, kw, sh, sw, oh, ow)
    yv = torch.full((n, oh, ow, c), float("-inf"), dtype=x.dtype,
                    device=x.device)
    yi = torch.full((n, oh, ow, c), -1, dtype=torch.int32, device=x.device)
    for v, i in zip(vals, idxs):
        take = v > yv
        yv = torch.where(take, v, yv)
        yi = torch.where(take, i, yi)
    return [yv, yi]


@register("unpool2d", "unpool")
def unpool2d(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Max unpooling: each value of y [N, H, W, C] added into an [N, OH,
    OW, C] map of zeros at its saved flat spatial index (`out_hw`), a
    scatter-add as the JAX op's `.at[].add`: overlapping windows add into
    one cell, a negative index counts from the end, an index still out of
    range is dropped.  On CUDA, `scatter_add_` adds in no fixed order."""
    y, idx = xs[0], xs[1]
    oh, ow = pair(node.attr("out_hw"))
    n, h, w_, c = y.shape
    size = oh * ow
    i = idx.reshape(n, h * w_, c).to(torch.int64)
    i = torch.where(i < 0, i + size, i)
    ok = (i >= 0) & (i < size)
    vals = torch.where(ok, y.reshape(n, h * w_, c),
                       torch.zeros((), dtype=y.dtype, device=y.device))
    out = torch.zeros((n, size, c), dtype=y.dtype, device=y.device)
    out.scatter_add_(1, torch.where(ok, i, 0), vals)
    return [out.reshape(n, oh, ow, c)]


@register("spp")
def spp(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Spatial pyramid pooling: at each level l < `pyramid_height`, 2^l x
    2^l bins of ceil(H / 2^l) x ceil(W / 2^l) (padded at the bottom and
    right), max or average, each flattened (NHWC order) and concatenated.
    The average divides by the whole bin, padding included, as the
    reference does."""
    x = xs[0]
    levels = int(node.attr("pyramid_height", 3))
    mode = node.attr("mode", "max")
    n, h, w_, _ = x.shape
    outs = []
    for lvl in range(levels):
        bins = 2 ** lvl
        kh, kw = math.ceil(h / bins), math.ceil(w_ / bins)
        pads = (0, 0, 0, bins * kw - w_, 0, bins * kh - h)
        if mode == "max":
            views = _windows(F.pad(x, pads, value=float("-inf")), kh, kw, kh,
                             kw, bins, bins)
            y = views[0]
            for v in views[1:]:
                y = torch.maximum(y, v)
        else:
            views = _windows(F.pad(x.to(torch.float32), pads), kh, kw, kh, kw,
                             bins, bins)
            y = (sum(views) / float(kh * kw)).to(x.dtype)
        outs.append(y.reshape(n, -1))
    return [torch.cat(outs, dim=1)]


@register("matmul", "mat_mul", "aligned_mat_mul", "batch_gemm", "gemm")
def matmul(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """(Batched) a @ b with optional transposes (`transpose_a`,
    `transpose_b`), b cast to a's dtype, in float32 with TF32 off, times
    `coeff`, then the activation, in a's dtype."""
    a, b = xs[0], xs[1]
    if node.attr("transpose_a", False):
        a = a.transpose(-1, -2)
    if node.attr("transpose_b", False):
        b = b.transpose(-1, -2)
    with full_fp32():
        y = torch.matmul(a.to(torch.float32), b.to(a.dtype).to(torch.float32))
    coeff = node.attr("coeff", 1.0)
    if coeff != 1.0:
        y = y * coeff
    return [apply_activation(y, node.attr("activation"),
                             node.attr("act_alpha", 0.0)).to(a.dtype)]


@register("group_norm")
def group_norm(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """GroupNorm of NHWC x over `groups` channel groups (and H, W), in
    float32, then the optional per-channel gamma and beta."""
    x = xs[0]
    groups = int(node.attr("groups", 32))
    eps = float(node.attr("eps", 1e-5))
    n, h, w_, c = x.shape
    xf = x.to(torch.float32).reshape(n, h, w_, groups, c // groups)
    mu = torch.mean(xf, dim=(1, 2, 4), keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=(1, 2, 4), keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(n, h, w_, c)
    if len(xs) > 1:
        y = y * xs[1]
    if len(xs) > 2:
        y = y + xs[2]
    return [y.to(x.dtype)]


@register("mvn")
def mvn(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Mean-variance normalization over H, W (and C with
    `across_channels`), in float32."""
    x = xs[0]
    dims = (1, 2, 3) if bool(node.attr("across_channels", False)) else (1, 2)
    xf = x.to(torch.float32)
    y = xf - torch.mean(xf, dim=dims, keepdim=True)
    if bool(node.attr("normalize_variance", True)):
        var = torch.mean(torch.square(y), dim=dims, keepdim=True)
        y = y * torch.rsqrt(var + float(node.attr("eps", 1e-9)))
    return [y.to(x.dtype)]


@register("prelu")
def prelu(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """PReLU with a learned slope per channel (last axis) or one shared
    (`channel_shared`)."""
    x, slope = xs[0], xs[1]
    if node.attr("channel_shared", False):
        a = slope.reshape(())
    else:
        a = slope.reshape((1,) * (x.dim() - 1) + (-1,))
    return [torch.where(x >= 0, x, x * a.to(x.dtype))]


@register("axpy")
def axpy(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """a * x + b, a broadcast (SENet-style channel re-weighting)."""
    a, x, b = xs[0], xs[1], xs[2]
    return [a * x + b]


@register("power")
def power(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """(shift + scale * x) ** power."""
    p = float(node.attr("power", 1.0))
    y = float(node.attr("shift", 0.0)) + float(node.attr("scale", 1.0)) * xs[0]
    if p != 1.0:
        y = torch.pow(y, p)
    return [y]


@register("exp")
def exp_op(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    return [torch.exp(xs[0])]


@register("log")
def log_op(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    return [torch.log(xs[0])]


@register("erf")
def erf_op(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """The Gauss error function (ONNX GELU decompositions)."""
    return [torch.erf(xs[0])]


@register("cos_sim")
def cos_sim(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Cosine similarity along the last axis, in float32: a . b /
    (sqrt(|a|^2 |b|^2) + 1e-12), in the first input's dtype."""
    a, b = xs[0].to(torch.float32), xs[1].to(torch.float32)
    num = torch.sum(a * b, dim=-1)
    den = torch.sqrt(torch.sum(a * a, dim=-1) * torch.sum(b * b, dim=-1)) + 1e-12
    return [(num / den).to(xs[0].dtype)]


@register("dot")
def dot_op(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Row-wise dot product along the last axis, kept as a size-1 axis."""
    return [torch.sum(xs[0] * xs[1], dim=-1, keepdim=True)]


@register("maxout")
def maxout(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Channel maxout: the max over each run of `groups` adjacent channels
    of NHWC x."""
    x = xs[0]
    groups = int(node.attr("groups", 2))
    n, h, w_, c = x.shape
    return [torch.amax(x.reshape(n, h, w_, c // groups, groups), dim=-1)]
