"""Neural-net ops on NHWC activations and HWIO weights: the port of the
ResNet and LLM paths of `anakin_tpu/ops/nn.py`.

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
    x, w, bias, residual = _split_conv_inputs(node, xs)
    axis = int(node.attr("axis", 1))
    lead = tuple(x.shape[:axis])
    xf = x.reshape(math.prod(lead), -1)
    with full_fp32():
        y = torch.matmul(xf.to(torch.float32), w.to(torch.float32))
    y = _epilogue(node, y, bias, residual).reshape(lead + (w.shape[-1],))
    qs = node.attr("quant_out_scale")
    if qs is not None:
        return [_requant(y, qs)]
    return [y.to(x.dtype)]


@register("embedding")
def embedding(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Token embedding lookup; ids equal to `padding_idx` give zero rows."""
    ids, table = xs[0].to(torch.int64), xs[1]
    y = table[torch.clamp_min(ids, 0)]
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
