"""int8 and weight-only ops: the port of the ResNet and LLM paths of
`anakin_tpu/ops/quantized.py`.

Scale conventions (as in the JAX package):
  int8 value  = clip(round(fp / scale), -127, 127), half-to-even
  activation scale: per-tensor float; weight scale: per-output-channel
  dequant: acc_int32 * (in_scale * w_scale[oc])

PyTorch has no int8 convolution on CUDA, so every int8 conv and dense goes
through the port's int8 kernels, whatever the node's `impl` attribute says
(this port has no XLA lowering to choose):
  "gemm" kind (1x1 s1 p0) and dense_int8  -> matmul_int8
  "conv3x3" kind (3x3 s1 p1)              -> conv3x3_int8
  "dw3x3" kind with a [3, 3, 1, C] weight
  over C channels and no residual
  (depthwise 3x3 p1, stride 1 or 2)       -> depthwise3x3_int8
  any other dense conv (strided, padded
  otherwise, other kernel sizes)          -> int8 im2col, then matmul_int8
  a grouped 1x1 s1 p0 conv (ShuffleNet)   -> matmul_int8 once per group, on
                                             the group's channel slice
  any other grouped conv (a grouped 3x3,
  a depthwise conv with a residual, other
  kernel sizes)                           -> int8 im2col of each group's
                                             channels, then matmul_int8 once
                                             per group
Each group's product is the dense route's on that group's channels, so a
grouped conv computes what the JAX package's XLA route computes
(`lax.conv_general_dilated(feature_group_count=groups)` with int32
accumulation) under the kernels' epilogue numerics.
On a CPU tensor the kernels run their plain versions.  `matmul_int8` and
`conv3x3_int8` read their weight as [N][K]; `prepare_int8_weights` makes
that copy of every such weight once (a `Net` does, when it is built), one
copy a group for the grouped convs, and the two ops take it as
`prepared`.

The weight-only ops keep activations in float: `dense_w8` and `conv2d_w8`
(int8 weights, per-output-channel scale after the product) are a plain
float32 matmul and convolution, as the JAX package leaves them to XLA;
`dense_w4` (nibble-packed int4 weights, group-wise scales) always goes
through `matmul_w4`.  It routes as the JAX
package does: `variant="v2"` on an `impl="pallas"` node runs v2, and every
other node v1, since the JAX package reads `variant` on its Pallas route
only and its XLA route computes v1's function (the float32 scale times the
int4 value, rounded to the activation dtype, then a float32-accumulated
product; v2 rounds the scale to the activation dtype first).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..kernels.conv_int8 import conv3x3_int8
from ..kernels.depthwise_int8 import depthwise3x3_int8
from ..kernels.matmul_int8 import PreparedB, matmul_int8, prepare_b
from ..kernels.matmul_w4 import matmul_w4
from .nn import _epilogue, conv_f32, conv_pads, full_fp32, pair, pool2d
from .registry import register

__all__ = ["quantize_array", "dequantize_array", "conv_kind",
           "prepare_int8_weights", "PreparedGroups"]


def quantize_array(x: torch.Tensor, scale) -> torch.Tensor:
    """fp -> int8 with round-half-to-even and symmetric clip to ±127."""
    q = torch.round(x.to(torch.float32) / scale)
    return torch.clamp(q, -127, 127).to(torch.int8)


def dequantize_array(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale


@register("quantize")
def quantize(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    return [quantize_array(xs[0], float(node.attr("scale")))]


@register("dequantize")
def dequantize(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    dtype = getattr(torch, node.attr("dtype", "float32"))
    return [dequantize_array(xs[0], float(node.attr("scale"))).to(dtype)]


def _split_q_inputs(node, xs):
    """inputs = [x, w, w_scale] + [bias]? + [residual]?"""
    it = iter(xs)
    x, w, w_scale = next(it), next(it), next(it)
    bias = next(it) if node.attr("has_bias") else None
    residual = next(it) if node.attr("has_residual") else None
    return x, w, w_scale, bias, residual


def conv_kind(node) -> str:
    """"gemm" (1x1 s1 p0 shape class), "conv3x3" (s1 p1), "dw3x3" (grouped
    3x3 p1, stride 1/2) or "other": the JAX package's `_conv_kind`."""
    sh, sw = pair(node.attr("strides", (1, 1)))
    dh, dw = pair(node.attr("dilation", (1, 1)))
    pad = node.attr("padding", (0, 0))
    if isinstance(pad, str) or (isinstance(pad, (tuple, list)) and len(pad)
                                and isinstance(pad[0], (tuple, list))):
        return "other"
    ph, pw = pair(pad)
    if (dh, dw) != (1, 1):
        return "other"
    if int(node.attr("groups", 1)) > 1:
        if (ph, pw) == (1, 1) and sh == sw and sh in (1, 2):
            return "dw3x3"
        return "other"
    if (sh, sw) != (1, 1):
        return "other"
    if (ph, pw) == (0, 0):
        return "gemm"
    if (ph, pw) == (1, 1):
        return "conv3x3"
    return "other"


def _epilogue_kwargs(node, in_scale):
    out_scale = node.attr("out_scale")
    return dict(
        in_scale=in_scale,
        activation=node.attr("activation"),
        act_alpha=float(node.attr("act_alpha", 0.0)),
        out_scale=None if out_scale is None else float(out_scale),
        out_dtype=getattr(torch, node.attr("out_dtype", "float32")),
        residual_scale=node.attr("residual_scale"),
    )


def _im2col(x, kh, kw, strides, dilation, pads):
    """int8 [N, H, W, C] -> [N, OH, OW, kh*kw*C] patches in (dy, dx, c)
    order, which matches an HWIO weight reshaped to [kh*kw*C, O]."""
    (pt, pb), (pl, pr) = pads
    sh, sw = strides
    dh, dw = dilation
    if (pt, pb, pl, pr) != (0, 0, 0, 0):
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
    _, h, w_, _ = x.shape
    oh = (h - dh * (kh - 1) - 1) // sh + 1
    ow = (w_ - dw * (kw - 1) - 1) // sw + 1
    cols = [x[:, dy * dh:dy * dh + sh * (oh - 1) + 1:sh,
              dx * dw:dx * dw + sw * (ow - 1) + 1:sw, :]
            for dy in range(kh) for dx in range(kw)]
    return (cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)).contiguous()


class PreparedGroups(NamedTuple):
    """A grouped int8 conv's weight prepared one group at a time: `parts[j]`
    is `prepare_b` of group j's [kh, kw, C / groups, O / groups] slice;
    `source` is the whole weight."""

    parts: Tuple[PreparedB, ...]
    source: torch.Tensor


def _depthwise_kernel(node, w, residual: bool) -> bool:
    """Whether a grouped int8 conv takes `depthwise3x3_int8`: the JAX
    package's conditions (`anakin_tpu/ops/quantized.py:182-183`), a "dw3x3"
    node with a [3, 3, 1, C] weight over C channels (groups = C) and no
    residual."""
    return (conv_kind(node) == "dw3x3" and tuple(w.shape[:3]) == (3, 3, 1)
            and int(node.attr("groups", 1)) == w.shape[3] and not residual)


def _group_slices(w, groups: int):
    og = w.shape[3] // groups
    return [slice(j * og, (j + 1) * og) for j in range(groups)]


def prepare_int8_weights(nodes, params: Dict[str, torch.Tensor],
                         by_edge: Optional[Dict[str, object]] = None
                         ) -> Dict[str, object]:
    """{node name: prepared weight} for every int8 conv and dense of
    `nodes` that runs on `matmul_int8` or `conv3x3_int8` (every one but the
    depthwise convs on `depthwise3x3_int8`; a grouped conv gets a
    `PreparedGroups`), each weight prepared once however many nodes share
    it.  `by_edge` ({weight edge: prepared weight}) holds weights prepared
    before, which are reused, and takes the ones prepared now."""
    by_edge = {} if by_edge is None else by_edge
    out = {}
    for node in nodes:
        if node.op not in ("conv2d_int8", "dense_int8"):
            continue
        e = node.inputs[1]
        groups = int(node.attr("groups", 1)) if node.op == "conv2d_int8" else 1
        if groups != 1 and _depthwise_kernel(node, params[e],
                                             node.attr("has_residual")):
            continue
        if e not in by_edge:
            w = params[e]
            by_edge[e] = (prepare_b(w) if groups == 1 else PreparedGroups(
                tuple(prepare_b(w[..., s]) for s in _group_slices(w, groups)),
                w))
        out[node.name] = by_edge[e]
    return out


def _weight(node, w: torch.Tensor, prepared):
    """The weight the kernel takes: the prepared copy made for `w`, or `w`."""
    if prepared is None:
        return w
    if prepared.source is not w:
        raise ValueError(f"{node.name}: the prepared weight was made for "
                         f"another tensor than the node's weight")
    return prepared


def _grouped_conv(node, x, w, w_scale, bias, residual, prepared, kw):
    """A grouped int8 conv that is not the depthwise kernel's: each group's
    channels through the dense route (1x1 s1 p0 as they are, any other conv
    by int8 im2col), then `matmul_int8` once per group, the outputs joined
    along the channels."""
    groups = int(node.attr("groups", 1))
    cg, (kh, kw_) = w.shape[2], (int(w.shape[0]), int(w.shape[1]))
    if x.shape[3] != cg * groups or w.shape[3] % groups:
        raise ValueError(f"{node.name}: {x.shape[3]} input channels and weight "
                         f"{tuple(w.shape)} do not make {groups} groups")
    gemm = conv_kind(node) == "gemm" and (kh, kw_) == (1, 1)
    pads = conv_pads(node, x.shape[1:3], (kh, kw_))
    ys = []
    for j, s in enumerate(_group_slices(w, groups)):
        xj = x[..., j * cg:(j + 1) * cg]
        cols = xj.contiguous() if gemm else _im2col(
            xj, kh, kw_, pair(node.attr("strides", (1, 1))),
            pair(node.attr("dilation", (1, 1))), pads)
        n, oh, ow = cols.shape[:3]
        og = s.stop - s.start
        y = matmul_int8(
            cols.reshape(n * oh * ow, -1),
            w[..., s].reshape(-1, og) if prepared is None else prepared.parts[j],
            w_scale[s].contiguous(),
            None if bias is None else bias[s].contiguous(),
            None if residual is None
            else residual[..., s].reshape(-1, og).contiguous(),
            **kw)
        ys.append(y.reshape(n, oh, ow, og))
    return torch.cat(ys, dim=-1)


@register("conv2d_int8")
def conv2d_int8(node, xs: List[torch.Tensor],
                prepared: Union[PreparedB, PreparedGroups, None] = None
                ) -> List[torch.Tensor]:
    """int8 conv with the fused dequant/bias/residual/act/requant epilogue.
    x: NHWC int8 (or float, quantized here with `in_scale`), w: HWIO int8,
    w_scale: [O] per-output-channel scale.  A residual stays int8 when it
    is and is dequantized inside the kernel with `residual_scale`.
    `prepared`: `prepare_int8_weights`'s copy of w, made once by the
    caller."""
    x, w, w_scale, bias, residual = _split_q_inputs(node, xs)
    in_scale = float(node.attr("in_scale"))
    if x.dtype != torch.int8:
        x = quantize_array(x, in_scale)
    kind = conv_kind(node)
    kw = _epilogue_kwargs(node, in_scale)
    kh, kw_ = int(w.shape[0]), int(w.shape[1])
    if int(node.attr("groups", 1)) != 1:
        if not (_depthwise_kernel(node, w, residual is not None)
                and w.shape[3] == x.shape[3]):
            return [_grouped_conv(node, x, w, w_scale, bias, residual,
                                  prepared and _weight(node, w, prepared),
                                  kw)]
        del kw["residual_scale"]
        return [depthwise3x3_int8(x.contiguous(), w, w_scale, bias,
                                  stride=pair(node.attr("strides", (1, 1)))[0],
                                  **kw)]
    wk = _weight(node, w, prepared)
    if kind == "conv3x3" and (kh, kw_) == (3, 3):
        return [conv3x3_int8(
            x.contiguous(), wk, w_scale, bias,
            None if residual is None else residual.contiguous(), **kw)]
    n, o = x.shape[0], w.shape[3]
    if kind == "gemm" and (kh, kw_) == (1, 1):
        cols = x
    else:
        cols = _im2col(x, kh, kw_, pair(node.attr("strides", (1, 1))),
                       pair(node.attr("dilation", (1, 1))),
                       conv_pads(node, x.shape[1:3], (kh, kw_)))
    oh, ow = cols.shape[1], cols.shape[2]
    y = matmul_int8(cols.reshape(n * oh * ow, -1),
                    w.reshape(-1, o) if prepared is None else wk, w_scale,
                    bias, None if residual is None else residual.reshape(-1, o),
                    **kw)
    return [y.reshape(n, oh, ow, o)]


@register("dense_int8")
def dense_int8(node, xs: List[torch.Tensor],
               prepared: Optional[PreparedB] = None) -> List[torch.Tensor]:
    """int8 fully-connected on `matmul_int8`; a float input is quantized
    here with `in_scale`.  `prepared`: `prepare_b(w)`, made once."""
    x, w, w_scale, bias, residual = _split_q_inputs(node, xs)
    in_scale = float(node.attr("in_scale"))
    if x.dtype != torch.int8:
        x = quantize_array(x, in_scale)
    axis = int(node.attr("axis", 1))
    lead = tuple(x.shape[:axis])
    n_out = w.shape[-1]
    y = matmul_int8(x.reshape(math.prod(lead), -1), _weight(node, w, prepared),
                    w_scale, bias,
                    None if residual is None else residual.reshape(-1, n_out),
                    **_epilogue_kwargs(node, in_scale))
    return [y.reshape(lead + (n_out,))]


def _split_w_inputs(node, xs):
    """inputs = [x, w_q, w_scale] + [bias]? + [residual]?, x flattened
    from `axis` to [rows, K]."""
    x, w_q, w_scale, bias, residual = _split_q_inputs(node, xs)
    lead = tuple(x.shape[:int(node.attr("axis", 1))])
    return x, x.reshape(math.prod(lead), -1), lead, w_q, w_scale, bias, residual


@register("dense_w8")
def dense_w8(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Weight-only int8 fully-connected: x @ float(w_q) in float32, times
    the per-output-channel scale, then the epilogue."""
    x, xf, lead, w_q, w_scale, bias, residual = _split_w_inputs(node, xs)
    with full_fp32():
        y = torch.matmul(xf.to(torch.float32), w_q.to(torch.float32))
    y = _epilogue(node, y * w_scale.to(torch.float32), bias, residual)
    return [y.reshape(lead + (w_q.shape[-1],)).to(x.dtype)]


@register("conv2d_w8")
def conv2d_w8(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Weight-only int8 convolution: x by w_q widened to x's dtype (strides,
    dilation, padding and groups as the node says), accumulated in float32,
    times the per-output-channel scale, then the epilogue, in x's dtype."""
    x, w_q, w_scale, bias, residual = _split_q_inputs(node, xs)
    y = conv_f32(node, x, w_q.to(x.dtype)) * w_scale.to(torch.float32)
    return [_epilogue(node, y, bias, residual).to(x.dtype)]


@register("dense_w4")
def dense_w4(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Weight-only int4 fully-connected on `matmul_w4` (attr `w4_group`;
    v2 for `impl="pallas"` with `variant="v2"`, else v1), then the epilogue
    in float32."""
    x, xf, lead, w_q, w_scale, bias, residual = _split_w_inputs(node, xs)
    v2 = node.attr("impl") == "pallas" and node.attr("variant") == "v2"
    y = matmul_w4(xf, w_q, w_scale, group=int(node.attr("w4_group")),
                  variant="v2" if v2 else "v1")
    y = _epilogue(node, y, bias, residual)
    return [y.reshape(lead + (w_q.shape[-1],)).to(x.dtype)]


@register("pool2d_int8")
def pool2d_int8(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Max pooling directly on int8 edges (scale-preserving)."""
    return pool2d(node, xs)


@register("concat_int8")
def concat_int8(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Concat of int8 edges of different scales (attr `in_scales`): each
    operand whose scale is not `out_scale` is requantized to it through
    `quantize_array`, the op path's divide."""
    out_scale = float(node.attr("out_scale"))
    parts = [x if abs(s - out_scale) < 1e-12 else
             quantize_array(x.to(torch.float32) * float(s), out_scale)
             for x, s in zip(xs, node.attr("in_scales"))]
    return [torch.cat(parts, dim=int(node.attr("axis", -1)))]
