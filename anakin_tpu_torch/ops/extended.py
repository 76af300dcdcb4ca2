"""Long-tail ops: the port of `anakin_tpu/ops/extended.py` (deformable
conv, CTC alignment, top-k pooling, position-sensitive ROI align, the
R-CNN output assembly and the perception-pipeline helpers).

Plain PyTorch in float32 where the JAX ops compute in float32, with the
same static shapes; no op reads a tensor on the host.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from .nn import full_fp32, pair
from .registry import register
from .tensor import top_k_lower_index


def _bilinear_zero(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                   h: int, w: int) -> torch.Tensor:
    """Bilinear samples of img [N, H*W, C] at float positions y, x [N, P]
    (pixel units), taps outside the map reading 0: [N, P, C]."""
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    wy = (y - y0)[..., None]
    wx = (x - x0)[..., None]
    c = img.shape[-1]

    def at(yy, xx):
        ok = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w))[..., None]
        i = torch.clamp(yy, 0, h - 1) * w + torch.clamp(xx, 0, w - 1)
        v = torch.gather(img, 1, i[..., None].expand(*i.shape, c))
        return torch.where(ok, v, torch.zeros((), device=img.device))

    return (at(y0, x0) * ((1 - wy) * (1 - wx))
            + at(y0, x0 + 1) * ((1 - wy) * wx)
            + at(y0 + 1, x0) * (wy * (1 - wx))
            + at(y0 + 1, x0 + 1) * (wy * wx))


@register("deformable_conv", "deformconvolution")
def deformable_conv(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Deformable convolution v1: each kernel tap samples the input at its
    learned offset by bilinear interpolation (zero outside the map), then
    one float32 product with the weight.  inputs: x [N, H, W, C], offsets
    [N, OH, OW, 2*KH*KW] (dy, dx per tap), w [KH, KW, C, O], [bias]; attrs
    strides, padding, dilation.  Output in x's dtype."""
    it = iter(xs)
    x, offsets, w = next(it), next(it), next(it)
    bias = next(it) if node.attr("has_bias") else None
    sh, sw = pair(node.attr("strides", (1, 1)))
    ph, pw = pair(node.attr("padding", (0, 0)))
    dh, dw = pair(node.attr("dilation", (1, 1)))
    n, h, w_, c = x.shape
    kh, kw, _, o = w.shape
    _, oh, ow, _ = offsets.shape
    dev = x.device
    img = x.to(torch.float32).reshape(n, h * w_, c)
    off = offsets.to(torch.float32).reshape(n, oh, ow, kh * kw, 2)
    oy = (torch.arange(oh, dtype=torch.float32, device=dev) * sh - ph)[:, None]
    ox = (torch.arange(ow, dtype=torch.float32, device=dev) * sw - pw)[None, :]
    cols = []
    for t, (ky, kx) in enumerate((ky, kx) for ky in range(kh)
                                 for kx in range(kw)):
        y = (oy + ky * dh + off[:, :, :, t, 0]).reshape(n, oh * ow)
        x_ = (ox + kx * dw + off[:, :, :, t, 1]).reshape(n, oh * ow)
        cols.append(_bilinear_zero(img, y, x_, h, w_))    # [N, OH*OW, C]
    col = torch.stack(cols, dim=2).reshape(n, oh * ow, kh * kw * c)
    with full_fp32():
        y = torch.matmul(col, w.to(torch.float32).reshape(kh * kw * c, o))
    y = y.reshape(n, oh, ow, o)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return [y.to(x.dtype)]


@register("ctc_align")
def ctc_align(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """CTC greedy alignment: repeated labels merged (`merge_repeated`),
    blanks dropped, the kept labels packed to the left of a [B, T] int32
    row padded with `blank`, and the lengths [B] int32.  inputs: labels [B,
    T], optional lengths [B]."""
    x = xs[0].to(torch.int32)
    lengths = xs[1].to(torch.int32) if len(xs) > 1 else None
    blank = int(node.attr("blank", 0))
    merge = bool(node.attr("merge_repeated", True))
    b, t = x.shape
    t_idx = torch.arange(t, device=x.device)[None, :].expand(b, t)
    valid = (torch.ones((b, t), dtype=torch.bool, device=x.device)
             if lengths is None else t_idx < lengths[:, None])
    prev = F.pad(x, (1, 0), value=-1)[:, :t]
    keep = valid & (x != blank)
    if merge:
        keep = keep & (x != prev)
    pos = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    # kept labels scatter to their packed position, the rest to a spare
    # column past the row, dropped afterwards
    dest = torch.where(keep, pos, t).to(torch.int64)
    out = torch.full((b, t + 1), blank, dtype=torch.int32, device=x.device)
    out = out.scatter(1, dest, torch.where(keep, x, blank))[:, :t]
    return [out, keep.to(torch.int32).sum(dim=1, dtype=torch.int32)]


@register("topk_pooling")
def topk_pooling(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """The top-k values of each channel over the spatial dims: [N, H, W, C]
    -> [N, C*k], largest first within a channel."""
    x = xs[0]
    k = int(node.attr("top_k", 1))
    n, h, w, c = x.shape
    flat = x.reshape(n, h * w, c).transpose(1, 2)
    return [top_k_lower_index(flat, k)[0].reshape(n, c * k)]


@register("topk_avg_pooling")
def topk_avg_pooling(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """For each k of `top_ks`, the mean of each channel's k largest values
    over the spatial dims, in float32: [N, C * len(top_ks)], k-major."""
    x = xs[0]
    top_ks = [int(k) for k in node.attr("top_ks", [1])]
    n, h, w, c = x.shape
    flat = x.reshape(n, h * w, c).transpose(1, 2).to(torch.float32)
    vals = top_k_lower_index(flat, max(top_ks))[0]
    outs = [torch.mean(vals[..., :k], dim=-1) for k in top_ks]
    return [torch.cat(outs, dim=-1).to(x.dtype)]


@register("dfmb_psroi_align", "dfm_ps_roi_align")
def dfmb_psroi_align(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Position-sensitive ROI align: cell (i, j) of each ROI reads its own
    group of C_out channels at the cell's centre, bilinearly, coordinates
    clamped onto the map.  inputs: feat [N, H, W, ph*pw*C_out], rois [R, 5];
    output [R, ph, pw, C_out]."""
    feat, rois = xs[0], xs[1]
    ph, pw = node.attr("pooled_hw", (7, 7))
    spatial_scale = float(node.attr("spatial_scale", 1.0 / 16))
    n, h, w, ctot = feat.shape
    c = ctot // (ph * pw)
    dev = feat.device
    flat = feat.to(torch.float32).reshape(n * h * w, ph * pw, c)
    rois = rois.to(torch.float32)
    r = rois.shape[0]
    x1, y1, x2, y2 = (rois[:, i] * spatial_scale for i in range(1, 5))
    rw = torch.clamp_min(x2 - x1, 0.1)
    rh = torch.clamp_min(y2 - y1, 0.1)
    cy = y1[:, None] + (torch.arange(ph, dtype=torch.float32, device=dev)
                        + 0.5) * rh[:, None] / ph                 # [R, ph]
    cx = x1[:, None] + (torch.arange(pw, dtype=torch.float32, device=dev)
                        + 0.5) * rw[:, None] / pw                 # [R, pw]
    y0 = torch.clamp(torch.floor(cy).to(torch.int64), 0, h - 1)
    x0 = torch.clamp(torch.floor(cx).to(torch.int64), 0, w - 1)
    y1i = torch.clamp_max(y0 + 1, h - 1)
    x1i = torch.clamp_max(x0 + 1, w - 1)
    wy = (torch.clamp(cy, 0, h - 1) - y0)[:, :, None, None]      # [R, ph, 1, 1]
    wx = (torch.clamp(cx, 0, w - 1) - x0)[:, None, :, None]      # [R, 1, pw, 1]
    base = rois[:, 0].to(torch.int64)[:, None, None] * (h * w)
    cell = torch.arange(ph * pw, device=dev).reshape(1, ph, pw)

    def at(yi, xi):
        rows = base + yi[:, :, None] * w + xi[:, None, :]        # [R, ph, pw]
        return flat.reshape(n * h * w * ph * pw, c).index_select(
            0, (rows * (ph * pw) + cell).reshape(-1)).reshape(r, ph, pw, c)

    out = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1i) * (1 - wy) * wx
           + at(y1i, x0) * wy * (1 - wx) + at(y1i, x1i) * wy * wx)
    return [out.to(feat.dtype)]


@register("rois_anchor_feature")
def rois_anchor_feature(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """ROIs [R, 5] as normalized (cx, cy, w, h) over (img_w, img_h)."""
    rois = xs[0].to(torch.float32)
    img_w = float(node.attr("img_w", 1.0))
    img_h = float(node.attr("img_h", 1.0))
    x1, y1, x2, y2 = rois[:, 1], rois[:, 2], rois[:, 3], rois[:, 4]
    out = torch.stack([(x1 + x2) / 2 / img_w, (y1 + y2) / 2 / img_h,
                       (x2 - x1) / img_w, (y2 - y1) / img_h], dim=-1)
    return [out.to(xs[0].dtype)]


@register("proposal_img_scale_to_cam_coords")
def proposal_img_scale_to_cam_coords(node, xs: List[torch.Tensor]
                                     ) -> List[torch.Tensor]:
    """Each box's bottom centre lifted into camera space by a pinhole model:
    boxes [R, 4+], cam_info [6] (fx, fy, cx, cy, cam_h, scale) -> [R, 3]
    (x, 0, z) float32."""
    boxes = xs[0].to(torch.float32)
    cam = xs[1].to(torch.float32)
    fx, fy, cx, cy, cam_h = cam[0], cam[1], cam[2], cam[3], cam[4]
    u = (boxes[:, 0] + boxes[:, 2]) / 2
    z = fy * cam_h / torch.clamp_min(boxes[:, 3] - cy, 1e-3)
    x3 = (u - cx) * z / fx
    return [torch.stack([x3, torch.zeros_like(x3), z], dim=-1)]


@register("rcnn_det_output_with_attr")
def rcnn_det_output_with_attr(node, xs: List[torch.Tensor]
                              ) -> List[torch.Tensor]:
    """R-CNN output rows: rois, the argmax class (first of equal scores),
    its score and the optional attribute scores, joined along the last
    axis in float32."""
    rois, scores = xs[0].to(torch.float32), xs[1].to(torch.float32)
    parts = [rois, torch.argmax(scores, dim=-1).to(torch.float32)[:, None],
             torch.amax(scores, dim=-1)[:, None]]
    if len(xs) > 2:
        parts.append(xs[2].to(torch.float32))
    return [torch.cat(parts, dim=-1)]


@register("affine_channel")
def affine_channel(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Per-channel x * scale + bias with constant weights, in x's dtype."""
    x, scale_w, bias_w = xs[0], xs[1], xs[2]
    return [x * scale_w.to(x.dtype) + bias_w.to(x.dtype)]


@register("conv_unpadding_padding")
def conv_unpadding_padding(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Zero the padded steps of a [B, T, ...] batch past each row's length
    (the identity without lengths)."""
    x = xs[0]
    if len(xs) < 2:
        return [x]
    t = x.shape[1]
    mask = (torch.arange(t, device=x.device)[None, :]
            < xs[1].to(torch.int32)[:, None])
    if x.dim() == 3:
        mask = mask[..., None]
    return [torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))]
