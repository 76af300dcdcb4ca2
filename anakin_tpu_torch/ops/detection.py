"""Detection-model ops: the port of `anakin_tpu/ops/detection.py` (prior
boxes, box decoding, NMS, ROI pooling, YOLO heads, RPN proposals).

Every output has a static shape, as in the JAX package: NMS returns a fixed
slab of `max_out` indices with a validity mask, detections are [B, K, 7]
slabs whose invalid rows are -1, proposals are a padded [B, post_n, 5] slab.
The ops are plain PyTorch (they are XLA code in the reference), and stay
meta-safe and capture-safe: no `.item()`, no `nonzero`, no shape that
depends on the data, and no indexing with a 0-dim tensor (which reads it on
the host); every selection is a `gather` or an `index_select`; constants
(prior boxes, anchors, label and anchor vectors) are computed on the
device, never copied from the host, which a capture would refuse.

Ties break toward the lower index, as `lax.top_k`, `jnp.argmax` and the
stable `jnp.argsort` break them: `torch.argmax` returns the first maximum,
every sort here is `torch.sort(..., stable=True)`, and the proposals' top-k
is `top_k_lower_index` (the total order of `lax.top_k`).  The greedy NMS is a
loop of `max_out` steps on tensors, run for all the classes (and images) of
a call at once; each step is the JAX step on one row of the IoU matrix,
computed with the JAX formula.

Box convention: (x1, y1, x2, y2).
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

from .registry import register
from .tensor import top_k_lower_index

__all__ = ["iou_matrix", "nms_padded", "nms_batched"]

_NEG_INF = float("-inf")


def _areas(x1, y1, x2, y2):
    return torch.clamp_min(x2 - x1, 0) * torch.clamp_min(y2 - y1, 0)


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of boxes a [..., 4] against b [..., 4] (broadcast), in the
    JAX `iou_matrix`'s order of operations."""
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    inter = (torch.clamp_min(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1), 0)
             * torch.clamp_min(torch.minimum(ay2, by2) - torch.maximum(ay1, by1), 0))
    union = _areas(ax1, ay1, ax2, ay2) + _areas(bx1, by1, bx2, by2) - inter
    return inter / torch.clamp_min(union, 1e-10)


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """[N, 4] -> [N, N] pairwise IoU."""
    return _iou(boxes[:, None, :], boxes[None, :, :])


def nms_batched(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
                iou_threshold: float, score_threshold: float = _NEG_INF):
    """Greedy NMS of G independent problems at once, with a static output
    size: boxes [G, n, 4], scores [G, n] -> (indices [G, max_out] int32, -1
    where invalid, and valid [G, max_out] bool).  Step t of each problem is
    step t of the JAX `nms_padded` on it."""
    g, n = scores.shape
    alive = scores > score_threshold
    ar = torch.arange(n, device=scores.device)
    neg = torch.full((), _NEG_INF, dtype=scores.dtype, device=scores.device)
    idx, valid = [], []
    for _ in range(max_out):
        masked = torch.where(alive, scores, neg)
        best = torch.argmax(masked, dim=1, keepdim=True)          # [G, 1]
        ok = torch.gather(masked, 1, best) > _NEG_INF              # [G, 1]
        best_box = torch.gather(boxes, 1, best[..., None].expand(g, 1, 4))
        suppress = _iou(best_box, boxes) > iou_threshold           # [G, n]
        alive_new = alive & ~suppress & (ar[None, :] != best)
        alive = torch.where(ok, alive_new, alive)
        idx.append(torch.where(ok, best, -1).to(torch.int32))
        valid.append(ok)
    return torch.cat(idx, dim=1), torch.cat(valid, dim=1)


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
               iou_threshold: float, score_threshold: float = _NEG_INF):
    """Greedy NMS with static output size: boxes [n, 4], scores [n] ->
    (indices [max_out] int32, valid [max_out] bool)."""
    idx, valid = nms_batched(boxes[None], scores[None], max_out,
                             iou_threshold, score_threshold)
    return idx[0], valid[0]


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [G, n, k] at indices idx [G, m] (clamped at 0) -> [G, m, k]."""
    i = torch.clamp_min(idx, 0).to(torch.int64)
    return torch.gather(t, 1, i[..., None].expand(*i.shape, t.shape[-1]))


def _labels(n_cls: int, background_id: int, device) -> torch.Tensor:
    """The classes but the background, in order, as an int64 index made
    on `device` (a Python list as an index is a copy from the host)."""
    ar = torch.arange(n_cls - (0 <= background_id < n_cls), device=device)
    return ar + (ar >= background_id).to(ar.dtype)


def _class_slabs(boxes: torch.Tensor, scores: torch.Tensor,
                 labels: torch.Tensor, class_top_k: int, keep_top_k: int,
                 nms_thresh: float, conf_thresh: float) -> torch.Tensor:
    """Per-class NMS, then the global top-k of each image: boxes [B, L, n,
    4] (L may be 1: shared by every class), scores [B, L, n] for the L
    classes `labels` -> [B, keep_top_k, 7] (image_id, label, score, x1, y1,
    x2, y2), rows of score <= 0 all -1: the JAX `per_image` of
    `detection_output` and `rcnn_detection_output`."""
    b, n_cls, n = scores.shape
    boxes = boxes.expand(b, n_cls, n, 4).reshape(b * n_cls, n, 4)
    sc = scores.reshape(b * n_cls, n)
    idx, valid = nms_batched(boxes, sc, class_top_k, nms_thresh, conf_thresh)
    sel_boxes = _rows(boxes, idx)                                 # [BL, k, 4]
    sel_scores = torch.where(valid, _rows(sc[..., None], idx)[..., 0],
                             torch.full((), -1.0, device=sc.device))
    label = labels.to(torch.float32).repeat(b)[:, None].expand(
        b * n_cls, class_top_k)
    rows = torch.cat([label[..., None], sel_scores[..., None], sel_boxes],
                     dim=-1).reshape(b, n_cls * class_top_k, 6)
    order = torch.sort(-rows[..., 1], dim=1, stable=True).indices[:, :keep_top_k]
    kept = torch.gather(rows, 1, order[..., None].expand(*order.shape, 6))
    kept = torch.where(kept[..., 1:2] > 0, kept,
                       torch.full((), -1.0, device=sc.device))
    img_id = torch.arange(b, dtype=torch.float32, device=sc.device)
    img_id = img_id[:, None, None].expand(b, kept.shape[1], 1)
    return torch.cat([img_id, kept], dim=-1)


def _vector(values: Sequence[float], device) -> torch.Tensor:
    """A float32 vector of Python floats, filled on `device` (no copy from
    the host, so a CUDA-graph capture can record it); each value rounds to
    float32 as numpy's `astype(float32)` rounds it."""
    return torch.stack([torch.full((), float(v), dtype=torch.float32,
                                   device=device) for v in values])


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s, s a Python number, divided on x's device as the CPU and XLA
    divide: CUDA divides a tensor by a Python number as x * (1 / s), which
    parts from the quotient by one bit in about a third of the elements."""
    return x / torch.full((), float(s), dtype=x.dtype, device=x.device)


@register("priorbox")
def priorbox(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """SSD prior boxes of a feature map: [1, 2, H*W*P*4] float32, plane 0
    the box corners over the image size, plane 1 the variances (caffe
    layout).  A function of the shapes and attrs only, computed on the
    feature map's device with the JAX op's float32 formulas."""
    feat = xs[0]
    _, fh, fw, _ = feat.shape
    dev = feat.device
    img_h, img_w = node.attr("img_hw")
    min_sizes = [float(s) for s in node.attr("min_sizes")]
    max_sizes = [float(s) for s in node.attr("max_sizes", [])]
    ars_in = [float(a) for a in node.attr("aspect_ratios", [])]
    flip = bool(node.attr("flip", True))
    variances = [float(v) for v in node.attr("variances", [0.1, 0.1, 0.2, 0.2])]
    step = node.attr("step", 0)
    offset = float(node.attr("offset", 0.5))
    step_h = float(step) if step else img_h / fh
    step_w = float(step) if step else img_w / fw

    # box sizes per location (caffe order: min, max, then aspect ratios per min)
    whs = []
    for ms in min_sizes:
        whs.append((ms, ms))
        if max_sizes:
            mx = (max_sizes[min_sizes.index(ms)]
                  if len(max_sizes) == len(min_sizes) else max_sizes[0])
            whs.append((math.sqrt(ms * mx), math.sqrt(ms * mx)))
        ars = [1.0]
        for a in ars_in:
            if abs(a - 1.0) < 1e-6 or a in ars:
                continue
            ars.append(a)
            if flip:
                ars.append(1.0 / a)
        for a in ars:
            if abs(a - 1.0) < 1e-6:
                continue
            whs.append((ms * math.sqrt(a), ms / math.sqrt(a)))
    w = _vector([v for v, _ in whs], dev)
    h = _vector([v for _, v in whs], dev)
    cy = (torch.arange(fh, dtype=torch.float32, device=dev) + offset) * step_h
    cx = (torch.arange(fw, dtype=torch.float32, device=dev) + offset) * step_w
    cyg, cxg = (t[..., None] for t in torch.meshgrid(cy, cx, indexing="ij"))
    boxes = torch.stack([_div(cxg - w / 2, img_w), _div(cyg - h / 2, img_h),
                         _div(cxg + w / 2, img_w), _div(cyg + h / 2, img_h)],
                        dim=-1).reshape(-1)
    if node.attr("clip", False):
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = _vector(variances, dev).repeat(fh * fw * len(whs))
    return [torch.stack([boxes, var])[None]]


def _center_size_decode(pw, ph, pcx, pcy, var, t):
    """Boxes from CENTER_SIZE offsets t [..., 4] against priors (width,
    height, centre, variances var [.., 4]): centre and log-size form."""
    dcx = var[:, 0] * t[..., 0] * pw + pcx
    dcy = var[:, 1] * t[..., 1] * ph + pcy
    dw = torch.exp(var[:, 2] * t[..., 2]) * pw
    dh = torch.exp(var[:, 3] * t[..., 3]) * ph
    return dcx, dcy, dw, dh


@register("detection_output")
def detection_output(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """SSD post-processing: decode the priors, per-class NMS, the global
    top `keep_top_k`.  inputs: loc [N, P*4], conf [N, P*C], priors [1, 2,
    P*4].  Output [N, keep_top_k, 7] (image_id, label, score, x1, y1, x2,
    y2), score == -1 rows invalid."""
    loc, conf, priors = xs[0], xs[1], xs[2]
    num_classes = int(node.attr("num_classes"))
    background_id = int(node.attr("background_id", 0))
    keep_top_k = int(node.attr("keep_top_k", 200))
    class_top_k = int(node.attr("top_k", 100))
    nms_thresh = float(node.attr("nms_thresh", 0.45))
    conf_thresh = float(node.attr("conf_thresh", 0.01))
    variance_encoded = bool(node.attr("variance_encoded_in_target", False))

    n = loc.shape[0]
    # the priors keep their dtype, as in the JAX op: in a bf16 net their
    # widths and centres are bf16 sums
    prior_boxes = priors[0, 0].reshape(-1, 4)
    prior_var = priors[0, 1].reshape(-1, 4)
    n_priors = prior_boxes.shape[0]
    loc = loc.reshape(n, n_priors, 4).to(torch.float32)
    conf = conf.reshape(n, n_priors, num_classes).to(torch.float32)
    pw = prior_boxes[:, 2] - prior_boxes[:, 0]
    ph = prior_boxes[:, 3] - prior_boxes[:, 1]
    pcx = (prior_boxes[:, 0] + prior_boxes[:, 2]) / 2
    pcy = (prior_boxes[:, 1] + prior_boxes[:, 3]) / 2
    var = torch.ones_like(prior_var) if variance_encoded else prior_var
    dcx, dcy, dw, dh = _center_size_decode(pw, ph, pcx, pcy, var, loc)
    boxes = torch.stack([dcx - dw / 2, dcy - dh / 2, dcx + dw / 2,
                         dcy + dh / 2], dim=-1)            # [N, P, 4]
    labels = _labels(num_classes, background_id, conf.device)
    scores = conf.index_select(2, labels).permute(0, 2, 1)  # [N, L, P]
    return [_class_slabs(boxes[:, None], scores, labels, class_top_k,
                         keep_top_k, nms_thresh, conf_thresh)]


@register("yolo_box")
def yolo_box(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """YOLOv3 box decoding.  inputs: x [N, H, W, A*(5+C)], img_size [N, 2]
    (h, w).  Outputs: boxes [N, H*W*A, 4] (corners in image pixels, clipped
    to the image), scores [N, H*W*A, C] (class probability times
    objectness, 0 below `conf_thresh`), both in x's dtype."""
    x, img_size = xs[0], xs[1]
    anchors = node.attr("anchors")  # flat [a0w, a0h, a1w, ...]
    class_num = int(node.attr("class_num"))
    conf_thresh = float(node.attr("conf_thresh", 0.005))
    downsample = int(node.attr("downsample_ratio", 32))
    n, h, w, _ = x.shape
    a = len(anchors) // 2
    dev = x.device
    feat = x.reshape(n, h, w, a, 5 + class_num).to(torch.float32)
    gx = torch.arange(w, dtype=torch.float32, device=dev).reshape(1, 1, w, 1)
    gy = torch.arange(h, dtype=torch.float32, device=dev).reshape(1, h, 1, 1)
    bx = _div(torch.sigmoid(feat[..., 0]) + gx, w)
    by = _div(torch.sigmoid(feat[..., 1]) + gy, h)
    aw = _vector(anchors[0::2], dev)
    ah = _vector(anchors[1::2], dev)
    bw = _div(torch.exp(feat[..., 2]) * aw, w * downsample)
    bh = _div(torch.exp(feat[..., 3]) * ah, h * downsample)
    obj = torch.sigmoid(feat[..., 4])
    cls_prob = torch.sigmoid(feat[..., 5:]) * obj[..., None]
    cls_prob = torch.where(cls_prob > conf_thresh, cls_prob,
                           torch.zeros((), device=dev))
    img_h = img_size[:, 0].to(torch.float32)[:, None, None, None]
    img_w = img_size[:, 1].to(torch.float32)[:, None, None, None]
    x1 = torch.clamp(torch.clamp_min((bx - bw / 2) * img_w, 0), max=img_w - 1)
    y1 = torch.clamp(torch.clamp_min((by - bh / 2) * img_h, 0), max=img_h - 1)
    x2 = torch.clamp(torch.clamp_min((bx + bw / 2) * img_w, 0), max=img_w - 1)
    y2 = torch.clamp(torch.clamp_min((by + bh / 2) * img_h, 0), max=img_h - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(n, h * w * a, 4)
    scores = cls_prob.reshape(n, h * w * a, class_num)
    return [boxes.to(x.dtype), scores.to(x.dtype)]


@register("roi_align")
def roi_align(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """ROI Align with bilinear sampling.  inputs: feat [N, H, W, C], rois
    [R, 5] (batch_idx, x1, y1, x2, y2 in input-image coords); attrs
    pooled_hw, spatial_scale, sampling_ratio.  Output [R, ph, pw, C]: the
    mean of sampling_ratio^2 bilinear samples a cell, coordinates clamped
    onto the map."""
    feat, rois = xs[0], xs[1]
    ph, pw = node.attr("pooled_hw", (7, 7))
    spatial_scale = float(node.attr("spatial_scale", 1.0))
    s = max(int(node.attr("sampling_ratio", 2)), 1)
    n, h, w, c = feat.shape
    dev = feat.device
    rois = rois.to(torch.float32)
    r = rois.shape[0]
    x1, y1, x2, y2 = (rois[:, i] * spatial_scale for i in range(1, 5))
    rw = torch.clamp_min(x2 - x1, 1.0)
    rh = torch.clamp_min(y2 - y1, 1.0)
    bin_h = _div(rh, ph)[:, None, None]
    bin_w = _div(rw, pw)[:, None, None]
    iy = torch.arange(ph, dtype=torch.float32, device=dev)
    ix = torch.arange(pw, dtype=torch.float32, device=dev)
    sy = torch.arange(s, dtype=torch.float32, device=dev)
    frac = _div(sy[None, :] + 0.5, s)
    ys = (y1[:, None, None] + (iy[:, None] + frac) * bin_h).reshape(r, ph * s)
    xs_ = (x1[:, None, None] + (ix[:, None] + frac) * bin_w).reshape(r, pw * s)
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs_).to(torch.int64), 0, w - 1)
    y1i = torch.clamp(y0 + 1, 0, h - 1)
    x1i = torch.clamp(x0 + 1, 0, w - 1)
    wy = (torch.clamp(ys, 0, h - 1) - y0)[:, :, None, None]       # [R, Y, 1, 1]
    wx = (torch.clamp(xs_, 0, w - 1) - x0)[:, None, :, None]      # [R, 1, X, 1]
    flat = feat.to(torch.float32).reshape(n * h * w, c)
    base = rois[:, 0].to(torch.int64)[:, None, None] * (h * w)  # image rows

    def at(yi, xi):
        rows = base + yi[:, :, None] * w + xi[:, None, :]          # [R, Y, X]
        return flat.index_select(0, rows.reshape(-1)).reshape(
            r, ph * s, pw * s, c)

    v = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1i) * (1 - wy) * wx
         + at(y1i, x0) * wy * (1 - wx) + at(y1i, x1i) * wy * wx)
    out = v.reshape(r, ph, s, pw, s, c).mean(dim=(2, 4))
    return [out.to(feat.dtype)]


@register("roi_pool", "ps_roi_pooling", "sroi_align")
def roi_pool(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """ROI max pooling on the quantized grid (same IO as `roi_align`): each
    cell is the max over its sub-window, taken as a mask over the whole map
    (a static shape); an empty cell gives 0."""
    feat, rois = xs[0], xs[1]
    ph, pw = node.attr("pooled_hw", (7, 7))
    spatial_scale = float(node.attr("spatial_scale", 1.0))
    n, h, w, c = feat.shape
    dev = feat.device
    rois = rois.to(torch.float32)
    img = feat.to(torch.float32).index_select(0, rois[:, 0].to(torch.int64))
    x1, y1, x2, y2 = (torch.round(rois[:, i] * spatial_scale)
                      for i in range(1, 5))
    rh = torch.clamp_min(y2 - y1 + 1, 1.0)
    rw = torch.clamp_min(x2 - x1 + 1, 1.0)
    gy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    neg = torch.full((), _NEG_INF, device=dev)
    rows = []
    for i in range(ph):
        ys = (y1 + _div(rh * i, ph))[:, None, None]
        ye = (y1 + _div(rh * (i + 1), ph))[:, None, None]
        cells = []
        for j in range(pw):
            xs0 = (x1 + _div(rw * j, pw))[:, None, None]
            xe = (x1 + _div(rw * (j + 1), pw))[:, None, None]
            m = ((gy >= torch.floor(ys)) & (gy < torch.ceil(ye))
                 & (gx >= torch.floor(xs0)) & (gx < torch.ceil(xe)))
            cells.append(torch.amax(torch.where(m[..., None], img, neg),
                                    dim=(1, 2)))
        rows.append(torch.stack(cells, dim=1))
    out = torch.stack(rows, dim=1)
    out = torch.where(torch.isfinite(out), out, torch.zeros((), device=dev))
    return [out.to(feat.dtype)]


@register("anchor_generator")
def anchor_generator(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Faster R-CNN anchors of a feature map: anchors [H, W, A, 4] (pixel
    corners) and variances [H, W, A, 4], float32; a function of the shapes
    and attrs only, computed on the feature map's device with the JAX op's
    float32 formulas."""
    feat = xs[0]
    _, h, w, _ = feat.shape
    dev = feat.device
    sizes = [float(s) for s in node.attr("anchor_sizes", [64, 128, 256, 512])]
    ratios = [float(r) for r in node.attr("aspect_ratios", [0.5, 1.0, 2.0])]
    variances = node.attr("variances", [0.1, 0.1, 0.2, 0.2])
    stride = node.attr("stride", [16.0, 16.0])
    offset = float(node.attr("offset", 0.5))
    aw = _vector([s * math.sqrt(1.0 / r) for r in ratios for s in sizes], dev)
    ah = _vector([s * math.sqrt(r) for r in ratios for s in sizes], dev)
    cx = (torch.arange(w, dtype=torch.float32, device=dev) + offset) \
        * float(stride[0])
    cy = (torch.arange(h, dtype=torch.float32, device=dev) + offset) \
        * float(stride[1])
    cyg, cxg = (t[..., None] for t in torch.meshgrid(cy, cx, indexing="ij"))
    anchors = torch.stack([cxg - aw / 2, cyg - ah / 2, cxg + aw / 2,
                           cyg + ah / 2], dim=-1)
    var = _vector(variances, dev).expand(anchors.shape).contiguous()
    return [anchors, var]


@register("box_coder")
def box_coder(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Decode target offsets against priors (CENTER_SIZE).  inputs: priors
    [M, 4], optional prior variances [M, 4], targets [N, M, 4]; output in
    the targets' dtype."""
    priors = xs[0].to(torch.float32)
    if len(xs) == 3:
        prior_var, targets = xs[1].to(torch.float32), xs[2].to(torch.float32)
    else:
        prior_var, targets = None, xs[1].to(torch.float32)
    add = 0.0 if bool(node.attr("box_normalized", True)) else 1.0
    pw = priors[:, 2] - priors[:, 0] + add
    ph = priors[:, 3] - priors[:, 1] + add
    pcx = priors[:, 0] + pw / 2
    pcy = priors[:, 1] + ph / 2
    v = prior_var if prior_var is not None else torch.ones_like(priors)
    dcx, dcy, dw, dh = _center_size_decode(pw, ph, pcx, pcy, v, targets)
    out = torch.stack([dcx - dw / 2, dcy - dh / 2,
                       dcx + dw / 2 - add, dcy + dh / 2 - add], dim=-1)
    return [out.to(xs[-1].dtype)]


@register("box_clip")
def box_clip(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Clip boxes [N, ..., 4] to the image: x1, y1 at 0 from below, x2 at
    w - 1 and y2 at h - 1 from above, with (h, w) = im_info[:, :2] /
    im_info[:, 2]; output in the boxes' dtype."""
    boxes, im_info = xs[0].to(torch.float32), xs[1].to(torch.float32)
    shape = [-1] + [1] * (boxes.dim() - 1)
    h = (im_info[:, 0] / im_info[:, 2] - 1.0).reshape(shape)
    w = (im_info[:, 1] / im_info[:, 2] - 1.0).reshape(shape)
    x1 = torch.clamp_min(boxes[..., 0:1], 0)
    y1 = torch.clamp_min(boxes[..., 1:2], 0)
    x2 = torch.minimum(boxes[..., 2:3], w)
    y2 = torch.minimum(boxes[..., 3:4], h)
    return [torch.cat([x1, y1, x2, y2], dim=-1).to(xs[0].dtype)]


def _clip_corners(boxes: torch.Tensor, im_w, im_h) -> torch.Tensor:
    """Each corner of boxes [..., 4] clipped to [0, im_w - 1] x [0, im_h -
    1] (im_w, im_h broadcast against the box dims)."""
    return torch.stack([
        torch.clamp(torch.clamp_min(boxes[..., 0], 0), max=im_w - 1),
        torch.clamp(torch.clamp_min(boxes[..., 1], 0), max=im_h - 1),
        torch.clamp(torch.clamp_min(boxes[..., 2], 0), max=im_w - 1),
        torch.clamp(torch.clamp_min(boxes[..., 3], 0), max=im_h - 1)], dim=-1)


@register("rcnn_detection_output")
def rcnn_detection_output(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Faster R-CNN's second-stage post-processing: per-class refinement of
    the proposals, per-class NMS, the global top `keep_top_k`.

    inputs: rois [B, R, 5], cls_prob [B*R, C], bbox_pred [B*R, C*4] (or
    [B*R, 4], class-agnostic), im_info [B, 3] (h, w, scale).  A ROI is
    invalid when x2 < x1 or its batch index is negative.  Output [B,
    keep_top_k, 7], score == -1 rows invalid."""
    rois, cls_prob, bbox_pred, im_info = xs
    b, r, _ = rois.shape
    n_cls = int(node.attr("num_classes"))
    background_id = int(node.attr("background_id", 0))
    keep_top_k = int(node.attr("keep_top_k", 100))
    class_top_k = int(node.attr("top_k", keep_top_k))
    nms_thresh = float(node.attr("nms_thresh", 0.3))
    conf_thresh = float(node.attr("conf_thresh", 0.05))
    stds = _vector(node.attr("bbox_stds", (0.1, 0.1, 0.2, 0.2)), rois.device)
    agnostic = bbox_pred.shape[-1] == 4

    rois = rois.to(torch.float32)
    prob = cls_prob.reshape(b, r, n_cls).to(torch.float32)
    deltas = bbox_pred.reshape(b, r, -1, 4).to(torch.float32) * stds
    base = rois[..., 1:5]                                      # [B, R, 4]
    invalid = (base[..., 2] < base[..., 0]) | (rois[..., 0] < 0)
    w = (base[..., 2] - base[..., 0] + 1.0)[..., None]
    h = (base[..., 3] - base[..., 1] + 1.0)[..., None]
    cx = base[..., 0:1] + w / 2
    cy = base[..., 1:2] + h / 2
    dcx = deltas[..., 0] * w + cx                             # [B, R, C|1]
    dcy = deltas[..., 1] * h + cy
    dw = torch.exp(torch.clamp(deltas[..., 2], max=10.0)) * w
    dh = torch.exp(torch.clamp(deltas[..., 3], max=10.0)) * h
    boxes = torch.stack([dcx - dw / 2, dcy - dh / 2,
                         dcx + dw / 2 - 1, dcy + dh / 2 - 1], dim=-1)
    info = im_info.to(torch.float32)
    im_h = (info[:, 0] / info[:, 2])[:, None, None]
    im_w = (info[:, 1] / info[:, 2])[:, None, None]
    boxes = _clip_corners(boxes, im_w, im_h)                  # [B, R, C|1, 4]
    labels = _labels(n_cls, background_id, rois.device)
    boxes = boxes.permute(0, 2, 1, 3)                         # [B, C|1, R, 4]
    if not agnostic:
        boxes = boxes.index_select(1, labels)
    scores = torch.where(invalid[..., None],
                         torch.full((), _NEG_INF, device=rois.device),
                         prob.index_select(2, labels)).permute(0, 2, 1)
    return [_class_slabs(boxes, scores, labels, class_top_k, keep_top_k,
                         nms_thresh, conf_thresh)]


@register("generate_proposals", "rcnn_proposal", "rpn_proposal_ssd",
          "sproposal")
def generate_proposals(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """RPN proposals with static shapes.  inputs: scores [N, H, W, A],
    deltas [N, H, W, A*4], im_info [N, 3], anchors [H, W, A, 4], variances
    [H, W, A, 4].  Boxes decoded and clipped, those under `min_size` given
    a score of -inf, the top `pre_nms_top_n` by score (ties to the lower
    index), then NMS to `post_nms_top_n`.  Output rois [N, post_n, 5]
    (batch_idx, x1, y1, x2, y2); an invalid row keeps its batch index and
    has -1 corners, as in the JAX op."""
    scores, deltas, im_info, anchors, variances = xs
    pre_n = int(node.attr("pre_nms_top_n", 6000))
    post_n = int(node.attr("post_nms_top_n", 300))
    nms_thresh = float(node.attr("nms_thresh", 0.7))
    min_size = float(node.attr("min_size", 0.0))
    n = scores.shape[0]
    dev = scores.device
    a4 = anchors.reshape(-1, 4).to(torch.float32)
    v4 = variances.reshape(-1, 4).to(torch.float32)
    m = a4.shape[0]
    pre_n = min(pre_n, m)
    sc = scores.reshape(n, m).to(torch.float32)
    dl = deltas.reshape(n, m, 4).to(torch.float32)

    aw = a4[:, 2] - a4[:, 0] + 1.0
    ah = a4[:, 3] - a4[:, 1] + 1.0
    acx = a4[:, 0] + aw / 2
    acy = a4[:, 1] + ah / 2
    dcx = v4[:, 0] * dl[..., 0] * aw + acx
    dcy = v4[:, 1] * dl[..., 1] * ah + acy
    dw = torch.exp(torch.clamp(v4[:, 2] * dl[..., 2], max=10.0)) * aw
    dh = torch.exp(torch.clamp(v4[:, 3] * dl[..., 3], max=10.0)) * ah
    boxes = torch.stack([dcx - dw / 2, dcy - dh / 2,
                         dcx + dw / 2 - 1, dcy + dh / 2 - 1], dim=-1)
    info = im_info.to(torch.float32)
    boxes = _clip_corners(boxes, info[:, 1:2], info[:, 0:1])     # [N, M, 4]
    ws = boxes[..., 2] - boxes[..., 0] + 1
    hs = boxes[..., 3] - boxes[..., 1] + 1
    keep = (ws >= min_size) & (hs >= min_size)
    s_m = torch.where(keep, sc, torch.full((), _NEG_INF, device=dev))
    top_s, top_i = top_k_lower_index(s_m, pre_n)
    top_boxes = torch.gather(boxes, 1, top_i[..., None].expand(n, pre_n, 4))
    idx, valid = nms_batched(top_boxes, top_s, post_n, nms_thresh)
    sel = torch.where(valid[..., None], _rows(top_boxes, idx),
                      torch.full((), -1.0, device=dev))
    bidx = torch.arange(n, dtype=torch.float32, device=dev)
    bidx = bidx[:, None, None].expand(n, post_n, 1)
    return [torch.cat([bidx, sel], dim=-1).to(xs[0].dtype)]
