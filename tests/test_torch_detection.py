"""Detection on the port: every op of `ops/detection.py` and
`ops/extended.py`, `l2_normalize`, and the SSD300-VGG16, YOLOv3-tiny,
Faster R-CNN and Faster R-CNN lite nets, each against the JAX package on the
same graph and the same seeded inputs, on the CPU.

The nets run at the smallest sizes their builders take: SSD at 264 px (its
extra layers need a 257 px input or more) and full width, b1; YOLOv3-tiny
at `width_mult` 0.25 and 128 px, Faster R-CNN at `base_width` 8 and 128 px,
the lite one at 128 px, all b2.  Their int8 graphs run every eligible int8
node on the JAX side's Pallas route (interpret mode), as the other slices'
tests run them; the other int8 convs (SSD's dilated fc6 and its strided or
unpadded extras, the strided and 7x7 convs) take the JAX XLA route.

Tolerances, and why:
  * the detection ops alone, float32: boxes, scores and pooled values
    within rtol 1e-6 and 1e-6 of the largest value (the ops' `exp`,
    `sigmoid`, `rsqrt` and the mean of a cell's samples round their last
    bit apart); indices, labels, validity and the order of the rows equal,
    ties included (toward the lower index, as `lax.top_k`, `jnp.argmax`
    and the stable `jnp.argsort` break them); bf16 outputs within one bf16
    ulp (rtol 8e-3).
  * a detection slab ([B, K, 7], or the proposals [B, R, 5]): the rows
    valid on the JAX side (score > 0; corners not -1) are the valid rows on
    the port's, in the same order, within the op tolerance above (through
    a whole net: within FLOAT_NET_RTOL of the largest value); every other
    row is -1 on both.
  * the float32 nets: within FLOAT_NET_RTOL = 1e-5 of each edge's largest
    value (PyTorch's and XLA's float32 convolutions sum in other orders);
    the softmax edges within SOFT_ATOL; a sigmoid output (the RPN scores)
    within FLOAT_NET_RTOL of its node's largest pre-activation value times
    the sigmoid's largest slope, 1/4; the edges computed from ROI-pooled
    features within ROI_NET_RTOL (see there).
  * int8 nets, float32: int8 edges within 1 LSB, equal on the nodes both
    sides run on the kernels' numerics (the XLA-route nodes divide by
    out_scale where the kernels multiply by its reciprocal); float edges
    within FLOAT_NET_RTOL.
  * bf16 nets (float and int8): each node is held to the JAX node on the
    JAX node's own inputs (a bf16 difference grows through the layers):
    bf16 within rtol 8e-3 / atol 1e-4, int8 within 1 LSB, the float output
    of an XLA-route int8 node within BF16_XLA_SCALE_RTOL (the XLA route
    forms in_scale * w_scale in bf16, the port in float32).
"""

import math
import os
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import anakin_tpu as ak
from anakin_tpu import models as jax_models
from anakin_tpu.graph.ir import Node as JaxNode
from anakin_tpu.graph.shape_infer import infer_shapes as jax_infer_shapes
from anakin_tpu.ops import detection as jax_detection
from anakin_tpu.ops import get_op as jax_get_op
from anakin_tpu.ops.quantized import _pallas_eligible
from anakin_tpu.ops.registry import ALIASES as JAX_ALIASES
from anakin_tpu.quant import calibrate as jax_calibrate
from anakin_tpu.quant import quantize_graph as jax_quantize_graph
from anakin_tpu.quant.policy import choose_precision as jax_choose_precision
import anakin_tpu_torch as pt
from anakin_tpu_torch import models
from anakin_tpu_torch.convert import graph_from_jax, params_from_numpy
from anakin_tpu_torch.graph.ir import Node, topological_order
from anakin_tpu_torch.graph.shape_infer import infer_shapes
from anakin_tpu_torch.ops import ALIASES, OPS, get_op
from anakin_tpu_torch.ops import detection
from anakin_tpu_torch.ops import quantized as port_quantized
from anakin_tpu_torch.ops.quantized import conv_kind
from anakin_tpu_torch.quant import calibrate, quantize_graph
from anakin_tpu_torch.quant.policy import choose_precision, is_detection_graph
from anakin_tpu_torch.runtime.net import build_forward

from test_torch_mobilenet import _assert_same_graph
from test_torch_ops import run_both
from test_torch_resnet import _f32

OP_RTOL = 1e-6
BF16_RTOL = 8e-3
FLOAT_NET_RTOL = 1e-5
# edges computed from ROI-pooled features: the proposals' corners agree
# within FLOAT_NET_RTOL of the image size (the decode's `exp`), which moves
# the bilinear samples by up to 1e-5 * 128 / 16 cells, times the map's
# slope: measured 1.8e-5 and 2.9e-5 of the largest value (the lite net,
# input seeds 0 and 11)
ROI_NET_RTOL = 1e-4
SOFT_ATOL = 1e-4
BF16_XLA_SCALE_RTOL = 2.0 ** -8
SLAB_OPS = ("detection_output", "rcnn_detection_output")
PROPOSAL_OPS = ("generate_proposals", "rcnn_proposal", "rpn_proposal_ssd",
                "sproposal")


def _close(got, want, what="", rtol=OP_RTOL):
    got, want = np.asarray(got, np.float32), _f32(np.asarray(want))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def _check_slab(got, want, what="", rtol=OP_RTOL, score_col=2):
    """Rows valid on the JAX side are valid on the port's, in the same
    order and within rtol; the other rows are -1 on both."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    valid = want[..., score_col] > 0
    np.testing.assert_array_equal(got[..., score_col] > 0, valid, err_msg=what)
    np.testing.assert_array_equal(got[~valid][:, 1:], -1.0, err_msg=what)
    np.testing.assert_array_equal(got[..., 0], want[..., 0], err_msg=what)
    if valid.any():
        np.testing.assert_array_equal(got[valid][:, 1], want[valid][:, 1],
                                      err_msg=what)  # labels
        _close(got[valid], want[valid], what, rtol)


def _check_proposals(got, want, what="", rtol=OP_RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    valid = ~np.all(want[..., 1:] == -1.0, axis=-1)
    np.testing.assert_array_equal(~np.all(got[..., 1:] == -1.0, axis=-1),
                                  valid, err_msg=what)
    _close(got, want, what, rtol)


# ------------------------------------------------------------- registry


def _names(module_path):
    src = open(module_path).read()
    names = []
    for m in re.finditer(r"@register\(([^)]*)\)", src, re.S):
        names += re.findall(r'"([^"]+)"', m.group(1))
    return names


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("module", ["detection", "extended"])
def test_port_registers_every_name_of_the_jax_module(module):
    """Every op name and alias of `anakin_tpu/ops/{detection,extended}.py`
    resolves in the port to the same op as in the JAX package."""
    names = _names(os.path.join(ROOT, "anakin_tpu", "ops", f"{module}.py"))
    assert len(names) == {"detection": 15, "extended": 12}[module]
    for name in names:
        canon = name if name in OPS else ALIASES[name.lower()]
        assert canon == (name if name.lower() not in JAX_ALIASES
                         else JAX_ALIASES[name.lower()]), name


@pytest.mark.parametrize("name", ["l2_normalize", "normalize", "resize",
                                  "interp", "argmax", "arg_max", "crop",
                                  "deconv2d", "deconvolution", "deconv_relu",
                                  "deconv_batchnorm_scale",
                                  "deconv_batchnorm_scale_relu"])
def test_port_registers_the_slice_nn_and_tensor_ops(name):
    from anakin_tpu.ops.registry import resolve_op_name as jax_resolve
    from anakin_tpu_torch.ops import resolve_op_name
    assert resolve_op_name(name) == jax_resolve(name)


# ------------------------------------------------------------------ NMS


def _boxes(rng, n, lo=0.0, hi=1.0, size=0.3):
    xy = rng.uniform(lo, hi, size=(n, 2))
    wh = rng.uniform(0.02, size, size=(n, 2)) * (hi - lo)
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_iou_matrix():
    b = _boxes(np.random.default_rng(0), 40)
    b[3] = b[5]            # identical boxes
    b[7, 2:] = b[7, :2]    # an empty box
    _close(detection.iou_matrix(torch.from_numpy(b)).numpy(),
           np.asarray(jax_detection.iou_matrix(jnp.asarray(b))))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("thresh,score_thresh,max_out", [
    (0.5, -np.inf, 20), (0.3, 0.4, 50), (0.0, 0.0, 8), (1.0, -np.inf, 70)])
def test_nms_padded(ties, thresh, score_thresh, max_out):
    """Indices and validity equal to the JAX loop's, also with forced ties
    (few distinct scores, repeated boxes) and more steps than boxes."""
    rng = np.random.default_rng(1)
    b = _boxes(rng, 60)
    s = rng.uniform(size=60).astype(np.float32)
    if ties:
        s = np.round(s * 3).astype(np.float32) / 3
        b[10:20] = b[0]
    gi, gv = detection.nms_padded(torch.from_numpy(b), torch.from_numpy(s),
                                  max_out, thresh, score_thresh)
    wi, wv = jax_detection.nms_padded(jnp.asarray(b), jnp.asarray(s),
                                      max_out, thresh, score_thresh)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert gi.dtype == torch.int32


# ------------------------------------------------------------- SSD ops


PRIORBOX = {
    "ssd_conv4_3": dict(min_sizes=[30], max_sizes=[60], aspect_ratios=[2.0]),
    "ssd_fc7": dict(min_sizes=[60], max_sizes=[111],
                    aspect_ratios=[2.0, 3.0]),
    "clip_noflip_step": dict(min_sizes=[20, 40], max_sizes=[50, 80],
                             aspect_ratios=[2.0, 0.5, 1.0], flip=False,
                             clip=True, step=8, offset=0.25),
    "one_max": dict(min_sizes=[16, 32], max_sizes=[64], aspect_ratios=[3.0],
                    variances=[0.1, 0.2, 0.3, 0.4]),
}


@pytest.mark.parametrize("case", sorted(PRIORBOX))
def test_priorbox(case):
    feat = np.zeros((2, 5, 7, 3), np.float32)
    (pair,) = run_both("priorbox", [feat], img_hw=(40, 56), **PRIORBOX[case])
    np.testing.assert_array_equal(*pair)


def _ssd_inputs(rng, n, n_priors, n_cls, ties):
    priors = _boxes(rng, n_priors, size=0.2)
    var = np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), n_priors)
    pri = np.stack([priors.reshape(-1), var])[None].astype(np.float32)
    loc = (rng.normal(size=(n, n_priors * 4)) * 0.5).astype(np.float32)
    logits = rng.normal(size=(n, n_priors, n_cls)) * 2
    conf = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    if ties:  # three score values over every prior and class
        conf = rng.choice([0.005, 0.25, 0.5], size=conf.shape)
    return loc, conf.reshape(n, -1).astype(np.float32), pri


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("attrs", [
    dict(keep_top_k=50, top_k=20, nms_thresh=0.45, conf_thresh=0.01),
    dict(keep_top_k=30, top_k=40, nms_thresh=0.3, conf_thresh=0.2,
         background_id=2, variance_encoded_in_target=True),
])
def test_detection_output(ties, attrs):
    """The slab of two images: the same rows in the same order, with equal
    scores across classes and priors when `ties` (the order of equal
    scores is the lower index first on both)."""
    rng = np.random.default_rng(2)
    loc, conf, pri = _ssd_inputs(rng, 2, 64, 5, ties)
    (pair,) = run_both("detection_output", [loc, conf, pri], num_classes=5,
                       **attrs)
    got, want = pair
    assert (want[..., 2] > 0).sum() > 20
    if ties:
        s = want[..., 2][want[..., 2] > 0]
        assert len(np.unique(s)) < len(s) / 2  # ties among the kept rows
    _check_slab(*pair)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("across,p,scale", [(False, 2, True),
                                            (True, 2, False),
                                            (False, 1, True)])
def test_l2_normalize(dtype, across, p, scale):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 6, 16)).astype(np.float32)
    ins = [x] + ([rng.uniform(1, 20, 16).astype(np.float32)] if scale else [])
    ((got, want),) = run_both("l2_normalize", ins, dtype, eps=1e-10,
                              across_spatial=across, p=p)
    _close(got, want, rtol=BF16_RTOL if dtype == "bf16" else OP_RTOL)


# ------------------------------------------------------------ YOLO ops


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_yolo_box(dtype):
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, 5, 6, 3 * 9)) * 2).astype(np.float32)
    img = np.array([[160, 192], [97, 130]], np.int32)
    (b, s) = run_both("yolo_box", [x, img], dtype, anchors=[10, 13, 16, 30,
                                                           33, 23],
                      class_num=4, conf_thresh=0.3, downsample_ratio=32)
    rtol = BF16_RTOL if dtype == "bf16" else OP_RTOL
    _close(*b, rtol=rtol)
    _close(*s, rtol=rtol)
    assert (s[1] == 0).any() and (s[1] > 0).any()


# ------------------------------------------------------- R-CNN ops


def _rois_across_edges(rng, n_img, h, w, scale):
    """ROIs (image coordinates) in every position against a map of h x w
    cells of 1 / scale pixels: inside, across each edge and corner, wholly
    outside on every side, smaller than a cell, and degenerate."""
    H, W = h / scale, w / scale
    rows = []
    for x1, x2 in [(-20, 10), (5, W - 3), (W - 10, W + 30), (-30, -5),
                   (W + 5, W + 40), (3, 3.5), (-50, W + 50)]:
        for y1, y2 in [(-15, 12), (4, H - 2), (H - 8, H + 25), (-40, -2),
                       (H + 2, H + 20), (7, 7.2), (-50, H + 50)]:
            rows.append([rng.integers(0, n_img), x1, y1, x2, y2])
    rows.append([0, 12, 8, 4, 2])  # x2 < x1
    return np.asarray(rows, np.float32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("pooled,scale,sampling", [((7, 7), 1 / 16, 2),
                                                   ((3, 5), 0.5, 1),
                                                   ((4, 4), 1 / 8, 3),
                                                   ((2, 2), 1.0, 0)])
def test_roi_align(dtype, pooled, scale, sampling):
    """ROIs across every edge of the map, outside it, and smaller than a
    cell (the samples clamp onto the map as in the JAX op)."""
    rng = np.random.default_rng(5)
    feat = rng.normal(size=(2, 9, 11, 6)).astype(np.float32)
    rois = _rois_across_edges(rng, 2, 9, 11, scale)
    ((got, want),) = run_both("roi_align", [feat, rois], dtype,
                              pooled_hw=pooled, spatial_scale=scale,
                              sampling_ratio=sampling)
    _close(got, want, rtol=BF16_RTOL if dtype == "bf16" else OP_RTOL)


@pytest.mark.parametrize("op", ["roi_pool", "ps_roi_pooling", "sroi_align"])
@pytest.mark.parametrize("pooled,scale", [((3, 3), 0.25), ((2, 4), 1.0)])
def test_roi_pool(op, pooled, scale):
    """Max pooling on the quantized grid, empty cells 0, across edges."""
    rng = np.random.default_rng(6)
    feat = rng.normal(size=(2, 9, 11, 4)).astype(np.float32)
    rois = _rois_across_edges(rng, 2, 9, 11, scale)
    ((got, want),) = run_both(op, [feat, rois], pooled_hw=pooled,
                              spatial_scale=scale)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("attrs", [
    dict(),
    dict(anchor_sizes=[16, 40], aspect_ratios=[1.0, 0.25], stride=[8.0, 4.0],
         offset=0.0, variances=[1.0, 1.0, 1.0, 1.0])])
def test_anchor_generator(attrs):
    feat = np.zeros((1, 6, 5, 2), np.float32)
    for got, want in run_both("anchor_generator", [feat], **attrs):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_var", [True, False])
@pytest.mark.parametrize("normalized", [True, False])
def test_box_coder(with_var, normalized):
    rng = np.random.default_rng(7)
    priors = _boxes(rng, 12) * (1 if normalized else 50)
    var = rng.uniform(0.1, 0.3, size=(12, 4)).astype(np.float32)
    t = rng.normal(size=(3, 12, 4)).astype(np.float32)
    ins = [priors, var, t] if with_var else [priors, t]
    ((got, want),) = run_both("box_coder", ins, box_normalized=normalized)
    _close(got, want)


def test_box_clip():
    rng = np.random.default_rng(8)
    boxes = rng.uniform(-30, 130, size=(2, 7, 4)).astype(np.float32)
    info = np.array([[100, 80, 1.0], [120, 90, 2.0]], np.float32)
    ((got, want),) = run_both("box_clip", [boxes, info])
    np.testing.assert_array_equal(got, want)


def _rcnn_inputs(rng, b, r, c, agnostic, ties):
    rois = np.concatenate([
        np.repeat(np.arange(b, dtype=np.float32), r)[:, None],
        _boxes(rng, b * r, 0, 90, size=0.4)], -1).reshape(b, r, 5)
    rois[0, :3, 1:] = -1.0          # invalid rows, as generate_proposals writes
    rois[1, 3, 0] = -1.0            # a negative batch index
    rois[1, 4, 3] = rois[1, 4, 1] - 5  # x2 < x1
    logits = rng.normal(size=(b * r, c)) * 2
    if ties:
        logits = np.round(logits)
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    deltas = rng.normal(size=(b * r, 4 if agnostic else 4 * c)) * 2
    deltas[0, :4] = [0, 0, 40, 40]  # exp clamp at 10
    info = np.array([[100, 110, 1.0], [80, 60, 0.5]], np.float32)[:b]
    return [rois, prob.astype(np.float32), deltas.astype(np.float32), info]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("agnostic", [False, True])
def test_rcnn_detection_output(agnostic, ties):
    rng = np.random.default_rng(9)
    ins = _rcnn_inputs(rng, 2, 24, 4, agnostic, ties)
    (pair,) = run_both("rcnn_detection_output", ins, num_classes=4,
                       keep_top_k=40, top_k=15, nms_thresh=0.3,
                       conf_thresh=0.05)
    assert (pair[1][..., 2] > 0).sum() > 10
    _check_slab(*pair)


def _rpn_inputs(rng, n, h, w, a, ties):
    scores = rng.uniform(size=(n, h, w, a)).astype(np.float32)
    if ties:
        scores = np.round(scores * 4) / 4
    deltas = (rng.normal(size=(n, h, w, a * 4)) * 0.5).astype(np.float32)
    deltas[0, 0, 0, :4] = [0, 0, 30, 30]  # the exp clamp
    info = np.array([[h * 16, w * 16, 1.0]] * n, np.float32)
    feat = np.zeros((n, h, w, 1), np.float32)
    node = JaxNode("g", "anchor_generator", ["f"], ["a", "v"],
                   dict(anchor_sizes=[24, 48, 96][:a], aspect_ratios=[1.0],
                        stride=[16.0, 16.0], variances=[1.0, 0.5, 1.0, 0.7]))
    anchors, var = (np.asarray(t) for t in jax_get_op("anchor_generator")(
        node, [jnp.asarray(feat)]))
    return [scores, deltas, info, anchors, var]


@pytest.mark.parametrize("op", PROPOSAL_OPS)
@pytest.mark.parametrize("ties,pre_n,post_n,min_size", [
    (False, 60, 20, 4.0), (True, 500, 40, 0.0), (True, 30, 40, 16.0)])
def test_generate_proposals(op, ties, pre_n, post_n, min_size):
    """Top-k with ties to the lower index, boxes under min_size dropped,
    pre_n past the anchors' count, post_n past what NMS keeps (-1 rows)."""
    rng = np.random.default_rng(10)
    ins = _rpn_inputs(rng, 2, 6, 7, 3, ties)
    (pair,) = run_both(op, ins, pre_nms_top_n=pre_n, post_nms_top_n=post_n,
                       nms_thresh=0.7, min_size=min_size)
    _check_proposals(*pair)


def test_invalid_proposals_keep_their_batch_index_as_in_jax():
    """The JAX `generate_proposals` writes an invalid row as (b, -1, -1, -1,
    -1), and `rcnn_detection_output` takes a ROI as invalid only for x2 <
    x1 or a negative batch index, so it decodes such a row as a 1 x 1 box
    at (-1, -1), clips it to (0, 0, 0, 0) and can detect it (ROADMAP §3
    item 13).  The port copies both, so that its slabs equal the JAX
    package's."""
    rng = np.random.default_rng(17)
    ins = _rpn_inputs(rng, 1, 3, 3, 1, False)  # 9 anchors, 12 rows asked
    (pair,) = run_both("generate_proposals", ins, pre_nms_top_n=9,
                       post_nms_top_n=12, nms_thresh=0.7)
    got, rois = pair
    _check_proposals(got, rois)
    invalid = np.all(rois[..., 1:] == -1.0, axis=-1)
    assert invalid.sum() >= 3
    np.testing.assert_array_equal(got[..., 0], rois[..., 0])
    assert (rois[invalid][:, 0] == 0).all()  # the batch index, not -1
    prob = rng.uniform(0, 0.1, size=(12, 3)).astype(np.float32)
    prob[invalid[0], 1] = 0.9
    deltas = np.zeros((12, 12), np.float32)
    info = np.array([[48, 48, 1.0]], np.float32)
    (pair,) = run_both("rcnn_detection_output", [rois, prob, deltas, info],
                       num_classes=3, keep_top_k=20, conf_thresh=0.05)
    _check_slab(*pair)
    want = pair[1][0]
    ghost = (want[:, 2] == np.float32(0.9)) & np.all(want[:, 3:] == 0, -1)
    assert ghost.sum() == invalid.sum()


# ------------------------------------------------------- extended ops


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("k,stride,pad,dil,bias", [(3, 1, 1, 1, True),
                                                   (3, 2, 0, 2, False),
                                                   (1, 1, 0, 1, True)])
def test_deformable_conv(dtype, k, stride, pad, dil, bias):
    """Offsets that move taps off the map (zero there) and between pixels."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 7, 8, 5)).astype(np.float32)
    oh = (7 + 2 * pad - dil * (k - 1) - 1) // stride + 1
    ow = (8 + 2 * pad - dil * (k - 1) - 1) // stride + 1
    off = (rng.normal(size=(2, oh, ow, 2 * k * k)) * 2).astype(np.float32)
    w = (rng.normal(size=(k, k, 5, 6)) * 0.3).astype(np.float32)
    ins = [x, off, w] + ([rng.normal(size=6).astype(np.float32)] if bias
                         else [])
    ((got, want),) = run_both("deformable_conv", ins, dtype,
                              strides=(stride, stride), padding=(pad, pad),
                              dilation=(dil, dil), has_bias=bias)
    _close(got, want, rtol=BF16_RTOL if dtype == "bf16" else 1e-5)


@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("lengths", [False, True])
def test_ctc_align(merge, lengths):
    rng = np.random.default_rng(12)
    labels = rng.integers(0, 4, size=(4, 11)).astype(np.int32)
    labels[3] = [1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2]  # every label kept
    ins = [labels] + ([np.array([11, 5, 0, 11], np.int32)] if lengths else [])
    for got, want in run_both("ctc_align", ins, blank=0,
                              merge_repeated=merge):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_topk_pooling(dtype):
    x = np.random.default_rng(13).normal(size=(2, 3, 4, 5)).astype(np.float32)
    x[0, 0, :2, 0] = x[0, 1, 0, 0]  # equal values
    ((got, want),) = run_both("topk_pooling", [x], dtype, top_k=3)
    np.testing.assert_array_equal(got, want)
    ((got, want),) = run_both("topk_avg_pooling", [x], dtype, top_ks=[1, 3, 5])
    _close(got, want, rtol=BF16_RTOL if dtype == "bf16" else OP_RTOL)


@pytest.mark.parametrize("op", ["dfmb_psroi_align", "dfm_ps_roi_align"])
def test_dfmb_psroi_align(op):
    rng = np.random.default_rng(14)
    feat = rng.normal(size=(2, 9, 11, 3 * 2 * 4)).astype(np.float32)
    rois = _rois_across_edges(rng, 2, 9, 11, 0.5)
    ((got, want),) = run_both(op, [feat, rois], pooled_hw=(3, 2),
                              spatial_scale=0.5)
    _close(got, want)


def test_small_extended_ops():
    """rois_anchor_feature, proposal_img_scale_to_cam_coords,
    rcnn_det_output_with_attr (with and without attributes, tied scores),
    affine_channel and conv_unpadding_padding."""
    rng = np.random.default_rng(15)
    rois = np.concatenate([np.zeros((9, 1)), _boxes(rng, 9, 0, 50)],
                          -1).astype(np.float32)
    ((g, w),) = run_both("rois_anchor_feature", [rois], img_w=64.0, img_h=48.0)
    _close(g, w)
    cam = np.array([700, 710, 320, 200, 1.5, 1.0], np.float32)
    boxes = _boxes(rng, 9, 150, 400)
    ((g, w),) = run_both("proposal_img_scale_to_cam_coords", [boxes, cam])
    _close(g, w)
    scores = rng.uniform(size=(9, 4)).astype(np.float32)
    scores[2] = 0.25  # a tie: the first class
    attrs = rng.normal(size=(9, 3)).astype(np.float32)
    for ins in ([rois, scores], [rois, scores, attrs]):
        ((g, w),) = run_both("rcnn_det_output_with_attr", ins)
        np.testing.assert_array_equal(g, w)
    x = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    sw, bw = (rng.normal(size=5).astype(np.float32) for _ in range(2))
    for dtype in ("fp32", "bf16"):
        ((g, w),) = run_both("affine_channel", [x, sw, bw], dtype)
        _close(g, w, rtol=BF16_RTOL if dtype == "bf16" else OP_RTOL)
    seq = rng.normal(size=(3, 6, 4)).astype(np.float32)
    lens = np.array([6, 2, 0], np.int32)
    for ins in ([seq, lens], [seq], [seq[..., 0], lens]):
        ((g, w),) = run_both("conv_unpadding_padding", ins)
        np.testing.assert_array_equal(g, w)


class _NoHostSync(TorchDispatchMode):
    """Raises where an op reads a tensor's value on the host (`.item()`,
    indexing by a 0-dim tensor, `bool(t)`) or indexes by a tensor
    (`x[..., [1, 2]]` copies its Python list from the host): on CUDA
    either inside a captured step fails the capture.  Every selection of
    the detection ops is a `gather` or an `index_select`."""

    SYNCS = (torch.ops.aten.item.default,
             torch.ops.aten._local_scalar_dense.default,
             torch.ops.aten.is_nonzero.default,
             torch.ops.aten.index.Tensor)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.SYNCS:
            raise AssertionError(f"a host sync or copy ({func})")
        return func(*args, **(kwargs or {}))


def test_detection_ops_are_capture_safe(monkeypatch):
    """NMS, the SSD and R-CNN slabs, proposals, roi_align, yolo_box, the
    prior boxes and anchors, and the segmentation tail read no tensor value
    on the host and make no tensor from host data (a CUDA capture fails on
    either: a sync, or a copy from pageable host memory), and give what
    they give outside the check."""
    rng = np.random.default_rng(16)
    loc, conf, pri = _ssd_inputs(rng, 2, 32, 4, True)
    cases = [("detection_output", [loc, conf, pri], dict(num_classes=4,
                                                         keep_top_k=20)),
             ("rcnn_detection_output", _rcnn_inputs(rng, 2, 8, 3, False,
                                                    True),
              dict(num_classes=3)),
             ("generate_proposals", _rpn_inputs(rng, 2, 4, 4, 2, True),
              dict(pre_nms_top_n=20, post_nms_top_n=8)),
             ("roi_align", [rng.normal(size=(2, 5, 5, 3)).astype(np.float32),
                            _rois_across_edges(rng, 2, 5, 5, 1.0)], {}),
             ("yolo_box", [rng.normal(size=(1, 2, 2, 18)).astype(np.float32),
                           np.array([[64, 64]], np.int32)],
              dict(anchors=[1, 2, 3, 4], class_num=4)),
             ("priorbox", [np.zeros((1, 3, 4, 2), np.float32)],
              dict(img_hw=(24, 32), **PRIORBOX["ssd_fc7"])),
             ("anchor_generator", [np.zeros((1, 3, 4, 2), np.float32)], {}),
             ("resize", [rng.normal(size=(1, 3, 4, 2)).astype(np.float32)],
              dict(out_hw=(7, 5), align_corners=True)),
             ("argmax", [rng.normal(size=(1, 3, 4, 5)).astype(np.float32)],
              dict(axis=3))]

    def host_data(*a, **kw):
        raise AssertionError("a tensor made from host data")

    for op, ins, attrs in cases:
        node = Node("n", op, [f"i{k}" for k in range(len(ins))], ["out"],
                    attrs)
        xs = [torch.from_numpy(np.array(a)) for a in ins]
        first = get_op(op)(node, xs)
        with monkeypatch.context() as m, _NoHostSync():
            for name in ("tensor", "as_tensor", "from_numpy"):
                m.setattr(torch, name, host_data)
            again = get_op(op)(node, xs)
        for a, b in zip(first, again):
            assert torch.equal(a, b), op


class _PythonDivisors(TorchDispatchMode):
    """Records each division by a Python number that is not a power of two:
    on CUDA, PyTorch computes such an x / s as x * (1 / s)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.div.Tensor, torch.ops.aten.div_.Tensor) \
                and isinstance(args[1], (int, float)) \
                and math.frexp(float(args[1]))[0] != 0.5:
            self.seen.append(args[1])
        return func(*args, **(kwargs or {}))


def test_detection_ops_divide_as_the_cpu_does():
    """Fault 16 (ROADMAP §3): CUDA divides a tensor by a Python number as a
    product with its reciprocal, which parts from the quotient by one bit
    in about a third of SSD's fc7 prior coordinates (numpy, below); SSD's
    priors on the card were a bit off the CPU's, and its detections moved
    with them.  The detection ops and resize divide by a 0-dim tensor on
    their own device: no division by a Python number but a power of two
    is left, and the priors equal the JAX op's bit for bit."""
    cx = (np.arange(19, dtype=np.float32) + np.float32(0.5)) * np.float32(
        300 / 19)
    edges = np.concatenate([cx - np.float32(30), cx + np.float32(30)])
    quotient = edges / np.float32(300)
    product = edges * (np.float32(1) / np.float32(300))
    assert (quotient != product).mean() > 0.1
    rng = np.random.default_rng(17)
    feat = rng.normal(size=(2, 5, 5, 3)).astype(np.float32)
    rois = _rois_across_edges(rng, 2, 5, 5, 1.0)
    cases = [("priorbox", [np.zeros((1, 19, 19, 2), np.float32)],
              dict(img_hw=(300, 300), **PRIORBOX["ssd_fc7"])),
             ("yolo_box", [rng.normal(size=(1, 3, 3, 18)).astype(np.float32),
                           np.array([[96, 96]], np.int32)],
              dict(anchors=[1, 2, 3, 4], class_num=4)),
             ("roi_align", [feat, rois], dict(pooled_hw=(3, 3),
                                              sampling_ratio=3)),
             ("roi_pool", [feat, rois], dict(pooled_hw=(3, 3))),
             ("resize", [feat], dict(out_hw=(7, 9), align_corners=True))]
    for op, ins, attrs in cases:
        node = Node("n", op, [f"i{k}" for k in range(len(ins))], ["out"],
                    attrs)
        with _PythonDivisors() as mode:
            get_op(op)(node, [torch.from_numpy(a) for a in ins])
        assert mode.seen == [], (op, mode.seen)
    ((got, want),) = run_both("priorbox", cases[0][1], **cases[0][2])
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------- nets


# name -> (builder, its arguments, the extra inputs' values)
NETS = {
    "ssd_vgg16": ("build_ssd_vgg16", dict(batch=1, image_size=264)),
    "yolo_v3_tiny": ("build_yolo_v3_tiny", dict(batch=2, image_size=128,
                                                width_mult=0.25)),
    "faster_rcnn": ("build_faster_rcnn", dict(batch=2, image_size=128,
                                              base_width=8)),
    "faster_rcnn_lite": ("build_faster_rcnn_lite", dict(batch=2,
                                                        image_size=128)),
}
# int8 kernel launches of one int8 forward at these sizes
ROUTES = {
    # 13 VGG 3x3 and 12 3x3 heads; fc6 (dilated), fc7, the 8 extras
    "ssd_vgg16": dict(conv3x3_int8=25, matmul_int8=10),
    "yolo_v3_tiny": dict(conv3x3_int8=9, matmul_int8=4),
    # the 7x7 stem (s2d, pinned fp32) is no int8 node; the strided 1x1 and
    # 3x3 convs go through im2col; 2 RPN heads, 2 dense heads
    "faster_rcnn": dict(conv3x3_int8=14, matmul_int8=43),
    # its stem (3x3 s2 on the image) is rewritten to s2d and pinned fp32
    "faster_rcnn_lite": dict(conv3x3_int8=1, matmul_int8=8),
}


def _feed(name, kw, seed):
    b, s = kw["batch"], kw["image_size"]
    feed = {"input": np.random.default_rng(seed).normal(
        size=(b, s, s, 3)).astype(np.float32)}
    if name == "yolo_v3_tiny":
        feed["img_size"] = np.array([[s, s]] * b, np.int32)
    elif name.startswith("faster_rcnn"):
        feed["im_info"] = np.array([[s, s, 1.0]] * b, np.float32)
    return feed


def _interpret(fn):
    old = os.environ.get("ANAKIN_PALLAS_INTERPRET")
    os.environ["ANAKIN_PALLAS_INTERPRET"] = "1"
    try:
        return fn()
    finally:
        if old is None:
            del os.environ["ANAKIN_PALLAS_INTERPRET"]
        else:
            os.environ["ANAKIN_PALLAS_INTERPRET"] = old


def _taps(graph, feed, precision):
    edges = [e for n in ak.topological_order(graph) for e in n.outputs]
    return _interpret(lambda: {
        k: np.asarray(v) for k, v in
        ak.Net(graph, precision=precision, tap_edges=edges)
        .prediction(feed).items()})


@pytest.fixture(scope="module", params=sorted(NETS))
def case(request):
    """The JAX optimized float graph, its quantized graph with the Pallas
    route forced where eligible, the feed, the scales, and every edge of
    the JAX nets: float32 and bf16, float and int8."""
    name = request.param
    fn, kw = NETS[name]
    g = ak.optimize(getattr(jax_models, fn)(**kw))
    feed = _feed(name, kw, 11)
    scales = jax_calibrate(g, [feed], method="max")
    gq = jax_quantize_graph(g, scales)
    for node in gq.nodes.values():
        if node.op.endswith("_int8") and _pallas_eligible(node):
            node.attrs["impl"] = "pallas"
    return dict(name=name, kw=kw, g=g, gq=gq, feed=feed, scales=scales,
                taps={(q, p): _taps(gg, feed, p)
                      for q, gg in (("float", g), ("int8", gq))
                      for p in ("fp32", "bf16")})


def test_graph_matches_jax_package(case):
    """The builder alone, then `optimize`, then `quantize_graph` give the
    JAX package's graphs node for node and byte for byte."""
    fn, kw = NETS[case["name"]]
    raw = getattr(models, fn)(**kw)
    _assert_same_graph(raw, getattr(jax_models, fn)(**kw))
    got = pt.optimize(raw)
    _assert_same_graph(got, case["g"])
    _assert_same_graph(quantize_graph(got, case["scales"]),
                       jax_quantize_graph(case["g"], case["scales"]))


def test_meta_shapes_match_jax(case):
    """Shape inference on the meta device gives the JAX package's shape
    and dtype for every edge of the float and the int8 graph."""
    for g in (case["g"], case["gq"]):
        want = jax_infer_shapes(g)
        got = infer_shapes(graph_from_jax(g))
        for e, w in want.items():
            assert tuple(got[e].shape) == tuple(w.shape), e
            assert str(got[e].dtype).endswith(np.dtype(w.dtype).name), e


def test_policy_matches_jax(case):
    """`is_detection_graph` holds, and `choose_precision` decides as the
    JAX package does at every batch and dispatch mode."""
    g = graph_from_jax(case["g"])
    assert is_detection_graph(g)
    for batch in (1, 4, 15, 16, 64):
        for bound in (True, False):
            assert (choose_precision(g, batch, bound)
                    == jax_choose_precision(case["g"], batch, bound))


def _downstream_of_rois(g):
    """The edges computed from a ROI pooling's output."""
    out = set()
    for node in topological_order(g):
        if node.op in ("roi_align", "roi_pool") or out & set(node.inputs):
            out.update(node.outputs)
    return out


def _sigmoid_atol(node, g, taps):
    """FLOAT_NET_RTOL of the node's largest pre-activation value (its op
    without the activation, on the JAX net's inputs) times the sigmoid's
    largest slope, 1/4."""
    pre = Node(node.name, node.op, list(node.inputs), list(node.outputs),
               dict(node.attrs, activation=None))
    xs = [torch.from_numpy(np.array(taps[e] if e in taps else g.params[e]))
          for e in node.inputs]
    return FLOAT_NET_RTOL * float(get_op(node.op)(pre, xs)[0].abs().max()) / 4


def _check_net_edge(node, got, want, what, rtol=FLOAT_NET_RTOL, atol=None,
                    exact_int8=False):
    assert str(got.dtype).endswith(want.dtype.name), (what, got.dtype,
                                                      want.dtype)
    if node.op in SLAB_OPS:
        _check_slab(got.float().numpy(), want, what, rtol)
    elif node.op in PROPOSAL_OPS:
        _check_proposals(got.float().numpy(), want, what, rtol)
    elif node.op == "softmax":
        np.testing.assert_allclose(got.float().numpy(), _f32(want), rtol=0,
                                   atol=SOFT_ATOL, err_msg=what)
    elif want.dtype == np.int8:
        d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        assert d.max() <= (0 if exact_int8 else 1), (what, d.max())
    elif atol is not None:
        np.testing.assert_allclose(got.float().numpy(), _f32(want), rtol=0,
                                   atol=atol, err_msg=what)
    else:
        _close(got.float().numpy(), want, what, rtol)


def _jax_pallas_route(node, g):
    """Whether the JAX package computes this int8 node on a Pallas kernel:
    an `impl="pallas"` node of a kernel's exact shape class (a 3x3 s1 p0
    conv is a "gemm" kind node that the JAX op leaves to XLA)."""
    if node.attr("impl") != "pallas":
        return False
    if node.op == "dense_int8":
        return True
    k = tuple(g.params[node.inputs[1]].shape[:2])
    kind = conv_kind(node)
    return ((kind == "gemm" and k == (1, 1))
            or (kind in ("conv3x3", "dw3x3") and k == (3, 3)))


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_fp32_net_matches_jax_net(case, kind):
    """The whole float32 net, float or int8, every edge (its outputs, the
    detection slabs, included) against the JAX net's."""
    g = case["g"] if kind == "float" else case["gq"]
    want = case["taps"][(kind, "fp32")]
    edges = [e for n in topological_order(g) for e in n.outputs]
    got = pt.Net(graph_from_jax(g), device="cpu", tap_edges=edges).prediction(
        case["feed"])
    roi_edges = _downstream_of_rois(g)
    taps = dict(want, **case["feed"])
    for node in topological_order(g):
        atol = (_sigmoid_atol(node, g, taps)
                if node.op in ("conv2d", "dense")
                and node.attr("activation") == "sigmoid" else None)
        for e in node.outputs:
            _check_net_edge(node, got[e], want[e], e, atol=atol,
                            rtol=ROI_NET_RTOL if e in roi_edges
                            else FLOAT_NET_RTOL,
                            exact_int8=_jax_pallas_route(node, g))
    ops = {e: n.op for n in g.nodes.values() for e in n.outputs}
    valid = [(want[o][..., 2] > 0).sum() for o in g.outputs
             if ops[o] in SLAB_OPS]
    assert all(v > 0 for v in valid), valid  # the slabs hold detections


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_bf16_net_matches_jax_net_node_by_node(case, kind):
    """Every node of the bf16 net, float or int8, run on the JAX net's
    values of its inputs, against the JAX net's value of its output."""
    g = graph_from_jax(case["g"] if kind == "float" else case["gq"])
    taps = dict(case["taps"][(kind, "bf16")], **case["feed"])
    net = pt.Net(g, precision="bf16", device="cpu")
    for node in topological_order(g):
        fwd, _ = build_forward(g, "bf16", start_from=node.name,
                               stop_at=node.name)
        feed = params_from_numpy(
            {e: taps[e] for e in node.inputs if e not in g.params}, "cpu")
        with torch.inference_mode():
            ys = fwd(net.params, feed, net.prepared)
        for e in node.outputs:
            y, want = ys[e], taps[e]
            if node.op in SLAB_OPS:
                _check_slab(y.float().numpy(), want, node.name)
            elif node.op in PROPOSAL_OPS:
                _check_proposals(y.float().numpy(), want, node.name)
            elif (node.op in ("conv2d_int8", "dense_int8")
                  and not _jax_pallas_route(node, g)
                  and want.dtype == np.float32):
                np.testing.assert_allclose(
                    y.numpy(), want, rtol=BF16_XLA_SCALE_RTOL,
                    atol=BF16_XLA_SCALE_RTOL * np.abs(want).max(),
                    err_msg=node.name)
            elif want.dtype == np.int8:
                d = np.abs(y.numpy().astype(np.int32) - want.astype(np.int32))
                assert d.max() <= 1, (node.name, d.max())
            elif want.dtype.name == "bfloat16":
                np.testing.assert_allclose(y.float().numpy(), _f32(want),
                                           rtol=BF16_RTOL, atol=1e-4,
                                           err_msg=node.name)
            else:
                _close(y.float().numpy(), want, node.name)


def test_int8_net_routes_to_the_kernels(case, monkeypatch):
    """One int8 forward (run on the meta device: the ops route as on any
    other) calls conv3x3_int8 and matmul_int8 the counted number of times;
    SSD's fc6 stays dilated (6) and goes through int8 im2col on
    matmul_int8."""
    calls = {}
    for name in ("matmul_int8", "conv3x3_int8", "depthwise3x3_int8"):
        real = getattr(port_quantized, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(port_quantized, name, counted)
    g = graph_from_jax(case["gq"])
    infer_shapes(g)
    assert calls == ROUTES[case["name"]]
    dilated = [n for n in g.nodes.values() if n.op == "conv2d_int8"
               and tuple(n.attr("dilation", (1, 1))) != (1, 1)]
    if case["name"] == "ssd_vgg16":
        assert len(dilated) == 1
        assert tuple(dilated[0].attr("dilation")) == (6, 6)
        assert conv_kind(dilated[0]) == "other"
        assert g.params[dilated[0].inputs[1]].shape == (3, 3, 512, 1024)
    else:
        assert not dilated


@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("name", ["yolo_v3_tiny", "faster_rcnn",
                                  "faster_rcnn_lite"])
def test_net_forward_is_capture_safe(name, kind, monkeypatch):
    """A whole bf16 forward (the backbone's ops and the kernels' wrappers
    with the heads) reads no tensor value on the host and makes no tensor
    from host data, so `Net.compile` can capture it on CUDA."""
    fn, kw = NETS[name]
    g = pt.optimize(getattr(models, fn)(**kw))
    feed = {k: torch.from_numpy(v) for k, v in _feed(name, kw, 3).items()}
    if kind == "int8":
        g = quantize_graph(g, calibrate(g, [feed], method="max",
                                        device="cpu"))
    net = pt.Net(g, precision="bf16", device="cpu")

    def host_data(*a, **kw):
        raise AssertionError("a tensor made from host data")

    for fname in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, fname, host_data)
    with _NoHostSync(), torch.inference_mode():
        out = net.forward(net.params, feed, net.prepared)
    assert all(torch.isfinite(out[e].float()).all() for e in g.outputs)
