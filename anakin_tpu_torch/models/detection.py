"""Detection graph construction, the port of `anakin_tpu/models/detection.py`
(numpy only: each graph equals the JAX package's node for node and byte for
byte): SSD300 on VGG16, YOLOv3-tiny, the two-stage Faster R-CNN on
ResNet-50-C4, and the Faster R-CNN lite.

Built unoptimized (conv / bn / relu separate), so that `optimize` fuses them
as it fuses the classification nets; the heads use the static-slab
detection ops (`ops/detection.py`).  Once quantized, the 3x3 s1 p1 convs run
on `conv3x3_int8`, the 1x1 convs and dense layers on `matmul_int8`, and every
other conv (SSD's dilated fc6, the strided and 7x7 convs) through int8
im2col on `matmul_int8`.
"""

from __future__ import annotations


from ..graph.ir import Graph, GraphBuilder
from .resnet import _P, _conv_bn_relu

__all__ = ["build_ssd_vgg16", "build_yolo_v3_tiny", "build_faster_rcnn",
           "build_faster_rcnn_lite"]


def _conv_relu(b, p, x, cin, cout, k, stride, pad):
    w = p.conv_w(k, k, cin, cout)
    bias = p.vec(cout, val=0.0)
    y = b.op("conv2d", [x, w, bias], strides=(stride, stride),
             padding=(pad, pad), has_bias=True)
    return b.op("activation", [y], activation="relu")


def build_ssd_vgg16(batch: int = 1, image_size: int = 300,
                    num_classes: int = 21, seed: int = 0) -> Graph:
    """SSD300: VGG16 conv stack + extra feature layers + priorbox heads +
    detection_output (reference VGG16-SSD, `README.md:104`)."""
    b = GraphBuilder("ssd_vgg16")
    p = _P(b, seed)
    x = b.input((batch, image_size, image_size, 3), name="input")
    y = x
    cin = 3
    # VGG base through conv4_3 and conv5_3 (pool5 3x3 s1), fc6/fc7 dilated
    cfg = [(64, 2), (128, 2), (256, 3)]
    for cout, n in cfg:
        for _ in range(n):
            y = _conv_relu(b, p, y, cin, cout, 3, 1, 1)
            cin = cout
        y = b.op("pool2d", [y], mode="max", window=(2, 2), strides=(2, 2),
                 padding=(0, 0), ceil_mode=True)
    for _ in range(3):
        y = _conv_relu(b, p, y, cin, 512, 3, 1, 1)
        cin = 512
    conv4_3 = b.op("l2_normalize", [y, p.vec(512, val=20.0)], eps=1e-12)
    y = b.op("pool2d", [y], mode="max", window=(2, 2), strides=(2, 2),
             padding=(0, 0), ceil_mode=True)
    for _ in range(3):
        y = _conv_relu(b, p, y, cin, 512, 3, 1, 1)
    y = b.op("pool2d", [y], mode="max", window=(3, 3), strides=(1, 1),
             padding=(1, 1), ceil_mode=True)
    y = _conv_relu(b, p, y, 512, 1024, 3, 1, 6)  # fc6 dilated
    # fix dilation on the conv we just made
    list(b.graph.nodes.values())[-2].attrs["dilation"] = (6, 6)
    fc7 = _conv_relu(b, p, y, 1024, 1024, 1, 1, 0)

    # extra layers
    def extra(x, cin, mid, cout, stride, pad):
        y = _conv_relu(b, p, x, cin, mid, 1, 1, 0)
        return _conv_relu(b, p, y, mid, cout, 3, stride, pad)

    conv8 = extra(fc7, 1024, 256, 512, 2, 1)
    conv9 = extra(conv8, 512, 128, 256, 2, 1)
    conv10 = extra(conv9, 256, 128, 256, 1, 0)
    conv11 = extra(conv10, 256, 128, 256, 1, 0)

    sources = [(conv4_3, 512, 4), (fc7, 1024, 6), (conv8, 512, 6),
               (conv9, 256, 6), (conv10, 256, 4), (conv11, 256, 4)]
    min_sizes = [30, 60, 111, 162, 213, 264]
    max_sizes = [60, 111, 162, 213, 264, 315]
    loc_flat, conf_flat, priors = [], [], []
    for i, (src, c, n_box) in enumerate(sources):
        w_loc = p.conv_w(3, 3, c, n_box * 4)
        loc = b.op("conv2d", [src, w_loc, p.vec(n_box * 4, val=0.0)],
                   strides=(1, 1), padding=(1, 1), has_bias=True)
        loc_flat.append(b.op("flatten", [loc], axis=1))
        w_conf = p.conv_w(3, 3, c, n_box * num_classes)
        conf = b.op("conv2d", [src, w_conf, p.vec(n_box * num_classes, val=0.0)],
                    strides=(1, 1), padding=(1, 1), has_bias=True)
        conf_flat.append(b.op("flatten", [conf], axis=1))
        ar = [2.0] if n_box == 4 else [2.0, 3.0]
        priors.append(b.op(
            "priorbox", [src], img_hw=(image_size, image_size),
            min_sizes=[min_sizes[i]], max_sizes=[max_sizes[i]],
            aspect_ratios=ar, flip=True, clip=False,
            variances=[0.1, 0.1, 0.2, 0.2]))
    loc_all = b.op("concat", loc_flat, axis=1)
    conf_all = b.op("concat", conf_flat, axis=1)
    prior_all = b.op("concat", priors, axis=2)
    # softmax over classes
    n_priors_total = None  # shape-inferred
    conf_rs = b.op("reshape", [conf_all], shape=[0, -1, num_classes])
    conf_sm = b.op("softmax", [conf_rs], axis=2)
    conf_back = b.op("flatten", [conf_sm], axis=1)
    det = b.op("detection_output", [loc_all, conf_back, prior_all],
               num_classes=num_classes, background_id=0, keep_top_k=200,
               top_k=100, nms_thresh=0.45, conf_thresh=0.01)
    b.output(det)
    return b.finish()


def build_yolo_v3_tiny(batch: int = 1, image_size: int = 416,
                       num_classes: int = 80, seed: int = 0,
                       width_mult: float = 1.0,
                       anchors1=None, anchors2=None,
                       conf_thresh: float = 0.005) -> Graph:
    """YOLOv3-tiny-style: conv/pool backbone, two yolo_box heads
    (reference: `yolo_box` op + `yolo_v3_test`).

    `width_mult` scales every channel width (min 8) — the narrow variants
    train on CPU for the round-5 int8 detection-quality study while
    keeping the exact topology/op set.  `anchors1/anchors2` override the
    per-head anchor priors (pixel w,h pairs; defaults are the darknet
    tiny set for 416 input)."""
    def c(n):
        return max(8, int(round(n * width_mult)))

    b = GraphBuilder("yolo_v3_tiny")
    p = _P(b, seed)
    x = b.input((batch, image_size, image_size, 3), name="input")
    img_size = b.input((batch, 2), dtype="int32", name="img_size")
    y = x
    cin = 3
    feats = {}
    for i, cout in enumerate(map(c, (16, 32, 64, 128, 256, 512))):
        y = _conv_bn_relu(b, p, y, cin, cout, 3, 1, 1, relu=False)
        y = b.op("activation", [y], activation="leaky_relu", act_alpha=0.1)
        cin = cout
        if i == 4:
            feats["c4"] = y
        if i < 5:
            y = b.op("pool2d", [y], mode="max", window=(2, 2),
                     strides=(2, 2), padding=(0, 0), ceil_mode=False)
        else:
            # darknet's stride-1 "same" pool: 3x3 s1 pad1 keeps the map size
            y = b.op("pool2d", [y], mode="max", window=(3, 3),
                     strides=(1, 1), padding=(1, 1), ceil_mode=False)
    y = _conv_bn_relu(b, p, y, c(512), c(1024), 3, 1, 1)
    y = _conv_bn_relu(b, p, y, c(1024), c(256), 1, 1, 0)
    # head 1 (13x13)
    h1 = _conv_bn_relu(b, p, y, c(256), c(512), 3, 1, 1)
    a1 = 3 * (5 + num_classes)
    w1 = p.conv_w(1, 1, c(512), a1)
    h1 = b.op("conv2d", [h1, w1, p.vec(a1, val=0.0)], strides=(1, 1),
              padding=(0, 0), has_bias=True)
    boxes1 = b.op("yolo_box", [h1, img_size], n_out=2,
                  anchors=list(anchors1 or [81, 82, 135, 169, 344, 319]),
                  class_num=num_classes, conf_thresh=conf_thresh,
                  downsample_ratio=32)
    # head 2 (26x26): upsample + concat with c4
    u = _conv_bn_relu(b, p, y, c(256), c(128), 1, 1, 0)
    u = b.op("resize", [u], scale=2.0, method="nearest")
    cat = b.op("concat", [u, feats["c4"]], axis=3)
    h2 = _conv_bn_relu(b, p, cat, c(128) + c(256), c(256), 3, 1, 1)
    a2 = 3 * (5 + num_classes)
    w2 = p.conv_w(1, 1, c(256), a2)
    h2 = b.op("conv2d", [h2, w2, p.vec(a2, val=0.0)], strides=(1, 1),
              padding=(0, 0), has_bias=True)
    boxes2 = b.op("yolo_box", [h2, img_size], n_out=2,
                  anchors=list(anchors2 or [23, 27, 37, 58, 81, 82]),
                  class_num=num_classes, conf_thresh=conf_thresh,
                  downsample_ratio=16)
    all_boxes = b.op("concat", [boxes1[0], boxes2[0]], axis=1)
    all_scores = b.op("concat", [boxes1[1], boxes2[1]], axis=1)
    b.output(all_boxes, all_scores)
    return b.finish()


def build_faster_rcnn(batch: int = 1, image_size: int = 224,
                      num_classes: int = 21, post_nms_top_n: int = 128,
                      pre_nms_top_n: int = 1024, keep_top_k: int = 100,
                      blocks=(3, 4, 6, 3), base_width: int = 64,
                      roi_resolution: int = 14, seed: int = 0) -> Graph:
    """The REAL two-stage Faster-RCNN topology (reference:
    `test/framework/net/faster_rcnn_test.cpp` running the full
    rcnn_proposal + roi pooling + rcnn_det_output_with_attr graph):

      ResNet-C4 backbone (stem + stages 1-3, /16 feature map)
        -> RPN head (3 sizes x 3 ratios = 9 anchors, objectness +
           box deltas) -> generate_proposals (padded top-k NMS)
        -> roi_align (14x14 on C4)
        -> per-ROI stage-4 ("conv5") bottlenecks -> global avg pool
        -> cls softmax + PER-CLASS bbox regression
        -> rcnn_detection_output (per-class decode + NMS + global top-k)

    Everything staticized for TPU: rois are a fixed [B, post_nms_top_n, 5]
    slab with -1 invalid rows that the second stage masks.  `base_width`
    scales channel widths (64 = real ResNet-50-C4; tests use smaller).
    Outputs: detections [B, keep_top_k, 7] and cls_prob
    [B*post_nms_top_n, num_classes].
    """
    from .resnet import _bottleneck

    b = GraphBuilder("faster_rcnn")
    p = _P(b, seed)
    x = b.input((batch, image_size, image_size, 3), name="input")
    im_info = b.input((batch, 3), name="im_info")  # (h, w, scale)

    # ---- backbone: ResNet stem + stages 1-3 -> /16, 16*base_width ch
    w = base_width
    y = _conv_bn_relu(b, p, x, 3, w, 7, 2, 3)
    y = b.op("pool2d", [y], mode="max", window=(3, 3), strides=(2, 2),
             padding=(0, 0), ceil_mode=True)
    cin = w
    for stage, n_blocks in enumerate(blocks[:3]):
        planes = w * (2 ** stage)
        for i in range(n_blocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            y = _bottleneck(b, p, y, cin, planes, stride, downsample=(i == 0))
            cin = planes * 4
    feat = y                                    # [B, S/16, S/16, 16w]

    # ---- RPN: 3x3 conv + 9-anchor objectness/regression heads
    rpn = _conv_relu(b, p, feat, cin, cin // 2, 3, 1, 1)
    sizes = [image_size // 8, image_size // 4, image_size // 2]
    ratios = [0.5, 1.0, 2.0]
    n_anchor = len(sizes) * len(ratios)
    w_cls = p.conv_w(1, 1, cin // 2, n_anchor)
    scores = b.op("conv2d", [rpn, w_cls, p.vec(n_anchor, val=0.0)],
                  strides=(1, 1), padding=(0, 0), has_bias=True)
    scores = b.op("activation", [scores], activation="sigmoid")
    w_reg = p.conv_w(1, 1, cin // 2, n_anchor * 4)
    deltas = b.op("conv2d", [rpn, w_reg, p.vec(n_anchor * 4, val=0.0)],
                  strides=(1, 1), padding=(0, 0), has_bias=True)
    anchors, variances = b.op(
        "anchor_generator", [feat], n_out=2,
        anchor_sizes=sizes, aspect_ratios=ratios,
        stride=[16.0, 16.0], variances=[1.0, 1.0, 1.0, 1.0])
    rois = b.op("generate_proposals",
                [scores, deltas, im_info, anchors, variances],
                name="proposals",
                pre_nms_top_n=pre_nms_top_n, post_nms_top_n=post_nms_top_n,
                nms_thresh=0.7, min_size=4.0)

    # ---- stage 2: roi_align 14x14 -> per-ROI conv5 -> heads
    rois_flat = b.op("reshape", [rois], shape=[-1, 5])
    pooled = b.op("roi_align", [feat, rois_flat],
                  pooled_hw=(roi_resolution, roi_resolution),
                  spatial_scale=1.0 / 16, sampling_ratio=2)
    planes = w * 8
    h = pooled
    hcin = cin
    for i in range(blocks[3]):
        h = _bottleneck(b, p, h, hcin, planes, 2 if i == 0 else 1,
                        downsample=(i == 0))
        hcin = planes * 4
    h = b.op("pool2d", [h], mode="avg", global_pooling=True)
    h = b.op("flatten", [h], axis=1)            # [B*R, 32w]
    cls_logits = b.op("dense", [h, p.dense_w(hcin, num_classes),
                                p.vec(num_classes, val=0.0)], has_bias=True)
    cls_prob = b.op("softmax", [cls_logits], axis=-1, name="cls_prob")
    bbox_pred = b.op("dense", [h, p.dense_w(hcin, num_classes * 4),
                               p.vec(num_classes * 4, val=0.0)],
                     has_bias=True, name="bbox_pred")
    det = b.op("rcnn_detection_output",
               [rois, cls_prob, bbox_pred, im_info],
               num_classes=num_classes, background_id=0,
               keep_top_k=keep_top_k, nms_thresh=0.3, conf_thresh=0.05,
               bbox_stds=(0.1, 0.1, 0.2, 0.2))
    b.output(det)
    b.output(cls_prob)
    return b.finish()


def build_faster_rcnn_lite(batch: int = 1, image_size: int = 224,
                           num_classes: int = 5, post_nms_top_n: int = 64,
                           seed: int = 0) -> Graph:
    """Faster-RCNN-style two-stage detector (reference: `faster_rcnn_test`,
    `generate_proposals` + roi_align + rcnn head ops): ResNet-ish backbone
    -> RPN (anchors + proposals, staticized NMS) -> ROI align -> per-ROI
    classification + box refinement via box_coder.
    """
    b = GraphBuilder("faster_rcnn_lite")
    p = _P(b, seed)
    x = b.input((batch, image_size, image_size, 3), name="input")
    im_info = b.input((batch, 3), name="im_info")  # (h, w, scale)
    # backbone: /16 feature map
    y = _conv_bn_relu(b, p, x, 3, 32, 3, 2, 1)
    y = _conv_bn_relu(b, p, y, 32, 64, 3, 2, 1)
    y = _conv_bn_relu(b, p, y, 64, 128, 3, 2, 1)
    feat = _conv_bn_relu(b, p, y, 128, 256, 3, 2, 1)
    # RPN head: 3 anchors
    rpn = _conv_relu(b, p, feat, 256, 256, 3, 1, 1)
    n_anchor = 3
    w_cls = p.conv_w(1, 1, 256, n_anchor)
    scores = b.op("conv2d", [rpn, w_cls, p.vec(n_anchor, val=0.0)],
                  strides=(1, 1), padding=(0, 0), has_bias=True)
    scores = b.op("activation", [scores], activation="sigmoid")
    w_reg = p.conv_w(1, 1, 256, n_anchor * 4)
    deltas = b.op("conv2d", [rpn, w_reg, p.vec(n_anchor * 4, val=0.0)],
                  strides=(1, 1), padding=(0, 0), has_bias=True)
    anchors, variances = b.op(
        "anchor_generator", [feat], n_out=2,
        anchor_sizes=[64, 128, 256], aspect_ratios=[1.0],
        stride=[16.0, 16.0], variances=[1.0, 1.0, 1.0, 1.0])
    rois = b.op("generate_proposals",
                [scores, deltas, im_info, anchors, variances],
                pre_nms_top_n=512, post_nms_top_n=post_nms_top_n,
                nms_thresh=0.7, min_size=4.0)
    # rois [B, post_nms_top_n, 5] -> flatten to [B*top_n, 5] for roi_align
    rois_flat = b.op("reshape", [rois], shape=[-1, 5])
    pooled = b.op("roi_align", [feat, rois_flat], pooled_hw=(7, 7),
                  spatial_scale=1.0 / 16, sampling_ratio=2)
    flat = b.op("flatten", [pooled], axis=1)
    fc1 = b.op("dense", [flat, p.dense_w(7 * 7 * 256, 512),
                         p.vec(512, val=0.0)], has_bias=True,
               activation="relu")
    cls_logits = b.op("dense", [fc1, p.dense_w(512, num_classes),
                                p.vec(num_classes, val=0.0)], has_bias=True)
    cls_prob = b.op("softmax", [cls_logits], axis=-1)
    box_deltas = b.op("dense", [fc1, p.dense_w(512, 4),
                                p.vec(4, val=0.0)], has_bias=True)
    det = b.op("rcnn_det_output_with_attr", [rois_flat, cls_prob])
    b.output(det)
    b.output(box_deltas)
    return b.finish()
