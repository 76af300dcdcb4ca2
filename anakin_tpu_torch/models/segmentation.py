"""Semantic-segmentation graph construction, the port of
`anakin_tpu/models/segmentation.py` (numpy only: each graph equals the JAX
package's node for node and byte for byte): FCN-8s lite and ICNet lite,
the shapes a converted FCN / ICNet arrives in: encoder convs, score heads,
deconvolution upsampling, eltwise fusion, bilinear `resize` and an `argmax`
label map.

Weights are He-initialized random, from the seed.
"""

from __future__ import annotations

import numpy as np

from ..graph.ir import Graph, GraphBuilder

__all__ = ["build_fcn8s_lite", "build_icnet_lite"]


def _conv_relu(b, rng, x, cin, cout, k=3, stride=1, pad=1):
    fan = k * k * cin
    w = b.param(rng.normal(0, np.sqrt(2.0 / fan),
                           (k, k, cin, cout)).astype(np.float32), "conv_w")
    bias = b.param(rng.normal(0, 0.01, (cout,)).astype(np.float32), "conv_b")
    y = b.op("conv2d", [x, w, bias], strides=(stride, stride),
             padding=(pad, pad), has_bias=True)
    return b.op("activation", [y], activation="relu")


def _score(b, rng, x, cin, n_cls):
    w = b.param(rng.normal(0, 0.01, (1, 1, cin, n_cls)).astype(np.float32),
                "score_w")
    return b.op("conv2d", [x, w], strides=(1, 1), padding=(0, 0))


def _upsample2x(b, rng, x, n_cls):
    """Learnable 2x deconv upsample (caffe FCN style: kernel 4, stride 2,
    pad 1 -> exact 2x)."""
    w = b.param(rng.normal(0, 0.1, (4, 4, n_cls, n_cls)).astype(np.float32),
                "up_w")
    return b.op("deconv2d", [x, w], strides=(2, 2), padding=(1, 1))


def build_fcn8s_lite(batch: int = 1, image_size: int = 64,
                     n_classes: int = 21, seed: int = 0) -> Graph:
    """FCN-8s on a small VGG-ish encoder: pool3/pool4/pool5 score heads
    fused by 2x deconvs + eltwise, final 8x bilinear `interp` to input
    resolution, argmax label map output."""
    assert image_size % 8 == 0
    rng = np.random.default_rng(seed)
    b = GraphBuilder("fcn8s_lite")
    x = b.input((batch, image_size, image_size, 3), name="input")

    y = _conv_relu(b, rng, x, 3, 32)
    y = b.op("pool2d", [y], mode="max", window=(2, 2), strides=(2, 2))
    y = _conv_relu(b, rng, y, 32, 64)
    p3 = b.op("pool2d", [y], mode="max", window=(2, 2), strides=(2, 2))  # /4
    y = _conv_relu(b, rng, p3, 64, 128)
    p4 = b.op("pool2d", [y], mode="max", window=(2, 2), strides=(2, 2))  # /8
    y = _conv_relu(b, rng, p4, 128, 256)
    p5 = b.op("pool2d", [y], mode="max", window=(2, 2), strides=(2, 2))  # /16

    s5 = _score(b, rng, p5, 256, n_classes)          # /16
    s4 = _score(b, rng, p4, 128, n_classes)          # /8
    s3 = _score(b, rng, p3, 64, n_classes)           # /4

    u5 = _upsample2x(b, rng, s5, n_classes)          # /8
    f4 = b.op("eltwise", [u5, s4], mode="sum")
    u4 = _upsample2x(b, rng, f4, n_classes)          # /4
    f3 = b.op("eltwise", [u4, s3], mode="sum")
    logits = b.op("resize", [f3], method="bilinear", align_corners=True,
                  out_hw=(image_size, image_size))   # caffe interp 4x
    labels = b.op("argmax", [logits], axis=3)
    b.output(logits, labels)
    return b.finish()


def build_icnet_lite(batch: int = 1, image_size: int = 64,
                     n_classes: int = 19, seed: int = 0) -> Graph:
    """ICNet-style cascade: three resolution branches (1x, 1/2, 1/4)
    fused coarse-to-fine with bilinear upsampling + eltwise-sum + relu
    (cascade feature fusion), as deployed for real-time street-scene
    segmentation — the workload class of the reference's seg test."""
    assert image_size % 8 == 0
    rng = np.random.default_rng(seed)
    b = GraphBuilder("icnet_lite")
    x = b.input((batch, image_size, image_size, 3), name="input")

    # branch 1: full res, shallow
    b1 = _conv_relu(b, rng, x, 3, 16, stride=2)            # /2
    b1 = _conv_relu(b, rng, b1, 16, 32, stride=2)          # /4

    # branch 2: half res, medium
    x2 = b.op("resize", [x], method="bilinear", align_corners=False,
              scale_h=0.5, scale_w=0.5)
    b2 = _conv_relu(b, rng, x2, 3, 32, stride=2)           # /4
    b2 = _conv_relu(b, rng, b2, 32, 64, stride=2)          # /8

    # branch 3: quarter res, deep
    x4 = b.op("resize", [x2], method="bilinear", align_corners=False,
              scale_h=0.5, scale_w=0.5)
    b3 = _conv_relu(b, rng, x4, 3, 32, stride=2)           # /8
    b3 = _conv_relu(b, rng, b3, 32, 64)
    b3 = _conv_relu(b, rng, b3, 64, 64, stride=2)          # /16
    b3 = _conv_relu(b, rng, b3, 64, 128)

    # cascade fusion 3 -> 2 (at /8): upsample b3, dilated conv, project b2
    u3 = b.op("resize", [b3], method="bilinear", align_corners=False,
              scale_h=2.0, scale_w=2.0)
    w = b.param(rng.normal(0, 0.05, (3, 3, 128, 64)).astype(np.float32),
                "cff_w")
    u3 = b.op("conv2d", [u3, w], strides=(1, 1), padding=(2, 2),
              dilation=(2, 2))
    f2 = b.op("eltwise", [u3, b2], mode="sum")
    f2 = b.op("activation", [f2], activation="relu")

    # cascade fusion 2 -> 1 (at /4)
    u2 = b.op("resize", [f2], method="bilinear", align_corners=False,
              scale_h=2.0, scale_w=2.0)
    w = b.param(rng.normal(0, 0.05, (3, 3, 64, 32)).astype(np.float32),
                "cff2_w")
    u2 = b.op("conv2d", [u2, w], strides=(1, 1), padding=(2, 2),
              dilation=(2, 2))
    f1 = b.op("eltwise", [u2, b1], mode="sum")
    f1 = b.op("activation", [f1], activation="relu")

    logits4 = _score(b, rng, f1, 32, n_classes)            # /4
    logits = b.op("resize", [logits4], method="bilinear",
                  align_corners=False, out_hw=(image_size, image_size))
    labels = b.op("argmax", [logits], axis=3)
    b.output(logits, labels)
    return b.finish()
