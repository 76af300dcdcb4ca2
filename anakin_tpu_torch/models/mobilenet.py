"""MobileNet v1/v2 builders, a copy of `anakin_tpu/models/mobilenet.py`.

Depthwise convs are grouped `conv2d` nodes (groups == channels), 3x3 pad 1,
stride 1 or 2; after `quantize_graph` each becomes a "dw3x3" `conv2d_int8`
that runs on the `depthwise3x3_int8` kernel.  Numpy-only, so the built
graph is the JAX package's node for node and byte for byte.
"""

from __future__ import annotations


from ..graph.ir import Graph, GraphBuilder
from .resnet import _P, _conv_bn_relu

__all__ = ["build_mobilenet_v1", "build_mobilenet_v2"]


def _dw_sep(b, p, x, cin, cout, stride):
    """depthwise 3x3 + BN + relu, then pointwise 1x1 + BN + relu (v1)."""
    w_dw = p.conv_w(3, 3, cin, cin, groups=cin)
    y = b.op("conv2d", [x, w_dw], strides=(stride, stride), padding=(1, 1),
             groups=cin)
    mean, var, gamma, beta = p.bn(cin)
    y = b.op("batch_norm", [y, mean, var])
    y = b.op("scale", [y, gamma, beta])
    y = b.op("activation", [y], activation="relu")
    return _conv_bn_relu(b, p, y, cin, cout, 1, 1, 0)


def build_mobilenet_v1(batch: int = 1, image_size: int = 224,
                       num_classes: int = 1000, seed: int = 0) -> Graph:
    b = GraphBuilder("mobilenet_v1")
    p = _P(b, seed)
    x = b.input((batch, image_size, image_size, 3), name="input")
    y = _conv_bn_relu(b, p, x, 3, 32, 3, 2, 1)
    cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
           (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
          [(512, 1024, 2), (1024, 1024, 1)]
    for cin, cout, s in cfg:
        y = _dw_sep(b, p, y, cin, cout, s)
    y = b.op("pool2d", [y], mode="avg", global_pooling=True)
    y = b.op("flatten", [y], axis=1)
    w = p.dense_w(1024, num_classes)
    bias = p.vec(num_classes, val=0.0)
    y = b.op("dense", [y, w, bias], has_bias=True)
    y = b.op("softmax", [y], axis=-1)
    b.output(y)
    return b.finish()


def _inverted_residual(b, p, x, cin, cout, stride, expand):
    hidden = cin * expand
    y = x
    if expand != 1:
        y = _conv_bn_relu(b, p, y, cin, hidden, 1, 1, 0, relu=False)
        y = b.op("activation", [y], activation="relu6")
    w_dw = p.conv_w(3, 3, hidden, hidden, groups=hidden)
    y2 = b.op("conv2d", [y, w_dw], strides=(stride, stride), padding=(1, 1),
              groups=hidden)
    mean, var, gamma, beta = p.bn(hidden)
    y2 = b.op("batch_norm", [y2, mean, var])
    y2 = b.op("scale", [y2, gamma, beta])
    y2 = b.op("activation", [y2], activation="relu6")
    y3 = _conv_bn_relu(b, p, y2, hidden, cout, 1, 1, 0, relu=False)
    if stride == 1 and cin == cout:
        return b.op("eltwise", [y3, x], mode="sum")
    return y3


def build_mobilenet_v2(batch: int = 1, image_size: int = 224,
                       num_classes: int = 1000, seed: int = 0) -> Graph:
    b = GraphBuilder("mobilenet_v2")
    p = _P(b, seed)
    x = b.input((batch, image_size, image_size, 3), name="input")
    y = _conv_bn_relu(b, p, x, 3, 32, 3, 2, 1, relu=False)
    y = b.op("activation", [y], activation="relu6")
    cin = 32
    cfg = [
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
    ]
    for expand, cout, n, s in cfg:
        for i in range(n):
            y = _inverted_residual(b, p, y, cin, cout, s if i == 0 else 1, expand)
            cin = cout
    y = _conv_bn_relu(b, p, y, cin, 1280, 1, 1, 0, relu=False)
    y = b.op("activation", [y], activation="relu6")
    y = b.op("pool2d", [y], mode="avg", global_pooling=True)
    y = b.op("flatten", [y], axis=1)
    w = p.dense_w(1280, num_classes)
    bias = p.vec(num_classes, val=0.0)
    y = b.op("dense", [y, w, bias], has_bias=True)
    y = b.op("softmax", [y], axis=-1)
    b.output(y)
    return b.finish()
