"""GoogLeNet (Inception v1) and ShuffleNet v1 graph construction, the port
of `anakin_tpu/models/googlenet.py` (numpy only: the graphs equal the JAX
package's node for node and byte for byte).

GoogLeNet exercises multi-branch concat graphs (1x1, 3x3, 5x5 and pooled
branches, LRN); ShuffleNet exercises grouped 1x1 convs, the depthwise 3x3
and the `shuffle_channel` op.
"""

from __future__ import annotations


from ..graph.ir import Graph, GraphBuilder
from .resnet import _P, _conv_bn_relu

__all__ = ["build_googlenet", "build_shufflenet_v1"]


def _conv_relu(b, p, x, cin, cout, k, stride, pad):
    w = p.conv_w(k, k, cin, cout)
    bias = p.vec(cout, val=0.0)
    y = b.op("conv2d", [x, w, bias], strides=(stride, stride),
             padding=(pad, pad), has_bias=True)
    return b.op("activation", [y], activation="relu")


def _inception(b, p, x, cin, c1, c3r, c3, c5r, c5, cp):
    br1 = _conv_relu(b, p, x, cin, c1, 1, 1, 0)
    br2 = _conv_relu(b, p, x, cin, c3r, 1, 1, 0)
    br2 = _conv_relu(b, p, br2, c3r, c3, 3, 1, 1)
    br3 = _conv_relu(b, p, x, cin, c5r, 1, 1, 0)
    br3 = _conv_relu(b, p, br3, c5r, c5, 5, 1, 2)
    br4 = b.op("pool2d", [x], mode="max", window=(3, 3), strides=(1, 1),
               padding=(1, 1), ceil_mode=True)
    br4 = _conv_relu(b, p, br4, cin, cp, 1, 1, 0)
    return b.op("concat", [br1, br2, br3, br4], axis=3), c1 + c3 + c5 + cp


def build_googlenet(batch: int = 1, image_size: int = 224,
                    num_classes: int = 1000, seed: int = 0) -> Graph:
    b = GraphBuilder("googlenet")
    p = _P(b, seed)
    x = b.input((batch, image_size, image_size, 3), name="input")
    y = _conv_relu(b, p, x, 3, 64, 7, 2, 3)
    y = b.op("pool2d", [y], mode="max", window=(3, 3), strides=(2, 2),
             padding=(0, 0), ceil_mode=True)
    y = b.op("lrn", [y], local_size=5, alpha=1e-4, beta=0.75)
    y = _conv_relu(b, p, y, 64, 64, 1, 1, 0)
    y = _conv_relu(b, p, y, 64, 192, 3, 1, 1)
    y = b.op("lrn", [y], local_size=5, alpha=1e-4, beta=0.75)
    y = b.op("pool2d", [y], mode="max", window=(3, 3), strides=(2, 2),
             padding=(0, 0), ceil_mode=True)
    y, c = _inception(b, p, y, 192, 64, 96, 128, 16, 32, 32)      # 3a
    y, c = _inception(b, p, y, c, 128, 128, 192, 32, 96, 64)      # 3b
    y = b.op("pool2d", [y], mode="max", window=(3, 3), strides=(2, 2),
             padding=(0, 0), ceil_mode=True)
    y, c = _inception(b, p, y, c, 192, 96, 208, 16, 48, 64)       # 4a
    y, c = _inception(b, p, y, c, 160, 112, 224, 24, 64, 64)      # 4b
    y, c = _inception(b, p, y, c, 128, 128, 256, 24, 64, 64)      # 4c
    y, c = _inception(b, p, y, c, 112, 144, 288, 32, 64, 64)      # 4d
    y, c = _inception(b, p, y, c, 256, 160, 320, 32, 128, 128)    # 4e
    y = b.op("pool2d", [y], mode="max", window=(3, 3), strides=(2, 2),
             padding=(0, 0), ceil_mode=True)
    y, c = _inception(b, p, y, c, 256, 160, 320, 32, 128, 128)    # 5a
    y, c = _inception(b, p, y, c, 384, 192, 384, 48, 128, 128)    # 5b
    y = b.op("pool2d", [y], mode="avg", global_pooling=True)
    y = b.op("dropout", [y], ratio=0.4, scale=1.0)
    y = b.op("flatten", [y], axis=1)
    w = p.dense_w(c, num_classes)
    bias = p.vec(num_classes, val=0.0)
    y = b.op("dense", [y, w, bias], has_bias=True)
    y = b.op("softmax", [y], axis=-1)
    b.output(y)
    return b.finish()


def _shuffle_unit(b, p, x, cin, cout, groups, stride, first_group):
    """ShuffleNet v1 unit: 1x1 gconv -> shuffle -> 3x3 dw -> 1x1 gconv,
    residual (add for s1, avgpool+concat for s2)."""
    mid = cout // 4
    g1 = 1 if first_group else groups
    w1 = p.conv_w(1, 1, cin, mid, groups=g1)
    y = b.op("conv2d", [x, w1], strides=(1, 1), padding=(0, 0), groups=g1)
    mean, var, gamma, beta = p.bn(mid)
    y = b.op("batch_norm", [y, mean, var])
    y = b.op("scale", [y, gamma, beta])
    y = b.op("activation", [y], activation="relu")
    y = b.op("shuffle_channel", [y], group=groups)
    w_dw = p.conv_w(3, 3, mid, mid, groups=mid)
    y = b.op("conv2d", [y, w_dw], strides=(stride, stride), padding=(1, 1),
             groups=mid)
    mean, var, gamma, beta = p.bn(mid)
    y = b.op("batch_norm", [y, mean, var])
    y = b.op("scale", [y, gamma, beta])
    out_c = cout - cin if stride == 2 else cout
    w2 = p.conv_w(1, 1, mid, out_c, groups=groups)
    y = b.op("conv2d", [y, w2], strides=(1, 1), padding=(0, 0), groups=groups)
    mean, var, gamma, beta = p.bn(out_c)
    y = b.op("batch_norm", [y, mean, var])
    y = b.op("scale", [y, gamma, beta])
    if stride == 2:
        sc = b.op("pool2d", [x], mode="avg", window=(3, 3), strides=(2, 2),
                  padding=(1, 1), ceil_mode=False)
        y = b.op("concat", [sc, y], axis=3)
    else:
        y = b.op("eltwise", [y, x], mode="sum")
    return b.op("activation", [y], activation="relu")


def build_shufflenet_v1(batch: int = 1, image_size: int = 224,
                        num_classes: int = 1000, groups: int = 3,
                        seed: int = 0) -> Graph:
    b = GraphBuilder("shufflenet_v1")
    p = _P(b, seed)
    stage_out = {3: (240, 480, 960)}[groups]
    x = b.input((batch, image_size, image_size, 3), name="input")
    y = _conv_bn_relu(b, p, x, 3, 24, 3, 2, 1)
    y = b.op("pool2d", [y], mode="max", window=(3, 3), strides=(2, 2),
             padding=(1, 1), ceil_mode=False)
    cin = 24
    for stage, (cout, n_rep) in enumerate(zip(stage_out, (3, 7, 3))):
        y = _shuffle_unit(b, p, y, cin, cout, groups, 2, first_group=(stage == 0))
        cin = cout
        for _ in range(n_rep):
            y = _shuffle_unit(b, p, y, cin, cout, groups, 1, first_group=False)
    y = b.op("pool2d", [y], mode="avg", global_pooling=True)
    y = b.op("flatten", [y], axis=1)
    w = p.dense_w(cin, num_classes)
    bias = p.vec(num_classes, val=0.0)
    y = b.op("dense", [y, w, bias], has_bias=True)
    y = b.op("softmax", [y], axis=-1)
    b.output(y)
    return b.finish()
