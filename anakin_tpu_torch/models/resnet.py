"""ResNet-50/101 graph construction.

Build the *unoptimized* caffe-style graph — conv / batch_norm / scale /
relu / eltwise as separate nodes — exactly the shape a converted model
arrives in (reference converter output for ResNet, and the fusion test
target of `framework/graph/llvm/fusion`): the rewriter must then fold BN +
scale and fuse relu/residual, which is what we golden-test.

Weights are He-initialized random (no pretrained zoo offline); numerics
tests compare executor variants, not ImageNet accuracy.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..graph.ir import Graph, GraphBuilder, Node

__all__ = ["build_resnet50", "build_resnet101", "build_resnet",
           "identity_bottlenecks"]


class _P:
    """Param factory with a seeded RNG."""

    def __init__(self, b: GraphBuilder, seed: int):
        self.b = b
        self.rng = np.random.default_rng(seed)

    def conv_w(self, kh, kw, cin, cout, groups=1):
        fan_in = kh * kw * cin // groups
        w = self.rng.normal(0.0, np.sqrt(2.0 / fan_in), (kh, kw, cin // groups, cout))
        return self.b.param(w.astype(np.float32), "conv_w")

    def vec(self, n, val=None, scale=1.0):
        if val is not None:
            v = np.full((n,), val, np.float32)
        else:
            v = self.rng.normal(0.0, scale, (n,)).astype(np.float32)
        return self.b.param(v, "vec")

    def bn(self, n):
        mean = self.rng.normal(0.0, 0.1, (n,)).astype(np.float32)
        var = self.rng.uniform(0.5, 1.5, (n,)).astype(np.float32)
        gamma = self.rng.uniform(0.5, 1.5, (n,)).astype(np.float32)
        beta = self.rng.normal(0.0, 0.1, (n,)).astype(np.float32)
        return (self.b.param(mean, "bn_mean"), self.b.param(var, "bn_var"),
                self.b.param(gamma, "bn_gamma"), self.b.param(beta, "bn_beta"))

    def dense_w(self, cin, cout):
        w = self.rng.normal(0.0, np.sqrt(1.0 / cin), (cin, cout)).astype(np.float32)
        return self.b.param(w, "fc_w")


def _conv_bn_relu(b: GraphBuilder, p: _P, x: str, cin: int, cout: int,
                  k: int, stride: int, pad: int, relu: bool = True) -> str:
    w = p.conv_w(k, k, cin, cout)
    y = b.op("conv2d", [x, w], strides=(stride, stride), padding=(pad, pad))
    mean, var, gamma, beta = p.bn(cout)
    y = b.op("batch_norm", [y, mean, var])
    y = b.op("scale", [y, gamma, beta])
    if relu:
        y = b.op("activation", [y], activation="relu")
    return y


def _bottleneck(b: GraphBuilder, p: _P, x: str, cin: int, planes: int,
                stride: int, downsample: bool) -> str:
    cout = planes * 4
    y = _conv_bn_relu(b, p, x, cin, planes, 1, 1, 0)
    y = _conv_bn_relu(b, p, y, planes, planes, 3, stride, 1)
    y = _conv_bn_relu(b, p, y, planes, cout, 1, 1, 0, relu=False)
    if downsample:
        sc = _conv_bn_relu(b, p, x, cin, cout, 1, stride, 0, relu=False)
    else:
        sc = x
    y = b.op("eltwise", [y, sc], mode="sum")
    return b.op("activation", [y], activation="relu")


def build_resnet(layers, batch: int = 1, image_size: int = 224,
                 num_classes: int = 1000, seed: int = 0,
                 name: str = "resnet") -> Graph:
    b = GraphBuilder(name)
    p = _P(b, seed)
    x = b.input((batch, image_size, image_size, 3), name="input")
    y = _conv_bn_relu(b, p, x, 3, 64, 7, 2, 3)
    y = b.op("pool2d", [y], mode="max", window=(3, 3), strides=(2, 2),
             padding=(0, 0), ceil_mode=True)
    cin = 64
    for stage, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512), layers)):
        for i in range(n_blocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            y = _bottleneck(b, p, y, cin, planes, stride, downsample=(i == 0))
            cin = planes * 4
    y = b.op("pool2d", [y], mode="avg", global_pooling=True)
    y = b.op("flatten", [y], axis=1)
    w = p.dense_w(cin, num_classes)
    bias = p.vec(num_classes, val=0.0)
    y = b.op("dense", [y, w, bias], has_bias=True)
    y = b.op("softmax", [y], axis=-1)
    b.output(y)
    return b.finish()


def build_resnet50(batch: int = 1, image_size: int = 224, **kw) -> Graph:
    return build_resnet((3, 4, 6, 3), batch, image_size, name="resnet50", **kw)


def build_resnet101(batch: int = 1, image_size: int = 224, **kw) -> Graph:
    return build_resnet((3, 4, 23, 3), batch, image_size, name="resnet101", **kw)


def identity_bottlenecks(graph: Graph) -> List[Tuple[Node, Node, Node]]:
    """The identity-shortcut bottleneck blocks of a quantized graph, as
    (A, B, C) node triples in graph order: A a 1x1 s1 int8 conv with relu
    and an int8 output whose only consumer is B; B a 3x3 s1 p1 int8 conv
    with relu and an int8 output whose only consumer is C; C a 1x1 s1 int8
    conv with relu whose residual is A's input at A's input scale.  These
    are the blocks `kernels.bottleneck_int8` computes in one launch (2, 3,
    5 and 2 over ResNet-50's four stages).  Nothing routes to it: the
    executor runs the three nodes."""
    producers, consumers = graph.producers(), graph.consumers()

    def conv(node, k, pad, residual):
        w = graph.params.get(node.inputs[1]) if len(node.inputs) > 1 else None
        p = node.attr("padding", (0, 0))
        return (node.op == "conv2d_int8" and w is not None and w.ndim == 4
                and w.shape[:2] == (k, k) and not isinstance(p, str)
                and tuple(p) == (pad, pad)
                and tuple(node.attr("strides", (1, 1))) == (1, 1)
                and tuple(node.attr("dilation", (1, 1))) == (1, 1)
                and int(node.attr("groups", 1)) == 1
                and node.attr("activation") == "relu"
                and bool(node.attr("has_residual")) == residual)

    def only_into(node, nxt):
        return ([n.name for n in consumers.get(node.outputs[0], [])]
                == [nxt.name] and node.attr("out_scale") is not None
                and node.attr("out_scale") == nxt.attr("in_scale"))

    blocks = []
    for c in graph.nodes.values():
        if not conv(c, 1, 0, True):
            continue
        b = producers.get(c.inputs[0])
        if b is None or not conv(b, 3, 1, False) or not only_into(b, c):
            continue
        a = producers.get(b.inputs[0])
        if a is None or not conv(a, 1, 0, False) or not only_into(a, b):
            continue
        if (c.inputs[-1] == a.inputs[0]
                and c.attr("residual_scale") is not None
                and c.attr("residual_scale") == a.attr("in_scale")):
            blocks.append((a, b, c))
    return blocks
