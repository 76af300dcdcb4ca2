"""VGG16 graph construction, the port of `anakin_tpu/models/vgg.py`
(numpy only: the graph equals the JAX package's node for node and byte for
byte).

Caffe-style: conv+bias / relu / maxpool stacks then three FC layers.  Once
quantized, its 13 3x3 convs run on `conv3x3_int8` and its dense layers on
`matmul_int8`.
"""

from __future__ import annotations


from ..graph.ir import Graph, GraphBuilder
from .resnet import _P

__all__ = ["build_vgg16"]

_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
        512, 512, 512, "M", 512, 512, 512, "M"]


def build_vgg16(batch: int = 1, image_size: int = 224,
                num_classes: int = 1000, seed: int = 0) -> Graph:
    b = GraphBuilder("vgg16")
    p = _P(b, seed)
    x = b.input((batch, image_size, image_size, 3), name="input")
    cin = 3
    y = x
    for v in _CFG:
        if v == "M":
            y = b.op("pool2d", [y], mode="max", window=(2, 2), strides=(2, 2),
                     padding=(0, 0), ceil_mode=True)
        else:
            w = p.conv_w(3, 3, cin, v)
            bias = p.vec(v, val=0.0)
            y = b.op("conv2d", [y, w, bias], strides=(1, 1), padding=(1, 1),
                     has_bias=True)
            y = b.op("activation", [y], activation="relu")
            cin = v
    y = b.op("flatten", [y], axis=1)
    spatial = image_size // 32
    dims = [cin * spatial * spatial, 4096, 4096, num_classes]
    for i in range(3):
        w = p.dense_w(dims[i], dims[i + 1])
        bias = p.vec(dims[i + 1], val=0.0)
        y = b.op("dense", [y, w, bias], has_bias=True)
        if i < 2:
            y = b.op("activation", [y], activation="relu")
            y = b.op("dropout", [y], ratio=0.5, scale=1.0)
    y = b.op("softmax", [y], axis=-1)
    b.output(y)
    return b.finish()
