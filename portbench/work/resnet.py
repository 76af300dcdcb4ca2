"""Operations of the bottleneck ResNet's forward (`configs/resnet*.json`)."""

from __future__ import annotations

from ..inputs import resnet_blocks
from ..roofline.peaks import PEAK_OPS


def conv_shapes(cfg: dict, size: int):
    """(k, cin, cout, stride, out_hw) of every conv, stem first."""
    out = []
    h = (size + 2 * (cfg["stem_kernel"] // 2) - cfg["stem_kernel"]) // 2 + 1
    out.append((cfg["stem_kernel"], 3, cfg["widths"][0], 2, h))
    h = -(-(h - 3) // 2) + 1                        # max pool, ceil mode
    for cin, planes, stride, down in resnet_blocks(
            cfg["layers"], cfg["widths"], cfg["expansion"]):
        ho = (h - 1) // stride + 1
        out += [(1, cin, planes, 1, h), (3, planes, planes, stride, ho),
                (1, planes, planes * cfg["expansion"], 1, ho)]
        if down:
            out.append((1, cin, planes * cfg["expansion"], stride, ho))
        h = ho
    return out


def peak_seconds_per_image(cfg: dict, size: int) -> float:
    """Σ over the nodes of an image's operations ÷ the peak of the node's
    type: the float32 stem on the CUDA cores, every other conv and the
    classifier on the int8 tensor cores (pools, casts: no operations
    counted)."""
    t = 0.0
    for i, (k, cin, cout, _, oh) in enumerate(conv_shapes(cfg, size)):
        ops = 2 * k * k * cin * cout * oh * oh
        t += ops / PEAK_OPS["fp32" if i == 0 else "int8"]
    c = cfg["widths"][-1] * cfg["expansion"]
    return t + 2 * c * cfg["num_classes"] / PEAK_OPS["int8"]
