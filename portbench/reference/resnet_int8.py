"""The int8 ResNet in plain PyTorch, from its float weights and a table of
activation scales.

The network is the configuration's: a 7x7 stride-2 stem conv, 3x3 stride-2
max pool (ceil mode), bottlenecks of 1x1, 3x3 (carrying the stage's
stride) and 1x1 convs with a projection shortcut on each stage's first
block, global average pool, a fully connected classifier.  Every batch
norm is folded into its conv (eps 1e-5).

Quantization, as the configuration states it: the stem runs in float32
and its output is quantized to int8; every later conv and the classifier
take int8 activations (one scale a tensor, from the table) and int8
weights (one scale an output channel, amax / 127, round half to even,
clipped to +-127), accumulate exactly (float64 products of integers), then
scale, add the bias and the dequantized int8 shortcut, apply the relu and
quantize the output again (divide by its scale, round, clip); the last conv
gives float32, which the pool and the classifier (its input quantized)
take.  `weight_bits=4` is the lower-precision control: the same with int4
weights (amax / 7, clipped to +-7).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from . import no_tf32

__all__ = ["read_scales", "ResNetInt8"]


def read_scales(path: str) -> Dict[str, float]:
    """{edge: scale} of a scale table (one "edge scale" a line)."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out[parts[0]] = float(parts[1])
    return out


def _ordered(table: Dict[str, float], prefix: str) -> List[float]:
    """The scales of the edges `<prefix>_<n>:out`, by n (creation order)."""
    items = [(int(k[len(prefix) + 1:-len(":out")]), v)
             for k, v in table.items()
             if k.startswith(prefix + "_") and k.endswith(":out")
             and k[len(prefix) + 1:-len(":out")].isdigit()]
    return [v for _, v in sorted(items)]


def _quant(y: torch.Tensor, scale: float) -> torch.Tensor:
    return torch.clamp(torch.round(y / scale), -127, 127)


def _blocks(layers, widths, expansion):
    out, cin = [], widths[0]
    for stage, (planes, n) in enumerate(zip(widths, layers)):
        for i in range(n):
            out.append((cin, planes, 2 if (stage > 0 and i == 0) else 1,
                        i == 0))
            cin = planes * expansion
    return out


class _Conv:
    """A folded conv: float weight OIHW and bias, and its quantized weight
    (integer values as float64) with per-channel scales."""

    def __init__(self, w, mean, var, gamma, beta, stride, pad, bits, device):
        w = torch.as_tensor(w, dtype=torch.float64, device=device)
        s = (torch.as_tensor(gamma, dtype=torch.float64, device=device)
             / torch.sqrt(torch.as_tensor(var, dtype=torch.float64,
                                          device=device) + 1e-5))
        b = (torch.as_tensor(beta, dtype=torch.float64, device=device)
             - torch.as_tensor(mean, dtype=torch.float64, device=device) * s)
        wf = (w * s).to(torch.float32)                       # HWIO
        self.w = wf.permute(3, 2, 0, 1).contiguous()         # OIHW
        self.b = b.to(torch.float32)
        self.k, self.stride, self.pad = int(w.shape[0]), stride, pad
        qmax = 127.0 if bits == 8 else 7.0
        amax = self.w.abs().amax(dim=(1, 2, 3))
        self.ws = torch.where(amax == 0, torch.ones_like(amax), amax) / qmax
        self.wq = torch.clamp(torch.round(self.w / self.ws[:, None, None, None]),
                              -qmax, qmax).to(torch.float64)

    def int_acc(self, xq: torch.Tensor) -> torch.Tensor:
        """The exact integer accumulation of int8 x (NCHW, integer values)
        with the int8 weight: an im2col product in float64."""
        n, c, h, w = xq.shape
        k, s, p = self.k, self.stride, self.pad
        oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
        cols = F.unfold(xq.to(torch.float64), k, padding=p, stride=s)
        acc = torch.matmul(self.wq.reshape(self.wq.shape[0], -1), cols)
        return acc.reshape(n, -1, oh, ow)

    def epilogue(self, acc, in_scale, residual=None, relu=True):
        y = (acc.to(torch.float32) * (self.ws * in_scale)[None, :, None, None]
             + self.b[None, :, None, None])
        if residual is not None:
            y = y + residual
        return torch.clamp_min(y, 0.0) if relu else y


class ResNetInt8:
    """`ResNetInt8(cfg, weights, table)(x_nhwc) -> logits [N, classes]`.

    `weights`: `inputs.resnet_weights(cfg)`'s list; `table`: {edge: scale},
    whose conv outputs, in creation order, are the stem's, then each
    block's three convs and its shortcut; `flatten_*` scales the
    classifier's input."""

    def __init__(self, cfg: dict, weights: Sequence, table: Dict[str, float],
                 device, weight_bits: int = 8):
        it = iter(weights)

        def conv(stride, pad):
            return _Conv(*(next(it) for _ in range(5)), stride, pad,
                         weight_bits, device)

        k = int(cfg["stem_kernel"])
        self.stem = conv(2, k // 2)
        self.blocks = []
        for _, _, stride, down in _blocks(cfg["layers"], cfg["widths"],
                                          int(cfg["expansion"])):
            a, b, c = conv(1, 0), conv(stride, 1), conv(1, 0)
            self.blocks.append((a, b, c, conv(stride, 0) if down else None))
        fw = torch.as_tensor(next(it), dtype=torch.float32, device=device)
        self.fc_b = torch.as_tensor(next(it), dtype=torch.float32,
                                    device=device)
        qmax = 127.0 if weight_bits == 8 else 7.0
        amax = fw.abs().amax(dim=0)
        self.fc_ws = torch.where(amax == 0, torch.ones_like(amax), amax) / qmax
        self.fc_wq = torch.clamp(torch.round(fw / self.fc_ws), -qmax,
                                 qmax).to(torch.float64)
        self.conv_scales = _ordered(table, "conv2d")
        self.fc_in_scale = _ordered(table, "flatten")[0]
        n_convs = 1 + sum(3 + (d is not None) for *_, d in self.blocks)
        if len(self.conv_scales) != n_convs:
            raise ValueError(f"the table scales {len(self.conv_scales)} convs, "
                             f"the network has {n_convs}")

    @torch.no_grad()
    def __call__(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            return self._forward(x_nhwc)

    def _forward(self, x_nhwc):
        sc = iter(self.conv_scales)
        x = x_nhwc.to(torch.float32).permute(0, 3, 1, 2)
        st = self.stem
        y = F.conv2d(x, st.w, st.b, stride=2, padding=st.k // 2)
        s_in = next(sc)
        q = _quant(torch.clamp_min(y, 0.0), s_in)
        q = F.max_pool2d(q, 3, 2, 0, ceil_mode=True)
        last = len(self.blocks) - 1
        feat = None
        for i, (a, b, c, d) in enumerate(self.blocks):
            sa, sb, scc = next(sc), next(sc), next(sc)
            qa = _quant(a.epilogue(a.int_acc(q), s_in), sa)
            qb = _quant(b.epilogue(b.int_acc(qa), sa), sb)
            if d is not None:
                sd = next(sc)
                res = _quant(d.epilogue(d.int_acc(q), s_in, relu=False), sd) * sd
            else:
                res = q * s_in
            yc = c.epilogue(c.int_acc(qb), sb, residual=res)
            if i == last:
                feat = yc
            else:
                q, s_in = _quant(yc, scc), scc
        pooled = feat.mean(dim=(2, 3))
        xq = _quant(pooled, self.fc_in_scale).to(torch.float64)
        acc = torch.matmul(xq, self.fc_wq).to(torch.float32)
        return acc * (self.fc_ws * self.fc_in_scale) + self.fc_b
