"""Stem space-to-depth rewrite.

The first conv of an ImageNet CNN (a k x k stride-2 conv over 3 RGB
channels) is a poor fit for wide matrix units: C = 3 fills a fraction of
each operand tile, and the stride-2 window halves tap reuse.  The JAX
package rewrites it for its hardware; the port keeps the rewrite so that
both packages build the same graph.

Rewrite (bit-exact, verified in tests): pad the 7x7 kernel to 8x8 with a
zero row/column at the top-left, view the input as 2x2 space-to-depth
blocks (C: 3 -> 12), and convolve 4x4 stride-1 with asymmetric padding
(2, 1).  The conv node is additionally pinned to fp precision
(`graph.precisions`) so the quantizer leaves it out of the int8 region.

General form: any k-odd, stride-2, pad-(k//2) conv with cin <= 4.
"""

from __future__ import annotations

import numpy as np

from ..ir import Graph

__all__ = ["stem_space_to_depth"]


def _regroup_weight(w: np.ndarray) -> np.ndarray:
    """HWIO (k,k,c,o), k odd -> ((k+1)/2, (k+1)/2, 4c, o) for block-2 s2d."""
    k, _, c, o = w.shape
    kp = k + 1
    w_pad = np.zeros((kp, kp, c, o), w.dtype)
    w_pad[1:, 1:] = w
    nk = kp // 2
    return np.ascontiguousarray(
        w_pad.reshape(nk, 2, nk, 2, c, o).transpose(0, 2, 1, 3, 4, 5)
        .reshape(nk, nk, 4 * c, o))


def stem_space_to_depth(graph: Graph) -> Graph:
    g = graph.clone()
    producers = g.producers()
    for node in list(g.nodes.values()):
        if node.op not in ("conv2d", "convolution"):
            continue
        x = node.inputs[0]
        if x not in g.inputs:  # only the stem (reads a graph input)
            continue
        w = g.params.get(node.inputs[1])
        if w is None or w.ndim != 4:
            continue
        k = w.shape[0]
        cin = w.shape[2]
        strides = tuple(node.attr("strides", (1, 1)))
        pad = node.attr("padding", (0, 0))
        pad = (pad, pad) if isinstance(pad, int) else tuple(pad)
        if (k % 2 == 0 or w.shape[1] != k or cin > 4 or strides != (2, 2)
                or pad != (k // 2, k // 2)
                or int(node.attr("groups", 1)) != 1
                or tuple(node.attr("dilation", (1, 1))) != (1, 1)):
            continue
        in_shape = g.input_specs[x][0]
        if len(in_shape) != 4 or in_shape[1] % 2 or in_shape[2] % 2:
            continue
        # rewrite: x -> space_to_depth -> conv(k'=(k+1)/2, s1, asym pad)
        s2d_edge = f"{node.name}:s2d"
        g.add_node(f"{node.name}_s2d", "space_to_depth", [x], [s2d_edge],
                   block=2)
        g.params[node.inputs[1]] = _regroup_weight(w)
        node.inputs[0] = s2d_edge
        nk = (k + 1) // 2
        plo = (k // 2 + 1) // 2
        phi = nk - 1 - plo
        node.attrs["strides"] = (1, 1)
        node.attrs["padding"] = ((plo, phi), (plo, phi))
        # keep the stem out of int8, as the JAX package does
        g.precisions.setdefault(node.name, "fp32")
        g.applied_passes.append("stem_space_to_depth")
        break  # one stem per graph
    return g
