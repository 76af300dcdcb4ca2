"""Graph quantization pass: fp32 graph + scale table -> mixed int8 graph.

Parity with the reference's INT8 deployment flow
(`docs/Manual/int8_design_ch.md`; runtime plumbing `net.cpp:49-122`
`load_calibrator_config` + `calibrator_op` precision-aware factory):

  * weights quantized per-output-channel: w_scale[oc] = amax(w[..., oc])/127
    (`saber/funcs/type_trans.h:33-81` `get_tensor_scale` per-channel path)
  * conv/dense nodes become conv2d_int8/dense_int8 with in_scale from the
    calibration table and the dequant fused in the epilogue
  * int8 "regions": an edge stays int8 end-to-end when its producer can
    emit int8 and every consumer can take it natively (the reference's
    NCHW_C4 int8 regions deduced by `AutoLayoutConfigHelper`); max pooling
    and concat are int8-transparent; everything else forces fp32 at the
    boundary (requant/dequant fused into the producing epilogue)
  * per-node precision overrides in `graph.precisions` ("fp32" keeps a node
    out of int8 — the reference's per-node precision config)
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Set

import numpy as np

from ..graph.ir import Graph, Node, topological_order

__all__ = ["quantize_graph", "weight_only_quantize",
           "per_channel_weight_scale"]

# node ops that can COMPUTE in int8 (consume an int8 x-input natively)
_INT8_COMPUTE = {"conv2d", "dense"}
# node ops that pass int8 values through unchanged (same scale in == out)
_INT8_TRANSPARENT_MAX_POOL = "pool2d"


def per_channel_weight_scale(w: np.ndarray, axis: int) -> np.ndarray:
    """amax over all axes but `axis`, /127 (reference
    `get_tensor_scale` per-channel, `type_trans.h:77`)."""
    red = tuple(i for i in range(w.ndim) if i != axis)
    amax = np.max(np.abs(w), axis=red)
    amax = np.where(amax == 0, 1.0, amax)
    return (amax / 127.0).astype(np.float32)


def _quantize_weight(w: np.ndarray, scale: np.ndarray, axis: int) -> np.ndarray:
    shape = [1] * w.ndim
    shape[axis] = -1
    q = np.round(w / scale.reshape(shape))
    return np.clip(q, -127, 127).astype(np.int8)


def _is_transparent(node: Node) -> bool:
    return node.op == _INT8_TRANSPARENT_MAX_POOL and node.attr("mode", "max") == "max"


def quantize_graph(
    graph: Graph,
    scales: Optional[Dict[str, float]] = None,
    min_channels: int = 1,
    skip_depthwise: bool = False,
) -> Graph:
    """Return a mixed-precision graph with int8 conv/dense where profitable.

    `scales`: {edge: activation scale}; defaults to `graph.scales` (filled
    by `calibrate`).  Nodes whose input edge has no scale, or whose
    precision override says "fp32", stay float.

    `skip_depthwise` keeps depthwise convs float.  The JAX package added it
    for its own hardware, where a depthwise conv's 9-deep groups gain
    nothing from int8 matrix units; on the port, int8 depthwise convs run
    on `depthwise3x3_int8` and no measurement on the H100 has compared the
    two yet (ROADMAP).
    """
    g = graph.clone()
    scales = dict(scales if scales is not None else g.scales)
    if not scales:
        raise ValueError("no activation scales: run calibration first")

    # --- step 1: which nodes can compute in int8
    int8_nodes: Set[str] = set()
    for node in g.nodes.values():
        if node.op not in _INT8_COMPUTE:
            continue
        if g.precisions.get(node.name) == "fp32":
            continue
        if node.inputs[0] not in scales:
            continue
        w = g.params.get(node.inputs[1])
        if w is None:
            continue
        out_ch = w.shape[3] if node.op == "conv2d" else w.shape[1]
        if out_ch < min_channels:
            continue
        if node.op == "conv2d" and skip_depthwise:
            groups = int(node.attr("groups", 1))
            cin = w.shape[2] * groups
            if groups > 1 and groups == cin:
                continue  # depthwise: one input channel per group
        int8_nodes.add(node.name)

    # --- step 2: decide int8 edges (producer emits, ALL consumers take)
    consumers = g.consumers()
    producers = g.producers()

    def consumer_takes_int8(node: Node, edge: str) -> bool:
        if node.name in int8_nodes and node.inputs[0] == edge:
            return True
        if node.name in int8_nodes and node.attr("has_residual") and \
                node.inputs[-1] == edge:
            return True
        if _is_transparent(node) and node.inputs[0] == edge:
            # transparent only helps if ITS consumers take int8 too
            return all(
                consumer_takes_int8(c, node.outputs[0])
                for c in consumers.get(node.outputs[0], [])
            ) and node.outputs[0] not in g.outputs
        return False

    int8_edges: Set[str] = set()
    # effective scale per int8 edge (transparent ops propagate their input's)
    eff_scale: Dict[str, float] = dict(scales)
    for node in topological_order(g):
        for e in node.outputs:
            if e in g.outputs:
                continue
            produces_int8 = node.name in int8_nodes or (
                _is_transparent(node) and node.inputs[0] in int8_edges
            )
            # FLOAT conv/dense kept out of int8 (precision pin, missing
            # input scale, depthwise policy) whose consumers ALL take int8
            # anyway: fuse the requant into ITS epilogue so the boundary
            # tensor is written ONCE as int8 instead of fp32 + quantize-on
            # -read (the pinned stem's output is the largest such tensor).
            # Exact: max-pool commutes with the monotone round/clip, so
            # stage-1 inputs are bit-identical.
            float_epilogue = (not produces_int8
                              and node.op in _INT8_COMPUTE
                              and node.name not in int8_nodes)
            if e not in scales:
                continue
            cs = consumers.get(e, [])
            if not cs or not all(consumer_takes_int8(c, e) for c in cs):
                continue
            if produces_int8:
                int8_edges.add(e)
                if _is_transparent(node):
                    eff_scale[e] = eff_scale[node.inputs[0]]
            elif float_epilogue:
                node.attrs["quant_out_scale"] = float(scales[e])
                int8_edges.add(e)

    # --- step 3: rewrite nodes
    for name in int8_nodes:
        node = g.nodes[name]
        w_edge = node.inputs[1]
        w = g.params[w_edge]
        axis = 3 if node.op == "conv2d" else 1
        w_scale = per_channel_weight_scale(w, axis)
        w_q = _quantize_weight(w, w_scale, axis)
        g.params[w_edge + "__int8"] = w_q
        g.params[w_edge + "__wscale"] = w_scale
        new_inputs = [node.inputs[0], w_edge + "__int8", w_edge + "__wscale"]
        k = 2
        if node.attr("has_bias"):
            new_inputs.append(node.inputs[k])
            k += 1
        if node.attr("has_residual"):
            res_edge = node.inputs[k]
            new_inputs.append(res_edge)
            if res_edge in int8_edges:
                node.attrs["residual_scale"] = eff_scale[res_edge]
        node.inputs = new_inputs
        node.attrs["in_scale"] = eff_scale[node.inputs[0]]
        out_e = node.outputs[0]
        node.attrs["out_scale"] = eff_scale[out_e] if out_e in int8_edges else None
        node.op = "conv2d_int8" if node.op == "conv2d" else "dense_int8"

    # transparent max pools on int8 edges become pool2d_int8 (no-op rename,
    # documents the int8 region; numerics identical)
    for node in g.nodes.values():
        if _is_transparent(node) and node.inputs[0] in int8_edges:
            node.op = "pool2d_int8"

    # prune original fp32 weights no longer referenced
    used = set()
    for node in g.nodes.values():
        used.update(node.inputs)
    for p in list(g.params):
        if p not in used:
            del g.params[p]

    g.scales.update(eff_scale)
    g.applied_passes.append("quantize_graph")
    g.validate()
    return g


def _w4_group_quantize(w: np.ndarray, group: int):
    """Symmetric int4 with one scale per `group` input rows per output
    column (scale = amax / 7, at least 1e-12), two nibbles per int8 byte in
    per-group split-half layout: within each group of G rows, packed row r
    holds row r (low nibble) and row r + G/2 (high nibble), so any block of
    whole groups unpacks on its own.

    Returns (packed int8 [K/2, N], scales float32 [K/G, N], G); G falls
    back to K when `group` does not divide K or is odd."""
    K, N = w.shape
    if K % 2:
        raise ValueError(f"w4 packing needs an even reduction dim, got {K}")
    G = group if group and K % group == 0 and group % 2 == 0 else K
    wg = w.reshape(K // G, G, N).astype(np.float32)
    scale = np.maximum(np.abs(wg).max(axis=1) / 7.0, 1e-12).astype(np.float32)
    q = np.clip(np.round(wg / scale[:, None, :]), -8, 7).astype(np.int8)
    lo, hi = q[:, :G // 2], q[:, G // 2:]            # [K/G, G/2, N] each
    packed = ((lo & 0xF) | (hi << 4)).reshape(K // 2, N).astype(np.int8)
    return packed, scale, G


def weight_only_quantize(graph: Graph, min_elems: int = 1 << 14,
                         bits: int = 8, group: int = 128,
                         packed: Optional[Dict] = None) -> Graph:
    """Calibration-free weight-only quantization for decode graphs, whose
    steps are bound by weight bytes; activations stay float.

    bits=8: dense -> dense_w8, conv2d -> conv2d_w8, per-output-channel
    scales applied after the product.
    bits=4: dense -> dense_w4 with group-wise scales (`group` input rows
    per scale), nibble-packed by `_w4_group_quantize`; convs keep 8 bits.
    A dense whose reduction dim is odd or not a multiple of the group
    (clamped to K) falls back to w8 for that layer, with a warning.

    Only weights of at least `min_elems` elements are rewritten, and nodes
    pinned to "fp32" in `graph.precisions` stay float.  Use it instead of
    `quantize_graph`, not with it.

    `packed`, a dict the caller keeps across calls, carries the quantized
    weights from one call to the next: a graph that holds the very same
    weight array under the same edge gets the arrays of the earlier call
    instead of quantizing it again (the graphs of one model share their
    weights, and a 1B-class model takes seconds to quantize on the host).
    """
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")

    def quantized(w_edge, w, kind, fn):
        if packed is None:
            return fn()
        hit = packed.get((w_edge, kind))
        if hit is None or hit[0] is not w:
            hit = packed[(w_edge, kind)] = (w, fn())
        return hit[1]

    g = graph.clone()
    for node in g.nodes.values():
        if node.op not in ("dense", "conv2d"):
            continue
        if g.precisions.get(node.name) == "fp32":
            continue
        w = g.params.get(node.inputs[1])
        if w is None or w.size < min_elems:
            continue
        w_edge = node.inputs[1]
        rest = node.inputs[2:]
        if bits == 4 and node.op == "dense":
            K = int(w.shape[0])
            eff_group = min(group, K) if group else group
            if K % 2 or (eff_group and K % eff_group):
                logging.getLogger("anakin_tpu_torch").warning(
                    "w4: dense %s reduction dim %d not divisible by "
                    "group=%d — falling back to w8 for this layer",
                    node.name, K, group)
            else:
                q, scale, G = quantized(
                    w_edge, w, ("w4", eff_group),
                    lambda: _w4_group_quantize(np.asarray(w), eff_group))
                g.params[w_edge + "__w4"] = q
                g.params[w_edge + "__w4scale"] = scale
                node.inputs = [node.inputs[0], w_edge + "__w4",
                               w_edge + "__w4scale"] + rest
                node.attrs["w4_group"] = G
                node.op = "dense_w4"
                continue
        axis = 3 if node.op == "conv2d" else 1
        def w8():
            w_scale = per_channel_weight_scale(w, axis)
            return _quantize_weight(w, w_scale, axis), w_scale
        q8, w_scale = quantized(w_edge, w, ("w8", axis), w8)
        g.params[w_edge + "__w8"] = q8
        g.params[w_edge + "__w8scale"] = w_scale
        node.inputs = [node.inputs[0], w_edge + "__w8",
                       w_edge + "__w8scale"] + rest
        node.op = "dense_w8" if node.op == "dense" else "conv2d_w8"
    used = set()
    for node in g.nodes.values():
        used.update(node.inputs)
    for p in list(g.params):
        if p not in used:
            del g.params[p]
    g.applied_passes.append("weight_only_quantize")
    g.validate()
    return g
