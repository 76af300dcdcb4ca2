"""Weight-folding passes: BN / scale / affine_channel folded into conv|dense.

Deterministic math port of the reference's `WeightsFusion` helpers
(`framework/utils/parameter_fusion.h:25-231`, applied at fusion-op init,
e.g. `framework/operators/fusion_ops/conv_batchnorm_scale_relu.cpp:92-127`):

  batch_norm (inference):  s = 1/sqrt(var+eps),      t = -mean * s
  scale (gamma, beta):     s = gamma,                t = beta
  affine_channel:          s = scale_w,              t = scale_b

For a conv with weights W (HWIO) and bias b, folding an affine (s, t) on the
OUTPUT channels gives  W' = W * s[O],  b' = b * s + t.  Chains
(conv→bn→scale) fold by running the pass to fixpoint.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..ir import Graph, Node
from .cleanup import replace_edge_uses

__all__ = ["fold_batch_norms"]

# op -> (per-out-channel scale, shift) extractor
_FOLDABLE_PRODUCERS = {"conv2d", "deconv2d", "dense"}


def _affine_of(node: Node, g: Graph) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Return (scale, shift) vectors if `node` is a constant channel affine."""
    if node.op == "batch_norm":
        mean_e, var_e = node.inputs[1], node.inputs[2]
        if mean_e not in g.params or var_e not in g.params:
            return None
        mean = g.params[mean_e].astype(np.float64)
        var = g.params[var_e].astype(np.float64)
        eps = float(node.attr("eps", 1e-5))
        s = 1.0 / np.sqrt(var + eps)
        return s, -mean * s
    if node.op in ("scale", "affine_channel"):
        gamma_e = node.inputs[1]
        if gamma_e not in g.params:
            return None
        gamma = g.params[gamma_e].astype(np.float64)
        if len(node.inputs) > 2 and node.attr("bias_term", True):
            beta_e = node.inputs[2]
            if beta_e not in g.params:
                return None
            beta = g.params[beta_e].astype(np.float64)
        else:
            beta = np.zeros_like(gamma)
        return gamma, beta
    return None


def _out_channel_axis(op: str) -> int:
    # conv2d/deconv2d weights are HWIO -> O at axis 3; dense (in,out) -> 1.
    return 3 if op in ("conv2d", "deconv2d") else 1


def fold_batch_norms(graph: Graph) -> Graph:
    """Fold every const BN/scale/affine whose sole input is a conv/dense."""
    g = graph.clone()
    changed = True
    while changed:
        changed = False
        producers = g.producers()
        consumers = g.consumers()
        for name, node in list(g.nodes.items()):
            aff = _affine_of(node, g)
            if aff is None:
                continue
            src_edge = node.inputs[0]
            prod = producers.get(src_edge)
            if prod is None or prod.op not in _FOLDABLE_PRODUCERS:
                continue
            # the conv's output must feed only this affine (else the affine
            # would change other consumers' values)
            if len(consumers.get(src_edge, [])) != 1 or src_edge in g.outputs:
                continue
            if prod.attr("activation") or prod.attr("has_residual"):
                continue  # epilogue already sealed; don't reorder math
            s, t = aff
            w_edge = prod.inputs[1]
            w = g.params[w_edge].astype(np.float64)
            axis = _out_channel_axis(prod.op)
            if prod.op == "deconv2d":
                # HWIO with O = out/groups: per-out-channel scale still maps
                # onto axis 3 after the group reshape; groups>1 handled by
                # reshaping s across the group blocks.
                groups = int(prod.attr("groups", 1))
                if groups != 1:
                    continue  # rare; leave unfused
            shape = [1] * w.ndim
            shape[axis] = -1
            w_new = (w * s.reshape(shape)).astype(g.params[w_edge].dtype)
            new_w_edge = f"{w_edge}__folded_{name}"
            g.params[new_w_edge] = w_new
            prod.inputs[1] = new_w_edge
            if prod.attr("has_bias"):
                b_edge = prod.inputs[2]
                b = g.params[b_edge].astype(np.float64)
                new_b = (b * s + t).astype(g.params[b_edge].dtype)
                new_b_edge = f"{b_edge}__folded_{name}"
                g.params[new_b_edge] = new_b
                prod.inputs[2] = new_b_edge
            else:
                new_b_edge = f"{name}__bias"
                g.params[new_b_edge] = t.astype(w_new.dtype)
                prod.inputs.insert(2, new_b_edge)
                prod.attrs["has_bias"] = True
            replace_edge_uses(g, node.outputs[0], src_edge)
            g.remove_node(name)
            changed = True
    g.applied_passes.append("fold_batch_norms")
    return g
