"""Epilogue-fusion passes: conv+act, conv+eltwise(+act), dense+act.

Re-design of the reference's declarative fusion-pattern engine
(`framework/graph/llvm/fusion/fusion_op_register.cpp:8-179`, 20 IN_ORDER
patterns matched by `VGraph::Match`) plus the ConvEltwise scheduler
(`framework/graph/llvm/optimizer/conv_elewise_fusion_scheduler.cpp`):

Instead of renaming node chains to dedicated fusion *ops*
(conv_batchnorm_scale_relu, conv_eltwise, …), we fold the epilogue INTO the
conv/dense node's attrs (`activation`, `has_residual`).  The op library then
emits one traced region per fused node and XLA/Pallas fuses bias + residual
+ activation into the matmul epilogue — the role the prebuilt SASS kernels
played (`third-party/sass/include/sass_funcs.h:481-543`).

Per-target pattern exclusions (`graph.cpp:378-392`) have no TPU analog:
there is one target, and every pattern is profitable because epilogues are
free on the VPU while the MXU result is still in registers.
"""

from __future__ import annotations

from ..ir import Graph, Node
from .cleanup import replace_edge_uses

__all__ = ["fuse_activations", "fuse_conv_eltwise"]

_MATMUL_OPS = {"conv2d", "deconv2d", "dense"}

# standalone activation node types the epilogue can absorb
_ABSORBABLE = {"relu", "relu6", "leaky_relu", "sigmoid", "tanh", "elu",
               "swish", "gelu", "clipped_relu", "soft_sign", "identity"}


def _as_activation(node: Node):
    """(act_name, alpha) if `node` is a standalone activation, else None."""
    if node.op == "activation":
        act = node.attr("activation", "relu")
        if act in _ABSORBABLE:
            return act, float(node.attr("act_alpha", 0.0))
    return None


def fuse_activations(graph: Graph) -> Graph:
    """conv2d/deconv2d/dense/eltwise + activation -> fused epilogue.

    Covers reference patterns ConvReLU, ConvAct, DeconvRelu, EltwiseRelu,
    EltwiseActivation and the act tail of ConvBatchnormScaleRelu (the BN part
    is handled by `fold_batch_norms` first).
    """
    g = graph.clone()
    changed = True
    while changed:
        changed = False
        producers = g.producers()
        consumers = g.consumers()
        for name, node in list(g.nodes.items()):
            act = _as_activation(node)
            if act is None:
                continue
            src = node.inputs[0]
            prod = producers.get(src)
            if prod is None or prod.op not in (_MATMUL_OPS | {"eltwise"}):
                continue
            if prod.attr("activation"):
                continue
            if len(consumers.get(src, [])) != 1 or src in g.outputs:
                continue
            prod.attrs["activation"] = act[0]
            prod.attrs["act_alpha"] = act[1]
            replace_edge_uses(g, node.outputs[0], src)
            g.remove_node(name)
            changed = True
    g.applied_passes.append("fuse_activations")
    return g


def fuse_conv_eltwise(graph: Graph) -> Graph:
    """conv2d + eltwise(sum) -> conv2d with fused residual input.

    The ResNet shortcut pattern (reference ConvEltwise fusion +
    conv_elewise_fusion_scheduler in-place rewrite).  The conv must be the
    single consumer side; the other eltwise operand becomes the `residual`
    input added in the conv epilogue before the activation.
    """
    g = graph.clone()
    changed = True
    while changed:
        changed = False
        producers = g.producers()
        consumers = g.consumers()
        for name, node in list(g.nodes.items()):
            if node.op != "eltwise" or node.attr("mode", "sum") not in ("sum", "add"):
                continue
            if len(node.inputs) != 2 or node.attr("coeffs"):
                continue
            # pick a conv operand whose output only feeds this eltwise
            conv, other = None, None
            for a, b in ((node.inputs[0], node.inputs[1]),
                         (node.inputs[1], node.inputs[0])):
                p = producers.get(a)
                if (
                    p is not None
                    and p.op == "conv2d"
                    and not p.attr("has_residual")
                    and not p.attr("activation")
                    and len(consumers.get(a, [])) == 1
                    and a not in g.outputs
                ):
                    conv, other = p, b
                    break
            if conv is None:
                continue
            # Residual must be computable before the conv: reject only if
            # `other` is (transitively) downstream of the conv — here it
            # can't be, because conv's only consumer is this eltwise.
            conv.inputs.append(other)
            conv.attrs["has_residual"] = True
            conv.attrs["activation"] = node.attr("activation")
            conv.attrs["act_alpha"] = node.attr("act_alpha", 0.0)
            replace_edge_uses(g, node.outputs[0], conv.outputs[0])
            g.remove_node(name)
            changed = True
    g.applied_passes.append("fuse_conv_eltwise")
    return g
