"""Sharding rules for inference graphs: the port of
`anakin_tpu/parallel/sharding.py`, copied rule for rule.

Rules (Megatron-style inference sharding over HWIO / (in, out) weights),
each a `Spec` of the weight:

  * attention (`mha_decode`, `mha_verify`, `mha_prefill`,
    `multi_head_attention`): wq / wk / wv column-sharded (each rank owns
    H/tp query heads and Hkv/tp kv heads), wo row-sharded, so that the
    block costs one all-reduce;
  * the embedding table [V, E]: E sharded;
  * `dense_w4`: a row pair ([K/2, N] packed rows and their [K/G, N] scale
    rows) where tp divides the group count K/G and the input is
    column-sharded upstream; else N column-sharded, scales following;
  * dense: a row pair behind a column-sharded producer (seen through the
    SwiGLU gate, `_col_sharded_upstream`); else, like a conv, O
    column-sharded from `min_channels` on;
  * the bias and per-channel vectors of a column-sharded weight follow its
    out channels; every other param is replicated (`moe_ffn` among them:
    no rule shards its experts).

`shard_graph_params` returns {param edge: Spec}, the `param_sharding` of
`Net`; `input_sharding` and `output_sharding` give the activations' specs.
How a rank runs each node under these rules is `parallel.tensor_parallel`.
"""

from __future__ import annotations

from typing import Dict

from ..graph.ir import Graph, topological_order
from .mesh import MODEL_AXIS, Mesh, Spec, batch_axes

__all__ = ["shard_graph_params", "input_sharding", "output_sharding"]


def _divisible(dim: int, by: int) -> bool:
    return by > 0 and dim % by == 0


def _col_sharded_upstream(graph, producers, rules, edge, col) -> bool:
    """True when `edge` is produced by a column-sharded matmul: directly,
    or through an elementwise combine of column-sharded matmuls (the
    SwiGLU gate: eltwise-mul of up and gate denses), or an activation of
    one.  Such an input is already model-sharded on its feature dim, so the
    consuming dense can row-shard and all-reduce."""
    prod = producers.get(edge)
    if prod is None:
        return False
    if prod.op in ("dense", "dense_int8", "dense_w8", "dense_w4"):
        return rules.get(prod.inputs[1]) == col
    if prod.op in ("eltwise", "eltwise_op", "eltwise_act"):
        return all(_col_sharded_upstream(graph, producers, rules, e, col)
                   for e in prod.inputs)
    if prod.op == "activation":
        return _col_sharded_upstream(graph, producers, rules,
                                     prod.inputs[0], col)
    return False


def shard_graph_params(graph: Graph, mesh: Mesh,
                       min_channels: int = 128) -> Dict[str, Spec]:
    """{param edge: Spec}: model-parallel out-channel sharding for large
    conv / dense weights and their channel vectors, the Megatron pairs, the
    attention heads and the embedding's E; everything else replicated."""
    tp = mesh.shape[MODEL_AXIS]
    rules: Dict[str, Spec] = {}
    repl = Spec()
    col = Spec(None, MODEL_AXIS)
    row = Spec(MODEL_AXIS, None)
    producers = graph.producers()

    for node in topological_order(graph):
        if node.op in ("mha_decode", "mha_verify", "mha_prefill",
                       "multi_head_attention"):
            H = int(node.attr("num_heads", 0) or 0)
            Hkv = int(node.attr("num_kv_heads", H) or H)
            if tp > 1 and H and H % tp == 0 and Hkv % tp == 0:
                for idx in (1, 2, 3):
                    w = graph.params.get(node.inputs[idx])
                    if w is not None and w.ndim == 2 \
                            and _divisible(w.shape[1], tp):
                        rules[node.inputs[idx]] = col
                wo = graph.params.get(node.inputs[4])
                if wo is not None and wo.ndim == 2 \
                        and _divisible(wo.shape[0], tp):
                    rules[node.inputs[4]] = row
            continue
        if node.op == "embedding":
            t_edge = node.inputs[1]
            t = graph.params.get(t_edge)
            if (tp > 1 and t is not None and t.ndim == 2
                    and t.shape[1] >= min_channels
                    and _divisible(t.shape[1], tp)):
                rules[t_edge] = col
            continue
        if node.op == "dense_w4":
            w_edge, s_edge = node.inputs[1], node.inputs[2]
            w = graph.params.get(w_edge)
            s = graph.params.get(s_edge)
            if tp <= 1 or w is None or s is None:
                continue
            if (_divisible(s.shape[0], tp)
                    and _col_sharded_upstream(graph, producers, rules,
                                              node.inputs[0], col)):
                rules[w_edge] = row
                rules[s_edge] = row
                continue  # bias stays replicated (added after the sum)
            if w.shape[1] >= min_channels and _divisible(w.shape[1], tp):
                rules[w_edge] = col
                _shard_channel_vectors(graph, node, rules, w.shape[1])
            continue
        if node.op in ("dense", "dense_int8", "dense_w8"):
            w_edge = node.inputs[1]
            w = graph.params.get(w_edge)
            if (tp > 1 and w is not None and w.ndim == 2
                    and _divisible(w.shape[0], tp)
                    and _col_sharded_upstream(graph, producers, rules,
                                              node.inputs[0], col)):
                rules[w_edge] = row
                continue  # bias stays replicated (added after the sum)
        if node.op in ("conv2d", "conv2d_int8", "conv2d_w8"):
            w_edge = node.inputs[1]
            w = graph.params.get(w_edge)
            if w is None:
                continue
            O = w.shape[3]
            groups = int(node.attr("groups", 1))
            if tp > 1 and groups == 1 and O >= min_channels and _divisible(O, tp):
                rules[w_edge] = Spec(None, None, None, MODEL_AXIS)
                _shard_channel_vectors(graph, node, rules, O)
        elif node.op in ("dense", "dense_int8", "dense_w8"):
            w_edge = node.inputs[1]
            w = graph.params.get(w_edge)
            if w is None:
                continue
            out = w.shape[1]
            if tp > 1 and out >= min_channels and _divisible(out, tp):
                rules[w_edge] = col
                _shard_channel_vectors(graph, node, rules, out)
    for e in graph.params:
        rules.setdefault(e, repl)
    return rules


def _shard_channel_vectors(graph, node, rules, O):
    """Bias / w_scale arrays of a sharded matmul follow the out channels:
    1-D [O] vectors shard fully; 2-D [*, O] group-scale matrices (w4)
    shard their last axis."""
    for e in node.inputs[2:]:
        v = graph.params.get(e)
        if v is None:
            continue
        if v.ndim == 1 and v.shape[0] == O:
            rules[e] = Spec(MODEL_AXIS)
        elif v.ndim == 2 and v.shape[1] == O:
            rules[e] = Spec(None, MODEL_AXIS)


def input_sharding(mesh: Mesh, ndim: int = 4) -> Spec:
    """Activations: batch over the batch axes ((dcn, data) on a hybrid
    mesh, (data,) on a flat one), whole elsewhere."""
    return Spec(batch_axes(mesh), *([None] * (ndim - 1)))


def output_sharding(mesh: Mesh, ndim: int = 2) -> Spec:
    return Spec(batch_axes(mesh), *([None] * (ndim - 1)))
