"""Mixture-of-experts FFN: the port of `anakin_tpu/ops/moe.py`.

Static-shape top-k routing: every expert computes every token and the
combine weights (zero for the experts a token was not routed to) select,
so there is no ragged dispatch.  All of it runs in float32 with TF32 off.

Under a mesh the node runs replicated on every rank: the JAX docstring
says the expert dim shards over `model`, but its `shard_graph_params` has
no `moe_ffn` rule, so its experts stay replicated too; the port follows
the rules (ROADMAP §3).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from .nn import full_fp32
from .registry import register
from .tensor import top_k_lower_index


@register("moe_ffn")
def moe_ffn(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Top-k routed expert FFN.  inputs: x [B, S, E], w_gate [E, n_exp],
    w_up [n_exp, E, F], w_down [n_exp, F, E]; attrs `top_k` (2) and
    `activation` ("gelu", the tanh approximation that `jax.nn.gelu`
    defaults to, or "relu")."""
    x, w_gate, w_up, w_down = xs
    n_exp = w_gate.shape[1]
    top_k = int(node.attr("top_k", 2))
    act = node.attr("activation", "gelu")
    xf = x.to(torch.float32)
    with full_fp32():
        logits = torch.einsum("bse,en->bsn", xf, w_gate.to(torch.float32))
        gate_vals, gate_idx = top_k_lower_index(logits, top_k)
        gates = torch.softmax(gate_vals, dim=-1)
        combine = torch.zeros(logits.shape, dtype=torch.float32,
                              device=x.device)
        for j in range(top_k):
            combine = combine + gates[..., j:j + 1] * F.one_hot(
                gate_idx[..., j], n_exp).to(torch.float32)
        h = torch.einsum("bse,nef->bnsf", xf, w_up.to(torch.float32))
        if act == "gelu":
            h = F.gelu(h, approximate="tanh")
        elif act == "relu":
            h = torch.clamp_min(h, 0)
        y = torch.einsum("bnsf,nfe->bnse", h, w_down.to(torch.float32))
        out = torch.einsum("bnse,bsn->bse", y, combine)
    return [out.to(x.dtype)]
