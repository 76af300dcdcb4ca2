"""Ring attention: the port of `anakin_tpu/parallel/ring_attention.py`.

Context-parallel attention: Q, K and V are split along the sequence over a
mesh axis, one block a rank.  At each of the n steps a rank attends its Q
block to the KV block it holds, merges the result into float32
online-softmax statistics, and passes the KV block on to the next rank of
the ring; after n steps every Q block has seen every KV block, and no
[S, S] score matrix exists anywhere.  The causal mask comes from global
positions (the shard indices), so a block wholly above the diagonal adds
nothing.

The reference runs this as XLA code (no Pallas kernel), so the port's body
is plain torch math.  The next KV block is posted (`batch_isend_irecv`,
K and V in one message) before the held block's product, which overlaps
the transfer.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..ops.nn import full_fp32
from .mesh import DATA_AXIS, Axes, Mesh

__all__ = ["ring_attention"]

_NEG = -0.7 * float(np.finfo(np.float32).max)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, axis: Axes = DATA_AXIS, causal: bool = False,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """This rank's rows of attention over the whole sequence.  q, k, v:
    [B, H, S_loc, D], this rank's sequence block (block i holds positions
    i*S_loc ...); returns [B, H, S_loc, D] in q's dtype."""
    D = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    n = mesh.axis_size(axis)
    my = mesh.axis_index(axis)
    B, H, Sq, _ = q.shape
    Sk = k.shape[2]
    qf = q.to(torch.float32)
    m = torch.full((B, H, Sq, 1), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sq, 1), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    q_pos = my * Sq + torch.arange(Sq, device=q.device)[:, None]
    for step in range(n):
        src = (my - step) % n  # the rank whose KV block is held
        wait = mesh.ring_send_recv(kv, axis, 1) if step != n - 1 else None
        with full_fp32():
            s = torch.einsum("bhqd,bhkd->bhqk", qf, kv[0].to(torch.float32))
        s = s * sm_scale
        if causal:
            k_pos = src * Sk + torch.arange(Sk, device=q.device)[None, :]
            s = torch.where((k_pos <= q_pos)[None, None], s, _NEG)
        m_next = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next)
        l = alpha * l + p.sum(-1, keepdim=True)
        with full_fp32():
            o = o * alpha + torch.einsum("bhqk,bhkd->bhqd", p,
                                         kv[1].to(torch.float32))
        m = m_next
        if wait is not None:
            kv = wait()
    l_inv = torch.where(l == 0.0, 1.0, 1.0 / l)
    return (o * l_inv).to(q.dtype)
