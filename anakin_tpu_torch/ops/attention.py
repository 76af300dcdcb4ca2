"""Attention ops: prefill attention, prefill that also emits the KV cache,
and the one-token decode step against a static-shape KV cache (the port of
`anakin_tpu/ops/attention.py`).

Weights: wq [E, H*D], wk / wv [E, Hkv*D], wo [H*D, E]; GQA through
`num_kv_heads`; rotary embeddings; causal and length masks.  Projections
accumulate in float32 and round to the activation dtype, as the JAX ops'
`preferred_element_type=float32` einsums do.  `impl == "flash"` sends
prefill attention through `kernels.flash_attention`, which takes the
grouped kv heads as they are and masks a ragged S itself (the JAX package
pads S to a multiple of 128 for its TPU kernel; rows at or past a length
then differ between the two, and from the dense path's, by design: only
rows below the length are read); otherwise the dense path runs.

The decode op writes the new cache row IN PLACE into the cache tensors it
is given and returns them: the JAX op returns new arrays, but a copy of a
1B-class cache per step would cost more device traffic than the step's
weights.  A caller that keeps the old caches feeds copies.  `mha_verify`,
the decode op over a chunk of T tokens, writes its T rows in place too.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention, mha_reference
from .nn import full_fp32
from .registry import register

__all__ = ["apply_rope"]


def _rope_freqs(D: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                         device=device) / D))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding.  x: [B, H, S, D], positions: [B, S]."""
    B, H, S, D = x.shape
    freqs = _rope_freqs(D, theta, x.device)                          # [D/2]
    ang = positions.to(torch.float32)[:, None, :, None] * freqs      # [B,1,S,D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = x[..., 0::2].to(torch.float32)
    x2 = x[..., 1::2].to(torch.float32)
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(B, H, S, D).to(x.dtype)


def _project(x, w, heads, D):
    """x [B, S, E] @ w [E, heads*D] in float32 -> [B, heads, S, D] in x's
    dtype."""
    B, S, _ = x.shape
    with full_fp32():
        y = torch.matmul(x.to(torch.float32), w.to(x.dtype).to(torch.float32))
    return y.reshape(B, S, heads, D).permute(0, 2, 1, 3).to(x.dtype)


def _out_project(o, wo, x, node):
    """o [B, H, S, D] (cast to x's dtype) @ wo [H*D, E] in float32 ->
    [B, S, E] in x's dtype; in float32 with attr `partial_out` (a
    tensor-parallel rank's partial sum over its heads, which the rank
    all-reduces before the cast)."""
    B, H, S, D = o.shape
    of = o.to(x.dtype).to(torch.float32).permute(0, 2, 1, 3).reshape(B, S, H * D)
    with full_fp32():
        y = torch.matmul(of, wo.to(x.dtype).to(torch.float32))
    return y if node.attr("partial_out", False) else y.to(x.dtype)


def _heads(node, wq):
    H = int(node.attr("num_heads"))
    return H, int(node.attr("num_kv_heads", H)), wq.shape[1] // H


def _qkv(node, x, wq, wk, wv, positions):
    H, Hkv, D = _heads(node, wq)
    q, k, v = _project(x, wq, H, D), _project(x, wk, Hkv, D), _project(x, wv, Hkv, D)
    if node.attr("rope", True):
        q, k = apply_rope(q, positions), apply_rope(k, positions)
    return q, k, v


def _length_segments(lengths, S, device):
    """[B, S] int32: 0 below each row's length, 1 from it on."""
    t = torch.arange(S, dtype=torch.int32, device=device)[None]
    return (t >= lengths.to(torch.int32)[:, None]).to(torch.int32)


def _quantize_kv(t: torch.Tensor, scale: float) -> torch.Tensor:
    """The JAX op's int8 cache write: divide by the scale, round half to
    even, clip (not the kernels' reciprocal multiply)."""
    return torch.clamp(torch.round(t.to(torch.float32) / scale), -127, 127).to(
        torch.int8)


@register("multi_head_attention")
def multi_head_attention(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Prefill attention.  inputs: x [B,S,E], wq, wk, wv, wo, [lengths].
    attrs: num_heads, num_kv_heads, causal (True), rope (True), impl."""
    it = iter(xs)
    x, wq, wk, wv, wo = (next(it) for _ in range(5))
    lengths = next(it) if node.attr("has_lengths", False) else None
    B, S, _ = x.shape
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    q, k, v = _qkv(node, x, wq, wk, wv, pos)
    causal = bool(node.attr("causal", True))
    seg = None if lengths is None else _length_segments(lengths, S, x.device)
    if node.attr("impl") == "flash":
        o = flash_attention(q, k, v, seg, seg, causal=causal)
    else:
        o = mha_reference(q, k, v, seg, seg, causal=causal)
    return [_out_project(o, wo, x, node)]


@register("mha_prefill")
def mha_prefill(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Prefill attention that also emits the KV caches: (y [B,S,E],
    cache_k [B,Hkv,max_seq,D], cache_v) with rows 0..S-1 filled.  Same
    inputs and attrs as multi_head_attention plus `max_seq` and the int8
    cache attrs (`kv_cache_dtype`, `k_scale`, `v_scale`)."""
    it = iter(xs)
    x, wq, wk, wv, wo = (next(it) for _ in range(5))
    lengths = next(it) if node.attr("has_lengths", False) else None
    B, S, _ = x.shape
    H, Hkv, D = _heads(node, wq)
    pad = (0, 0, 0, int(node.attr("max_seq")) - S)
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    q, k, v = _qkv(node, x, wq, wk, wv, pos)
    if node.attr("kv_cache_dtype") == "int8":
        cache_k = F.pad(_quantize_kv(k, float(node.attr("k_scale"))), pad)
        cache_v = F.pad(_quantize_kv(v, float(node.attr("v_scale"))), pad)
    else:
        cache_k, cache_v = F.pad(k, pad), F.pad(v, pad)
    causal = bool(node.attr("causal", True))
    if node.attr("impl") == "flash":
        seg = None if lengths is None else _length_segments(lengths, S, x.device)
        o = flash_attention(q, k, v, seg, seg, causal=causal).to(torch.float32)
    else:
        rep = H // Hkv
        qg = q.reshape(B, Hkv, rep, S, D).to(torch.float32)
        with full_fp32():
            s = torch.einsum("bgrsd,bgkd->bgrsk", qg, k.to(torch.float32))
        s = s / math.sqrt(D)
        t = torch.arange(S, device=x.device)
        if causal:
            s = torch.where(t[:, None] >= t[None, :], s, -1e30)
        if lengths is not None:
            ok = t[None] < lengths.to(torch.int64)[:, None]
            s = torch.where(ok[:, None, None, None, :], s, -1e30)
        p_att = torch.softmax(s, dim=-1)
        with full_fp32():
            o = torch.einsum("bgrsk,bgkd->bgrsd", p_att, v.to(torch.float32))
        o = o.reshape(B, H, S, D)
    return [_out_project(o, wo, x, node), cache_k, cache_v]


def _write_rows(cache: torch.Tensor, rows: torch.Tensor, pos: torch.Tensor,
                clamp: bool) -> torch.Tensor:
    """Write row b of `rows` [B, Hkv, 1, D] at position pos[b] of `cache`
    [B, Hkv, Smax, D], in place, without a host sync.  clamp=True moves a
    position past the cache onto its last row (`dynamic_update_slice`);
    clamp=False drops that row's write (the one-hot blend, and a scatter
    with out-of-range indices)."""
    B, Smax = cache.shape[0], cache.shape[2]
    p = pos.to(torch.int64)
    pc = torch.clamp(p, 0, Smax - 1)
    b = torch.arange(B, device=cache.device)
    new = rows[:, :, 0, :]
    if not clamp:
        keep = ((p >= 0) & (p < Smax))[:, None, None]
        new = torch.where(keep, new, cache[b, :, pc, :])
    cache[b, :, pc, :] = new
    return cache


@register("mha_decode")
def mha_decode(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """One-token decode against a static-shape KV cache.

    inputs: x [B,1,E], wq, wk, wv, wo, cache_k [B,Hkv,Smax,D], cache_v,
    pos [B] int32.  outputs: y [B,1,E], cache_k, cache_v (the inputs,
    updated in place).

    Cache writes, all equal for positions inside the cache:
      * attr `aligned_pos=True`: every row at pos[0] (the op reads pos[0]
        only), a position past the cache clamps onto its last row;
      * attr `cache_update="rows"`: each row at its own position, clamped;
      * "blend" (default) and "scatter": each row at its own position, a
        position outside the cache writes nothing.
    attr `cache_view`: attention reads only rows [0, view) of the cache
    (every position must stay below it).
    """
    x, wq, wk, wv, wo, cache_k, cache_v, pos = xs
    B, _, E = x.shape
    H, Hkv, D = _heads(node, wq)
    Smax = cache_k.shape[2]
    q, k, v = _qkv(node, x, wq, wk, wv, pos.to(torch.int32)[:, None])
    kv_int8 = node.attr("kv_cache_dtype") == "int8"
    if kv_int8:
        ks, vs = float(node.attr("k_scale")), float(node.attr("v_scale"))
        rk, rv = _quantize_kv(k, ks), _quantize_kv(v, vs)
    else:
        rk, rv = k.to(cache_k.dtype), v.to(cache_v.dtype)
    if node.attr("aligned_pos", False):
        wpos, clamp = pos[:1].expand(B), True
    else:
        wpos, clamp = pos, node.attr("cache_update", "blend") == "rows"
    ck = _write_rows(cache_k, rk, wpos, clamp)
    cv = _write_rows(cache_v, rv, wpos, clamp)
    view = int(node.attr("cache_view", 0) or 0)
    Sr = view if view and view < Smax else Smax
    k_read = ck[:, :, :Sr].to(torch.float32)
    v_read = cv[:, :, :Sr].to(torch.float32)
    if kv_int8:
        k_read, v_read = k_read * ks, v_read * vs
    qg = q.reshape(B, Hkv, H // Hkv, D).to(torch.float32)
    with full_fp32():
        s = torch.einsum("bgrd,bgkd->bgrk", qg, k_read)
    s = s / math.sqrt(D)
    t = torch.arange(Sr, device=x.device)[None]
    valid = t <= pos.to(torch.int64)[:, None]                        # [B, Sr]
    s = torch.where(valid[:, None, None, :], s, -1e30)
    p_att = torch.softmax(s, dim=-1)
    with full_fp32():
        o = torch.einsum("bgrk,bgkd->bgrd", p_att, v_read).reshape(B, H, 1, D)
    return [_out_project(o, wo, x, node), ck, cv]


def _write_chunk(cache: torch.Tensor, rows: torch.Tensor, pos: torch.Tensor,
                 clamp: bool) -> torch.Tensor:
    """Write row b's chunk `rows` [B, Hkv, T, D] at positions pos[b] ..
    pos[b] + T - 1 of `cache` [B, Hkv, Smax, D], in place, without a host
    sync.  clamp=True moves a chunk that would pass the cache back so that
    it ends on its last row (`dynamic_update_slice`); clamp=False is the
    one-hot blend: every cache row takes the chunk row at its position, if
    any, so the rows at or past the cache are dropped."""
    B, Smax, T = cache.shape[0], cache.shape[2], rows.shape[2]
    p = pos.to(torch.int64)
    if clamp:
        idx = (torch.clamp(p, 0, Smax - T)[:, None]
               + torch.arange(T, device=cache.device)[None])            # [B, T]
        b = torch.arange(B, device=cache.device)[:, None]
        cache[b, :, idx, :] = rows.permute(0, 2, 1, 3)
        return cache
    t = torch.arange(Smax, device=cache.device)[None] - p[:, None]      # [B, S]
    hit = (t >= 0) & (t < T)
    g = torch.gather(rows, 2, torch.clamp(t, 0, T - 1)[:, None, :, None]
                     .expand(B, rows.shape[1], Smax, rows.shape[3]))
    return cache.copy_(torch.where(hit[:, None, :, None], g, cache))


@register("mha_verify")
def mha_verify(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Chunk-verify attention: T tokens at positions pos..pos+T-1 against
    the KV cache (speculative verify, chunked prefill).  `mha_decode` for
    T tokens.

    inputs: x [B,T,E], wq, wk, wv, wo, cache_k [B,Hkv,Smax,D], cache_v,
    pos [B] int32 (the position of the chunk's first token).  outputs: y
    [B,T,E], cache_k, cache_v (the inputs, rows pos..pos+T-1 written in
    place).  attr `cache_update`: "rows" writes each row's chunk clamped to
    end inside the cache; "blend" (default) drops the rows at or past it.
    Token t attends the rows up to its own position.
    """
    x, wq, wk, wv, wo, cache_k, cache_v, pos = xs
    B, T, E = x.shape
    H, Hkv, D = _heads(node, wq)
    Smax = cache_k.shape[2]
    positions = (pos.to(torch.int32)[:, None]
                 + torch.arange(T, dtype=torch.int32, device=x.device)[None])
    q, k, v = _qkv(node, x, wq, wk, wv, positions)
    kv_int8 = node.attr("kv_cache_dtype") == "int8"
    if kv_int8:
        ks, vs = float(node.attr("k_scale")), float(node.attr("v_scale"))
        rk, rv = _quantize_kv(k, ks), _quantize_kv(v, vs)
    else:
        rk, rv = k.to(cache_k.dtype), v.to(cache_v.dtype)
    clamp = node.attr("cache_update", "blend") == "rows"
    ck = _write_chunk(cache_k, rk, pos, clamp)
    cv = _write_chunk(cache_v, rv, pos, clamp)
    k_read, v_read = ck.to(torch.float32), cv.to(torch.float32)
    if kv_int8:
        k_read, v_read = k_read * ks, v_read * vs
    qg = q.reshape(B, Hkv, H // Hkv, T, D).to(torch.float32)
    with full_fp32():
        s = torch.einsum("bgrtd,bgsd->bgrts", qg, k_read)
    s = s / math.sqrt(D)
    sidx = torch.arange(Smax, device=x.device)
    valid = sidx[None, None, :] <= positions.to(torch.int64)[:, :, None]  # [B,T,S]
    s = torch.where(valid[:, None, None], s, -1e30)
    p_att = torch.softmax(s, dim=-1)
    with full_fp32():
        o = torch.einsum("bgrts,bgsd->bgrtd", p_att, v_read).reshape(B, H, T, D)
    return [_out_project(o, wo, x, node), ck, cv]
