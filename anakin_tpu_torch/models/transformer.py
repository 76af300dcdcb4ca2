"""Decoder-only transformer LM builders (`anakin_tpu/models/transformer.py`,
plain graph code, copied so that the port builds the same graphs with the
same names and byte-equal weights).

  * `build_transformer_lm`: [B, S] tokens -> [B, S, V] logits; GQA, RoPE;
    `TransformerConfig` selects the GPT-class recipe (LayerNorm + gelu
    MLP, the default) or the llama-class one (`norm="rms"`,
    `mlp="swiglu"`).
  * `build_transformer_prefill`: the prompt in one pass that also emits
    the KV caches (`attention_impl="flash"` routes attention through the
    flash kernel).
  * `build_transformer_decode_step`: one token against static KV caches;
    the caches are graph inputs and outputs, so a step is one `Net` call
    and generation is a host loop (`runtime/generate.py`).
  * `build_transformer_verify_step`: a chunk of tokens against the caches
    (speculative decoding); its `mha_verify` op is not ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..graph.ir import Graph, GraphBuilder

__all__ = ["TransformerConfig", "build_transformer_lm",
           "build_transformer_prefill", "build_transformer_decode_step",
           "build_transformer_verify_step", "make_transformer_params"]


class TransformerConfig:
    """Decoder-only config.  `norm`: "layer" (GPT-class LN with bias) or
    "rms" (llama-class RMSNorm, no bias).  `mlp`: "gelu" (up/down) or
    "swiglu" (gated silu — up, gate, down with hidden = mlp_mult*E)."""

    def __init__(self, vocab: int = 8000, embed: int = 256, heads: int = 8,
                 kv_heads: int = 4, layers: int = 4, mlp_mult: int = 4,
                 max_seq: int = 128, norm: str = "layer",
                 mlp: str = "gelu"):
        self.vocab = vocab
        self.embed = embed
        self.heads = heads
        self.kv_heads = kv_heads
        self.layers = layers
        self.mlp_mult = mlp_mult
        self.max_seq = max_seq
        self.head_dim = embed // heads
        if norm not in ("layer", "rms"):
            raise ValueError(f"norm {norm!r}")
        if mlp not in ("gelu", "swiglu"):
            raise ValueError(f"mlp {mlp!r}")
        self.norm = norm
        self.mlp = mlp


def make_transformer_params(cfg: TransformerConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """One named weight set shared by the prefill and decode builders."""
    rng = np.random.default_rng(seed)
    E, H, Hkv, D = cfg.embed, cfg.heads, cfg.kv_heads, cfg.head_dim
    F = cfg.mlp_mult * E
    p: Dict[str, np.ndarray] = {}

    def w(name, shape, scale):
        p[name] = rng.normal(0.0, scale, shape).astype(np.float32)

    def norm_params(name):
        w(f"{name}_g", (E,), 0.0); p[f"{name}_g"] += 1.0
        if cfg.norm == "layer":
            w(f"{name}_b", (E,), 0.0)

    w("embed", (cfg.vocab, E), 0.02)
    for i in range(cfg.layers):
        norm_params(f"l{i}.ln1")
        w(f"l{i}.wq", (E, H * D), E ** -0.5)
        w(f"l{i}.wk", (E, Hkv * D), E ** -0.5)
        w(f"l{i}.wv", (E, Hkv * D), E ** -0.5)
        w(f"l{i}.wo", (H * D, E), (H * D) ** -0.5)
        norm_params(f"l{i}.ln2")
        w(f"l{i}.mlp_up", (E, F), E ** -0.5)
        if cfg.mlp == "swiglu":
            w(f"l{i}.mlp_gate", (E, F), E ** -0.5)
        w(f"l{i}.mlp_down", (F, E), F ** -0.5)
    norm_params("lnf")
    w("lm_head", (E, cfg.vocab), E ** -0.5)
    return p


def _norm(b, e, cfg, x, name):
    """One pre/post norm per cfg.norm (shared by all four builders)."""
    if cfg.norm == "rms":
        return b.op("rms_norm", [x, e[f"{name}_g"]])
    return b.op("layer_norm", [x, e[f"{name}_g"], e[f"{name}_b"]],
                begin_norm_axis=2)


def _ffn(b, e, cfg, i, x):
    """MLP block per cfg.mlp: gelu up/down or swiglu (silu gate)."""
    if cfg.mlp == "swiglu":
        up = b.op("dense", [x, e[f"l{i}.mlp_up"]], axis=2)
        gate = b.op("dense", [x, e[f"l{i}.mlp_gate"]], axis=2,
                    activation="swish")
        h = b.op("eltwise", [up, gate], mode="mul")
        return b.op("dense", [h, e[f"l{i}.mlp_down"]], axis=2)
    h = b.op("dense", [x, e[f"l{i}.mlp_up"]], axis=2, activation="gelu")
    return b.op("dense", [h, e[f"l{i}.mlp_down"]], axis=2)


def _add_params(b: GraphBuilder, params: Dict[str, np.ndarray]) -> Dict[str, str]:
    return {k: b.graph.add_param(k, v) for k, v in params.items()}


def _layer_kv_scale(kv_scale, i):
    """kv_scale: float (shared) | list of per-layer floats | list of
    per-layer (k_scale, v_scale) pairs (from `calibrate_kv_scales`)."""
    if isinstance(kv_scale, (int, float)):
        return float(kv_scale), float(kv_scale)
    v = kv_scale[i]
    if isinstance(v, (tuple, list)):
        return float(v[0]), float(v[1])
    return float(v), float(v)


def _block_prefill(b, e, cfg, i, x, lengths):
    ln1 = _norm(b, e, cfg, x, f"l{i}.ln1")
    att_in = [ln1, e[f"l{i}.wq"], e[f"l{i}.wk"], e[f"l{i}.wv"], e[f"l{i}.wo"]]
    attrs = dict(num_heads=cfg.heads, num_kv_heads=cfg.kv_heads, causal=True,
                 rope=True)
    if lengths is not None:
        att_in.append(lengths)
        attrs["has_lengths"] = True
    att = b.op("multi_head_attention", att_in, **attrs)
    x = b.op("eltwise", [x, att], mode="sum")
    ln2 = _norm(b, e, cfg, x, f"l{i}.ln2")
    h = _ffn(b, e, cfg, i, ln2)
    return b.op("eltwise", [x, h], mode="sum")


def build_transformer_lm(cfg: TransformerConfig, batch: int, seq_len: int,
                         params: Dict[str, np.ndarray] = None,
                         with_lengths: bool = True, seed: int = 0) -> Graph:
    params = params if params is not None else make_transformer_params(cfg, seed)
    b = GraphBuilder("transformer_lm")
    e = _add_params(b, params)
    ids = b.input((batch, seq_len), dtype="int32", name="input")
    lengths = b.input((batch,), dtype="int32", name="lengths") if with_lengths else None
    x = b.op("embedding", [ids, e["embed"]])
    for i in range(cfg.layers):
        x = _block_prefill(b, e, cfg, i, x, lengths)
    x = _norm(b, e, cfg, x, "lnf")
    logits = b.op("dense", [x, e["lm_head"]], axis=2)
    b.output(logits)
    return b.finish()


def build_transformer_prefill(cfg: TransformerConfig, batch: int,
                              seq_len: int,
                              params: Dict[str, np.ndarray] = None,
                              seed: int = 0,
                              kv_cache_dtype: str = "float32",
                              kv_scale: float = 0.05,
                              attention_impl: str = None,
                              last_token_only: bool = False) -> Graph:
    """Prefill graph that also emits KV caches: (ids) -> (logits,
    cache_k_0, cache_v_0, ...) — one call replaces the
    token-at-a-time prefill loop.  Cache edges are named like the decode
    graph's inputs so outputs feed straight into decode feeds.
    `attention_impl="flash"` routes the scores through the flash kernel
    (`GenerationSession` picks it on CUDA from a 512-token bucket on).

    `last_token_only=True` adds an `nreal` [B] int32 input and applies
    the final LN + lm_head to ONLY each row's last real position
    (`sequence_pool last` — the LoD discipline): logits come out
    [B, 1, V] instead of [B, S, V].  At admission scale that removes a
    2 x B x S x E x V FLOP head pass and the [B, S, V] logits
    materialization (2.1 GB at B=8, S=2048, V=32k) that the scheduler
    would gather one row from anyway."""
    params = params if params is not None else make_transformer_params(cfg, seed)
    b = GraphBuilder("transformer_prefill")
    e = _add_params(b, params)
    ids = b.input((batch, seq_len), dtype="int32", name="input")
    nreal = (b.input((batch,), dtype="int32", name="nreal")
             if last_token_only else None)
    x = b.op("embedding", [ids, e["embed"]])
    caches = []
    for i in range(cfg.layers):
        ln1 = _norm(b, e, cfg, x, f"l{i}.ln1")
        att, ck, cv = b.op(
            "mha_prefill",
            [ln1, e[f"l{i}.wq"], e[f"l{i}.wk"], e[f"l{i}.wv"], e[f"l{i}.wo"]],
            n_out=3, name=f"pre_att_{i}",
            num_heads=cfg.heads, num_kv_heads=cfg.kv_heads, causal=True,
            rope=True, max_seq=cfg.max_seq,
            **({} if attention_impl is None else dict(impl=attention_impl)),
            **({} if kv_cache_dtype != "int8" else dict(
                kv_cache_dtype="int8",
                k_scale=_layer_kv_scale(kv_scale, i)[0],
                v_scale=_layer_kv_scale(kv_scale, i)[1])))
        caches.append((ck, cv))
        x = b.op("eltwise", [x, att], mode="sum")
        ln2 = _norm(b, e, cfg, x, f"l{i}.ln2")
        h = _ffn(b, e, cfg, i, ln2)
        x = b.op("eltwise", [x, h], mode="sum")
    if nreal is not None:
        last = b.op("sequence_pool", [x, nreal], mode="last")  # [B, E]
        x = b.op("reshape", [last], shape=[0, 1, cfg.embed])
    x = _norm(b, e, cfg, x, "lnf")
    logits = b.op("dense", [x, e["lm_head"]], axis=2)
    b.output(logits)
    for ck, cv in caches:
        b.output(ck, cv)
    return b.finish()


def build_transformer_decode_step(cfg: TransformerConfig, batch: int,
                                  params: Dict[str, np.ndarray] = None,
                                  seed: int = 0,
                                  kv_cache_dtype: str = "float32",
                                  kv_scale: float = 0.05,
                                  aligned_pos: bool = False,
                                  cache_update: str = "blend",
                                  cache_view: int = 0) -> Graph:
    """Decode graph: (token, caches..., pos) -> (logits, new caches...).

    Cache edges: `cache_k_{i}` / `cache_v_{i}` inputs, `new_cache_k_{i}` /
    `new_cache_v_{i}` outputs, shape [B, Hkv, max_seq, D].
    `kv_cache_dtype="int8"` stores the caches quantized with static scale
    `kv_scale` (halves the decode step's dominant HBM traffic).
    `aligned_pos=True` promises every batch row decodes at the same
    position (single-row cache writes — see `mha_decode`).
    `cache_update` selects the distinct-per-row-position write strategy
    ("blend" | "rows" | "scatter" — `mha_decode` cache-write policy).
    `cache_view` (static) limits attention READS to the first
    `cache_view` rows — callers guarantee pos < cache_view (the
    scheduler's bucketed-view programs; see mha_decode).
    """
    params = params if params is not None else make_transformer_params(cfg, seed)
    b = GraphBuilder("transformer_decode")
    e = _add_params(b, params)
    ids = b.input((batch, 1), dtype="int32", name="input")
    pos = b.input((batch,), dtype="int32", name="pos")
    cache_shape = (batch, cfg.kv_heads, cfg.max_seq, cfg.head_dim)
    kv8 = kv_cache_dtype == "int8"
    cache_dt = "int8" if kv8 else "float32"
    caches = []
    for i in range(cfg.layers):
        ck = b.graph.add_input(f"cache_k_{i}", cache_shape, cache_dt)
        cv = b.graph.add_input(f"cache_v_{i}", cache_shape, cache_dt)
        caches.append((ck, cv))

    def kv_attrs_for(i):
        if not kv8:
            return {}
        ks, vs = _layer_kv_scale(kv_scale, i)
        return dict(kv_cache_dtype="int8", k_scale=ks, v_scale=vs)
    x = b.op("embedding", [ids, e["embed"]])
    new_caches = []
    for i in range(cfg.layers):
        ln1 = _norm(b, e, cfg, x, f"l{i}.ln1")
        ck, cv = caches[i]
        att, nck, ncv = b.op(
            "mha_decode",
            [ln1, e[f"l{i}.wq"], e[f"l{i}.wk"], e[f"l{i}.wv"], e[f"l{i}.wo"],
             ck, cv, pos],
            n_out=3, name=f"dec_att_{i}",
            num_heads=cfg.heads, num_kv_heads=cfg.kv_heads, rope=True,
            aligned_pos=aligned_pos, cache_update=cache_update,
            cache_view=int(cache_view), **kv_attrs_for(i))
        new_caches.append((nck, ncv))
        x = b.op("eltwise", [x, att], mode="sum")
        ln2 = _norm(b, e, cfg, x, f"l{i}.ln2")
        h = _ffn(b, e, cfg, i, ln2)
        x = b.op("eltwise", [x, h], mode="sum")
    x = _norm(b, e, cfg, x, "lnf")
    logits = b.op("dense", [x, e["lm_head"]], axis=2)
    b.output(logits)
    for nck, ncv in new_caches:
        b.output(nck, ncv)
    return b.finish()


def build_transformer_verify_step(cfg: TransformerConfig, batch: int,
                                  chunk: int,
                                  params: Dict[str, np.ndarray] = None,
                                  seed: int = 0,
                                  kv_cache_dtype: str = "float32",
                                  kv_scale: float = 0.05,
                                  cache_update: str = "blend") -> Graph:
    """Chunk-verify graph for speculative decoding: (tokens [B, chunk],
    caches..., pos) -> (logits [B, chunk, V], new caches...).

    Same cache edge names/shapes as the decode graph, so a session can
    interleave single-token decode and chunk verify over one cache set.
    Attention nodes are named `ver_att_{i}`.
    """
    params = params if params is not None else make_transformer_params(cfg, seed)
    b = GraphBuilder("transformer_verify")
    e = _add_params(b, params)
    ids = b.input((batch, chunk), dtype="int32", name="input")
    pos = b.input((batch,), dtype="int32", name="pos")
    cache_shape = (batch, cfg.kv_heads, cfg.max_seq, cfg.head_dim)
    kv8 = kv_cache_dtype == "int8"
    caches = []
    for i in range(cfg.layers):
        ck = b.graph.add_input(f"cache_k_{i}", cache_shape,
                               "int8" if kv8 else "float32")
        cv = b.graph.add_input(f"cache_v_{i}", cache_shape,
                               "int8" if kv8 else "float32")
        caches.append((ck, cv))

    def kv_attrs_for(i):
        if not kv8:
            return {}
        ks, vs = _layer_kv_scale(kv_scale, i)
        return dict(kv_cache_dtype="int8", k_scale=ks, v_scale=vs)

    x = b.op("embedding", [ids, e["embed"]])
    new_caches = []
    for i in range(cfg.layers):
        ln1 = _norm(b, e, cfg, x, f"l{i}.ln1")
        ck, cv = caches[i]
        att, nck, ncv = b.op(
            "mha_verify",
            [ln1, e[f"l{i}.wq"], e[f"l{i}.wk"], e[f"l{i}.wv"], e[f"l{i}.wo"],
             ck, cv, pos],
            n_out=3, name=f"ver_att_{i}",
            num_heads=cfg.heads, num_kv_heads=cfg.kv_heads, rope=True,
            cache_update=cache_update, **kv_attrs_for(i))
        new_caches.append((nck, ncv))
        x = b.op("eltwise", [x, att], mode="sum")
        ln2 = _norm(b, e, cfg, x, f"l{i}.ln2")
        h = _ffn(b, e, cfg, i, ln2)
        x = b.op("eltwise", [x, h], mode="sum")
    x = _norm(b, e, cfg, x, "lnf")
    logits = b.op("dense", [x, e["lm_head"]], axis=2)
    b.output(logits)
    for nck, ncv in new_caches:
        b.output(nck, ncv)
    return b.finish()
