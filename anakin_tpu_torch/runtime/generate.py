"""Autoregressive generation: one fused prefill, then cached decode steps,
over two `Net`s (the port of `anakin_tpu/runtime/generate.py`).

The prompt goes through `build_transformer_prefill(..., last_token_only=
True)`, which scores it and emits the KV caches in one call; the decode
graph then advances one token a step.  Caches flow through named edges: the
prefill's cache outputs are named like the decode graph's cache inputs.
Logits, tokens and caches stay on the session's device between steps (the
decode op updates the caches in place); the greedy argmax runs there too.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..kernels.flash_attention import takes_head_dim
from ..models.transformer import (
    TransformerConfig,
    build_transformer_decode_step,
    build_transformer_prefill,
    make_transformer_params,
)
from .net import Net, _resolve_device

__all__ = ["GenerationSession", "prefill_bucket", "prefill_attention_impl"]

# Prompt-length buckets: one prefill graph per bucket, not per length.  Small
# buckets stay tight; beyond them multiples of 128.  Padding is exact for
# causal attention: position P-1 never attends rows >= P, and cache rows >= P
# are overwritten by the decode step that reaches them before any step reads
# them.
_BUCKETS_SMALL = (32, 64)
# flash from this bucket on (the JAX package's measured crossover, S >= 512)
_FLASH_FROM = 512


def prefill_bucket(P: int, max_seq: int) -> int:
    """The bucket length a P-token prompt is padded to."""
    for b in _BUCKETS_SMALL:
        if P <= b:
            return min(b, max_seq)
    return min(-(-P // 128) * 128, max_seq)


def prefill_attention_impl(device: torch.device, bucket: int, head_dim: int,
                           precision: str) -> Optional[str]:
    """The "auto" prefill attention: flash on CUDA from bucket 512 on, where
    the kernel takes the head dim for the net's dtype; else None (the dense
    path).  The JAX gate is its TPU backend."""
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    return ("flash" if device.type == "cuda" and bucket >= _FLASH_FROM
            and takes_head_dim(head_dim, dtype) else None)


class GenerationSession:
    """Greedy generation with a static-shape KV cache:

        s = GenerationSession(cfg, batch=8, precision="bf16",
                              kv_cache_dtype="int8")        # on CUDA
        tokens = s.generate(prompt, max_new_tokens=32)      # [B, P + 32]

    `device=None` means CUDA and raises where there is none, as `Net` does.
    `prefill_attention="auto"` uses the flash kernel when the session runs
    on CUDA, the prompt's bucket is at least 512 tokens and the kernel takes
    the head dim (`kernels.flash_attention.head_dims`), the dense path
    otherwise; any other value is the prefill graph's attention `impl`
    ("flash" forces the kernel, which raises `ValueError` on a head dim it
    does not take).  Every row decodes at the
    same position, so the decode graph takes the aligned single-row cache
    write.  `prefill_buckets=False` builds one prefill graph per exact
    prompt length instead of one per bucket (the JAX package's speculative
    session takes it: a bucket's padding moves the prefill's float sums).
    """

    def __init__(self, cfg: TransformerConfig, batch: int = 1,
                 params: Optional[Dict[str, np.ndarray]] = None,
                 precision: str = "fp32", seed: int = 0,
                 kv_cache_dtype: str = "float32", kv_scale: float = 0.05,
                 prefill_attention: str = "auto", device=None,
                 prefill_buckets: bool = True):
        self.cfg = cfg
        self.batch = batch
        self.device = _resolve_device(device)
        self.params = params if params is not None else \
            make_transformer_params(cfg, seed)
        self.precision = precision
        self.kv_cache_dtype = kv_cache_dtype
        self.kv_scale = kv_scale
        self.prefill_attention = prefill_attention
        self.prefill_buckets = prefill_buckets
        self.decode_graph = build_transformer_decode_step(
            cfg, batch, self.params, kv_cache_dtype=kv_cache_dtype,
            kv_scale=kv_scale, aligned_pos=True)
        self.decode_net = Net(self.decode_graph, precision=precision,
                              device=self.device)
        self._prefill_nets = {}  # bucket -> (Net, Graph)
        self._logits_edge = self.decode_graph.outputs[0]
        self._cache_edges = [
            (f"cache_{kv}_{i}", self.decode_graph.nodes[f"dec_att_{i}"]
             .outputs[1 + j]) for i in range(cfg.layers)
            for j, kv in enumerate("kv")]

    def _bucket(self, P: int) -> int:
        return prefill_bucket(P, self.cfg.max_seq) if self.prefill_buckets \
            else P

    def _attention_impl(self, bucket: int) -> Optional[str]:
        if self.prefill_attention != "auto":
            return self.prefill_attention
        return prefill_attention_impl(self.device, bucket, self.cfg.head_dim,
                                      self.precision)

    def _prefill_net(self, bucket: int):
        if bucket not in self._prefill_nets:
            g = build_transformer_prefill(
                self.cfg, self.batch, bucket, self.params,
                kv_cache_dtype=self.kv_cache_dtype, kv_scale=self.kv_scale,
                attention_impl=self._attention_impl(bucket),
                last_token_only=True)
            self._prefill_nets[bucket] = (Net(g, precision=self.precision,
                                              device=self.device), g)
        return self._prefill_nets[bucket]

    def _prefill(self, prompt: torch.Tensor):
        """Logits [B, 1, V] of each row's last prompt position, and the
        filled caches {decode input edge: tensor}."""
        B, P = prompt.shape
        bucket = self._bucket(P)
        net, g = self._prefill_net(bucket)
        ids = torch.zeros((B, bucket), dtype=torch.int32, device=self.device)
        ids[:, :P] = prompt
        out = net.prediction({"input": ids, "nreal": torch.full(
            (B,), P, dtype=torch.int32, device=self.device)})
        caches = {}
        for i in range(self.cfg.layers):
            node = g.nodes[f"pre_att_{i}"]
            caches[f"cache_k_{i}"] = out[node.outputs[1]]
            caches[f"cache_v_{i}"] = out[node.outputs[2]]
        return out[g.outputs[0]], caches

    def _step(self, token: torch.Tensor, pos: int, caches):
        """One decode step: logits [B, 1, V] and the updated caches."""
        feed = dict(caches)
        feed["input"] = token.reshape(self.batch, 1).to(torch.int32)
        feed["pos"] = torch.full((self.batch,), pos, dtype=torch.int32,
                                 device=self.device)
        out = self.decode_net.prediction(feed)
        return out[self._logits_edge], {k: out[e] for k, e in self._cache_edges}

    def generate(self, prompt, max_new_tokens: int = 16,
                 greedy: bool = True) -> np.ndarray:
        """prompt: [B, P] int -> [B, P + max_new_tokens] int32 (numpy).
        Every token is the argmax, whatever `greedy` says, as in the JAX
        package, which takes the argument and always takes the argmax."""
        prompt = torch.as_tensor(prompt).to(self.device, torch.int32)
        B, P = prompt.shape
        if B != self.batch:
            raise ValueError(f"prompt batch {B}, session batch {self.batch}")
        if P + max_new_tokens > self.cfg.max_seq:
            raise ValueError(f"{P} + {max_new_tokens} tokens exceed max_seq "
                             f"{self.cfg.max_seq}")
        logits, caches = self._prefill(prompt)
        tokens = [prompt]
        for t in range(max_new_tokens):
            nxt = torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32)
            tokens.append(nxt[:, None])
            logits, caches = self._step(nxt, P + t, caches)
        return torch.cat(tokens, dim=1).cpu().numpy()
