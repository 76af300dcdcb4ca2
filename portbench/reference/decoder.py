"""The llama-class decoder in plain PyTorch, as the configuration serves it.

Each layer: RMSNorm (eps from the configuration), grouped-query attention
with rotary embeddings on interleaved pairs (base from the configuration)
and a causal mask, the output projection, a residual add; RMSNorm, a SwiGLU
MLP (up times silu(gate), then down), a residual add.  A final RMSNorm and
the untied output head give the logits.

What the configuration quantizes, worked out here from the float weights:

  * w4 weights (`weight_only` "w4", `w4_group` G) for the MLP's three
    matrices and the output head: one scale a column a group of G rows,
    amax / 7 (at least 1e-12), values rounded half to even and clipped to
    [-8, 7], dequantized as value times scale;
  * the int8 KV cache (`kv_cache_dtype` "int8", one static `kv_scale`):
    keys (after the rotary embedding) and values stored as round(x /
    scale) clipped to +-127 and read back times the scale.  The prompt's
    own attention reads the float keys and values (the prompt is scored in
    one pass); every later position reads the cache, its own row included.

`act_bits=8` is the lower-precision control: every product's activation
operand rounded to float8 (e4m3, one scale a row, amax / 448).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from . import no_tf32

__all__ = ["Decoder", "w4_dequant"]

W4_WEIGHTS = ("mlp_up", "mlp_gate", "mlp_down")


def w4_dequant(w: torch.Tensor, group: int) -> torch.Tensor:
    """w [K, N] float32 through symmetric int4 with one scale a group of
    `group` rows a column, and back."""
    K, N = w.shape
    wg = w.reshape(K // group, group, N)
    scale = torch.clamp_min(wg.abs().amax(dim=1) / 7.0, 1e-12)
    q = torch.clamp(torch.round(wg / scale[:, None, :]), -8, 7)
    return (q * scale[:, None, :]).reshape(K, N)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Decoder:
    """`Decoder(cfg, weights)`; `logits(tokens, n_prompt)` gives the logits
    at positions n_prompt - 1 .. len(tokens) - 1, [len - n_prompt + 1, V]:
    row j scores the token that follows position n_prompt - 1 + j.

    `weights`: `inputs.decoder_weights(cfg, seed, device)` (float32,
    kept as given: the w4 matrices are replaced by their dequantized
    values in a dict of this object's own)."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor],
                 act_bits: int = 16):
        self.cfg = cfg
        self.E, self.H = cfg["hidden_size"], cfg["num_attention_heads"]
        self.Hkv = cfg["num_key_value_heads"]
        self.D = self.E // self.H
        self.L = cfg["num_hidden_layers"]
        self.eps = float(cfg["rms_norm_eps"])
        self.theta = float(cfg["rope_theta"])
        self.kv_scale = float(cfg["kv_scale"])
        self.kv_int8 = cfg["kv_cache_dtype"] == "int8"
        self.act = _fp8 if act_bits == 8 else (lambda x: x)
        w4 = cfg.get("weight_only") == "w4"
        G = int(cfg.get("w4_group", 128))
        self.w = {}
        for k, v in weights.items():
            quant = w4 and (k == "lm_head" or k.split(".")[-1] in W4_WEIGHTS)
            self.w[k] = w4_dequant(v, G) if quant else v

    def _rms(self, x, g):
        return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True)
                               + self.eps) * g

    def _rope(self, x, pos):
        """x [T, heads, D], pos [T]: pairs (2i, 2i + 1) rotated by pos *
        theta^(-2i / D)."""
        D = x.shape[-1]
        freqs = 1.0 / (self.theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                                   device=x.device) / D))
        ang = pos.to(torch.float32)[:, None, None] * freqs
        c, s = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c],
                           dim=-1).reshape(x.shape)

    def _kv(self, t):
        if not self.kv_int8:
            return t
        s = self.kv_scale
        return torch.clamp(torch.round(t / s), -127, 127) * s

    def _attend(self, q, k, v):
        """Causal attention, q [T, H, D], k / v [T, Hkv, D] -> [T, H*D]."""
        T, rep = q.shape[0], self.H // self.Hkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        s = torch.einsum("thd,shd->hts", q, k) / math.sqrt(self.D)
        t = torch.arange(T, device=q.device)
        s = torch.where(t[None, :, None] >= t[None, None, :], s, -torch.inf)
        o = torch.einsum("hts,shd->thd", torch.softmax(s, dim=-1), v)
        return o.reshape(T, self.H * self.D)

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor, n_prompt: int) -> torch.Tensor:
        with no_tf32():
            return self._logits(tokens, n_prompt)

    def _logits(self, tokens, P):
        w, act = self.w, self.act
        T = tokens.shape[0]
        pos = torch.arange(T, device=tokens.device)
        x = w["embed"][tokens.to(torch.int64)]
        for i in range(self.L):
            h = act(self._rms(x, w[f"l{i}.ln1_g"]))
            q = self._rope((h @ w[f"l{i}.wq"]).reshape(T, self.H, self.D), pos)
            k = self._rope((h @ w[f"l{i}.wk"]).reshape(T, self.Hkv, self.D),
                           pos)
            v = (h @ w[f"l{i}.wv"]).reshape(T, self.Hkv, self.D)
            o = self._attend(q, k, v)
            if T > P:  # the positions after the prompt read the cache
                o[P:] = self._attend(q, self._kv(k), self._kv(v))[P:]
            x = x + act(o) @ w[f"l{i}.wo"]
            h = act(self._rms(x, w[f"l{i}.ln2_g"]))
            up = h @ w[f"l{i}.mlp_up"]
            gate = h @ w[f"l{i}.mlp_gate"]
            x = x + act(up * (gate * torch.sigmoid(gate))) @ w[f"l{i}.mlp_down"]
        hf = act(self._rms(x[P - 1:], w["lnf_g"]))
        return hf @ w["lm_head"]
