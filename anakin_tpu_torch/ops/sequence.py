"""Sequence and RNN ops over padded [B, T, ...] activations with a
`lengths` [B] int32 edge: the port of `anakin_tpu/ops/sequence.py`.

The JAX package's time loops are `lax.scan`s; here they are Python loops
over the static T, so that `Net.compile` captures a whole RNN forward in one
CUDA graph: no op reads a tensor on the host, masks and constants are made
on the device, selections are `gather` / `index_select`.  Every product runs
in float32 with TF32 off (`full_fp32`), as the JAX ops' float32 dots at
"highest" precision do, whatever the activations' dtype; outputs are cast
back to x's dtype.

The LSTM and GRU steps add in the JAX order: dot(x_t, w_ih) + dot(h, w_hh),
then the bias.  The input product is hoisted out of the time loop as one
[B T, D] x [D, G H] product; only the order of its sums changes.

Gate layouts (as the JAX package documents them):
  LSTM: w_ih [D, 4H], w_hh [H, 4H], b [4H], gate order (i, f, g, o)
  GRU:  w_ih [D, 3H], w_hh [H, 3H], b [3H], gate order (r, z, n)

Quirks of the reference, copied so that the results are equal:
  * with `reverse`, `lstm` and `gru` flip x, scan it with the unflipped
    length mask, flip the outputs back and zero them past the length;
  * `lstmp` ignores `reverse`;
  * `crf_decoding` takes `lengths` and does not use it: every row is decoded
    over all T;
  * `sequence_pool_concat` ignores lengths;
  * `attention_lstm` does not zero its outputs past the length; a row of
    length 0 softmaxes over all -inf and gives NaN.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .nn import full_fp32
from .registry import register


def _time_mask(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """[B, T] validity mask from lengths."""
    t = torch.arange(T, dtype=torch.int32, device=lengths.device)[None, :]
    return t < lengths.to(torch.int32)[:, None]


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.to(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in float32 with TF32 off."""
    with full_fp32():
        return torch.matmul(a, b)


def _rnn_inputs(node, xs, n_weights: int):
    """(x, the weights, bias or None, lengths or None) by the node's
    `has_bias` / `has_lengths` flags."""
    it = iter(xs)
    x = next(it)
    ws = [next(it) for _ in range(n_weights)]
    b = next(it) if node.attr("has_bias", True) else None
    lengths = next(it) if node.attr("has_lengths", False) else None
    return x, ws, b, lengths


def _lstm_cell(gx_t, h, c, w_hh, b):
    """One LSTM step from the input's gate product gx_t = x_t @ w_ih:
    (h, c) after it, in float32."""
    gates = gx_t + _mm(h, w_hh)
    if b is not None:
        gates = gates + b
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def _gate_products(xf: torch.Tensor, w_ih: torch.Tensor) -> torch.Tensor:
    """x [B, T, D] @ w_ih [D, G] for every step at once: [B, T, G]."""
    B, T, D = xf.shape
    return _mm(xf.reshape(B * T, D), w_ih).reshape(B, T, -1)


def _finish(ys: List[torch.Tensor], x: torch.Tensor, mask, reverse: bool):
    """The step outputs stacked to [B, T, ...], flipped back with
    `reverse`, zeroed past the length, in x's dtype."""
    y = torch.stack(ys, dim=1)
    if reverse:
        y = torch.flip(y, dims=(1,))
    if mask is not None:
        y = torch.where(mask[:, :, None], y, torch.zeros((), dtype=y.dtype,
                                                         device=y.device))
    return y.to(x.dtype)


@register("lstm")
def lstm(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Masked batched LSTM over padded [B, T, D].  inputs: x, w_ih, w_hh,
    [bias], [lengths]; attrs: reverse, has_bias, has_lengths.  Output: the
    hidden sequence [B, T, H], zero past each length; a masked step carries
    h and c forward."""
    x, (w_ih, w_hh), b, lengths = _rnn_inputs(node, xs, 2)
    B, T, _ = x.shape
    H = w_hh.shape[0]
    reverse = bool(node.attr("reverse", False))
    xf = x.to(torch.float32)
    if reverse:
        xf = torch.flip(xf, dims=(1,))
    mask = _time_mask(lengths, T) if lengths is not None else None
    gx = _gate_products(xf, _f32(w_ih))
    w_hh, b = _f32(w_hh), _f32(b)
    h = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    c = torch.zeros_like(h)
    ys = []
    for t in range(T):
        h_new, c_new = _lstm_cell(gx[:, t], h, c, w_hh, b)
        if mask is not None:
            m = mask[:, t:t + 1]
            h_new = torch.where(m, h_new, h)
            c_new = torch.where(m, c_new, c)
        h, c = h_new, c_new
        ys.append(h)
    return [_finish(ys, x, mask, reverse)]


@register("lstmp")
def lstmp(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """LSTM with a recurrent projection.  inputs: x, w_ih [D, 4H], w_hh
    [P, 4H], w_proj [H, P], [bias], [lengths].  Output: the projected
    sequence [B, T, P], zero past each length (`reverse` is not read, as in
    the reference)."""
    x, (w_ih, w_hh, w_proj), b, lengths = _rnn_inputs(node, xs, 3)
    B, T, _ = x.shape
    H, P = w_proj.shape
    mask = _time_mask(lengths, T) if lengths is not None else None
    gx = _gate_products(x.to(torch.float32), _f32(w_ih))
    w_hh, w_proj, b = _f32(w_hh), _f32(w_proj), _f32(b)
    p = torch.zeros((B, P), dtype=torch.float32, device=x.device)
    c = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        h_new, c_new = _lstm_cell(gx[:, t], p, c, w_hh, b)
        p_new = _mm(h_new, w_proj)
        if mask is not None:
            m = mask[:, t:t + 1]
            p_new = torch.where(m, p_new, p)
            c_new = torch.where(m, c_new, c)
        p, c = p_new, c_new
        ys.append(p)
    return [_finish(ys, x, mask, False)]


@register("gru", "standard_rnn")
def gru(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Masked batched GRU, gate order (r, z, n): n = tanh(i_n + r * h_n),
    h = (1 - z) n + z h.  Inputs and attrs as `lstm`'s."""
    x, (w_ih, w_hh), b, lengths = _rnn_inputs(node, xs, 2)
    B, T, _ = x.shape
    H = w_hh.shape[0]
    reverse = bool(node.attr("reverse", False))
    xf = x.to(torch.float32)
    if reverse:
        xf = torch.flip(xf, dims=(1,))
    mask = _time_mask(lengths, T) if lengths is not None else None
    gx = _gate_products(xf, _f32(w_ih))
    if b is not None:
        gx = gx + _f32(b)
    w_hh = _f32(w_hh)
    h = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        i_r, i_z, i_n = torch.chunk(gx[:, t], 3, dim=-1)
        h_r, h_z, h_n = torch.chunk(_mm(h, w_hh), 3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h_new = (1 - z) * n + z * h
        if mask is not None:
            h_new = torch.where(mask[:, t:t + 1], h_new, h)
        h = h_new
        ys.append(h)
    return [_finish(ys, x, mask, reverse)]


@register("sequence_pool")
def sequence_pool(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Pool over the time axis (dim 1) with length masking.  modes:
    average, sum, sqrt, max, last, first.  A row of length 0 counts as
    length 1 for the averages, gives 0 for max and row 0 for last."""
    x = xs[0]
    B, T = x.shape[0], x.shape[1]
    lengths = (xs[1] if len(xs) > 1 else
               torch.full((B,), T, dtype=torch.int32, device=x.device))
    mode = node.attr("mode", "average")
    xf = x.to(torch.float32)
    lens = lengths.to(torch.int64)
    valid = torch.arange(T, device=x.device)[None, :] < lens[:, None]
    m = valid.to(torch.float32).reshape((B, T) + (1,) * (x.dim() - 2))
    cnt = torch.clamp_min(lens.to(torch.float32), 1.0).reshape(
        (B,) + (1,) * (x.dim() - 2))
    if mode in ("average", "avg", "mean"):
        y = torch.sum(xf * m, dim=1) / cnt
    elif mode == "sum":
        y = torch.sum(xf * m, dim=1)
    elif mode == "sqrt":
        y = torch.sum(xf * m, dim=1) / torch.sqrt(cnt)
    elif mode == "max":
        y = torch.amax(torch.where(m > 0, xf, float("-inf")), dim=1)
        y = torch.where(torch.isfinite(y), y, torch.zeros_like(y))
    elif mode == "last":
        idx = torch.clamp_min(lens - 1, 0).reshape((B, 1) + (1,) * (x.dim() - 2))
        y = torch.gather(xf, 1, idx.expand((B, 1) + tuple(x.shape[2:])))[:, 0]
    elif mode == "first":
        y = xf[:, 0]
    else:
        raise ValueError(f"unknown sequence_pool mode {mode!r}")
    return [y.to(x.dtype)]


@register("sequence_concat")
def sequence_concat(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Feature-wise concat of aligned sequences."""
    return [torch.cat(xs, dim=-1)]


@register("seq_concat_seq_pool_soft_sign")
def seq_concat_seq_pool_soft_sign(node, xs: List[torch.Tensor]
                                  ) -> List[torch.Tensor]:
    """Fused feature concat, sum over the valid steps (all T without
    `has_lengths`), then soft_sign y / (1 + |y|), in float32."""
    has_lengths = node.attr("has_lengths", False)
    feats = xs[:-1] if has_lengths else xs
    x = torch.cat(feats, dim=-1)
    xf = x.to(torch.float32)
    if has_lengths:
        m = _time_mask(xs[-1], x.shape[1])[..., None].to(torch.float32)
        y = torch.sum(xf * m, dim=1)
    else:
        y = torch.sum(xf, dim=1)
    return [(y / (1.0 + torch.abs(y))).to(x.dtype)]


@register("sequence_expand")
def sequence_expand(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """x [B, D] repeated over the steps of a reference sequence [B, T, ...]:
    [B, T, D]."""
    x, ref = xs[0], xs[1]
    return [x[:, None, :].expand(x.shape[0], ref.shape[1],
                                 x.shape[-1]).contiguous()]


@register("sequence_conv")
def sequence_conv(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """1-D context-window conv over time: the `context_length` steps from
    `context_start` on (zeros past either end), concatenated feature-wise,
    @ w [context_length D, O] (+ b), in float32."""
    it = iter(xs)
    x, w = next(it), next(it)
    b = next(it) if node.attr("has_bias", False) else None
    ctx_len = int(node.attr("context_length", 3))
    ctx_start = int(node.attr("context_start", -(ctx_len // 2)))
    B, T, D = x.shape
    t = torch.arange(T, device=x.device)[None, :, None]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    cols = []
    for k in range(ctx_len):
        off = ctx_start + k
        shifted = torch.roll(x, -off, dims=1)
        m = t >= -off if off < 0 else t < T - off
        cols.append(torch.where(m, shifted, zero))
    xc = torch.cat(cols, dim=-1).to(torch.float32)
    y = _mm(xc, w.to(x.dtype).to(torch.float32))
    if b is not None:
        y = y + b
    return [y.to(x.dtype)]


@register("sequence_pool_concat")
def sequence_pool_concat(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each sequence pooled over all T (sum, average, else max; lengths are
    not read, as in the reference), then concatenated feature-wise."""
    mode = node.attr("mode", "sum")
    pooled = []
    for x in xs:
        xf = x.to(torch.float32)
        if mode == "sum":
            pooled.append(torch.sum(xf, dim=1))
        elif mode in ("average", "avg"):
            pooled.append(torch.mean(xf, dim=1))
        else:
            pooled.append(torch.amax(xf, dim=1))
    return [torch.cat(pooled, dim=-1).to(xs[0].dtype)]


@register("reverse_sequence")
def reverse_sequence(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each sequence reversed within its valid length (the steps past it
    stay where they are); the whole time axis without lengths."""
    x = xs[0]
    if len(xs) < 2:
        return [torch.flip(x, dims=(1,))]
    B, T = x.shape[0], x.shape[1]
    t = torch.arange(T, dtype=torch.int64, device=x.device)[None, :]
    L = xs[1].to(torch.int64)[:, None]
    src = torch.where(t < L, L - 1 - t, t)
    if x.dim() == 3:
        src = src[..., None].expand(B, T, x.shape[2])
    return [torch.gather(x, 1, src)]


@register("crf_decoding")
def crf_decoding(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Viterbi decode.  inputs: emission [B, T, N], transition [N + 2, N]
    (row 0 start, row 1 end, rows 2.. the transitions), [lengths] (not
    read: every row is decoded over all T, as in the reference).  Output:
    the best label path [B, T] int32; ties go to the lower label, as
    `jnp.argmax` takes the first maximum."""
    x, w = xs[0], xs[1].to(torch.float32)
    T = x.shape[1]
    start, end, trans = w[0], w[1], w[2:]
    xf = x.to(torch.float32)
    alpha = xf[:, 0] + start[None, :]
    backptrs = []
    for t in range(1, T):
        # scores[b, i, j] = alpha[b, i] + trans[i, j]
        scores = alpha[:, :, None] + trans[None, :, :]
        backptrs.append(torch.argmax(scores, dim=1))
        alpha = torch.amax(scores, dim=1) + xf[:, t]
    lab = torch.argmax(alpha + end[None, :], dim=-1)       # label at T - 1
    path = [lab]
    for bp in reversed(backptrs):
        lab = torch.gather(bp, 1, lab[:, None])[:, 0]
        path.append(lab)
    return [torch.stack(path[::-1], dim=1).to(torch.int32)]


@register("attention_lstm", "attension_lstm")
def attention_lstm(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Attention-weighted LSTM: at each step an MLP over [x, h] scores the
    input steps (tanh([x, h] @ att_w) @ att_v, -inf past the length), their
    softmax weights the inputs into one vector, and that feeds an LSTM cell.
    inputs: x [B, T, D], att_w [D + H, A], att_v [A, 1], w_ih [D, 4H], w_hh
    [H, 4H], [bias], [lengths].  Output [B, T, H], not zeroed past the
    length (as in the reference)."""
    x, (att_w, att_v, w_ih, w_hh), b, lengths = _rnn_inputs(node, xs, 4)
    B, T, _ = x.shape
    H = w_hh.shape[0]
    xf = x.to(torch.float32)
    att_w, att_v, w_ih, w_hh, b = (_f32(v) for v in (att_w, att_v, w_ih,
                                                     w_hh, b))
    mask = (_time_mask(lengths, T) if lengths is not None else
            torch.ones((B, T), dtype=torch.bool, device=x.device))
    neg_inf = torch.full((), float("-inf"), device=x.device)
    h = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    c = torch.zeros_like(h)
    ys = []
    for _ in range(T):
        feat = torch.cat([xf, h[:, None, :].expand(B, T, H)], dim=-1)
        e = _mm(torch.tanh(_mm(feat, att_w)), att_v)[..., 0]
        a = torch.softmax(torch.where(mask, e, neg_inf), dim=-1)
        ctx = _mm(a[:, None, :], xf)[:, 0]
        h, c = _lstm_cell(_mm(ctx, w_ih), h, c, w_hh, b)
        ys.append(h)
    return [torch.stack(ys, dim=1).to(x.dtype)]


@register("attention_padding_mask")
def attention_padding_mask(node, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Attention logits [B, Tq, Tk] set to `mask` (-9e4) at the key steps
    past each length."""
    x, lengths = xs[0], xs[1]
    m = _time_mask(lengths, x.shape[2])[:, None, :]
    return [torch.where(m, x, float(node.attr("mask", -9e4)))]
