"""Sequence ops over padded [B, T, ...] activations with a `lengths` [B]
int32 edge (`anakin_tpu/ops/sequence.py`).  Only `sequence_pool` is on a
ported path: the LLM prefill picks each row's last real position with it."""

from __future__ import annotations

from typing import List

import torch

from .registry import register


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
        idx = torch.clamp_min(lens - 1, 0)
        y = xf[torch.arange(B, device=x.device), idx]
    elif mode == "first":
        y = xf[:, 0]
    else:
        raise ValueError(f"unknown sequence_pool mode {mode!r}")
    return [y.to(x.dtype)]
