"""Activation calibration (abs-max and KL-divergence) and the scale-table
IO: the port of `anakin_tpu/quant/calibrator.py`.

The histogram and KL arithmetic (`get_ref_q`, `expand_to_q`,
`kl_divergence`, `EntropyCalibrator`) is numpy and is copied as it is, so
both packages bin the same float32 values into the same bins.  `calibrate`
runs the port's `build_forward` on the device and moves each tapped edge to
the host for that arithmetic:

  * pass 1: run all calibration batches, track per-tensor running abs-max
  * pass 2: re-run them, accumulate a 2048-bin histogram of |x| with
    step = max / 2048 and the top bin absorbing the tail
  * threshold sweep: for every candidate threshold i in [129, 2047): clip
    the histogram at i bins (outliers fold into the last bin), shrink it to
    a 128-bin reference Q, expand Q back to i bins spreading mass only over
    the non-zero bins, and take KL(hist || q) in log2 with the last q bin
    spread across the remaining tail; pick the argmin threshold.

`method="max"` gives scale = max / 127 for every tensor (the reference's
shipped behaviour); `method="entropy"` uses the KL-argmin threshold.

Scale convention: scale = threshold_value / 127, int8 = round(x / scale).
The scale table is "name scale" text lines, the JAX package's format.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..convert import params_from_numpy
from ..graph.ir import Graph, topological_order
from ..runtime.net import Net, _resolve_device, _to_device, build_forward

__all__ = [
    "EntropyCalibrator",
    "calibrate",
    "calibrate_kv_scales",
    "write_scale_table",
    "read_scale_table",
    "get_ref_q",
    "expand_to_q",
    "kl_divergence",
]

BIN_NUM = 2048
QUANT_BINS = 128


def get_ref_q(ref_p: np.ndarray, q_size: int = QUANT_BINS) -> np.ndarray:
    """Shrink `ref_p` (len N histogram) into `q_size` fractional bins.

    Exact port of `EntropyCalibrator::get_ref_q`: bin i of the output sums
    ref_p over [step*i, step*(i+1)) with fractional edge weights.  The
    closed form is the difference of the fractional cumulative sum.
    """
    p = np.asarray(ref_p, np.float64)
    n = p.size
    step = n / q_size
    # G(x) = sum_{j < floor(x)} p[j] + frac(x) * p[floor(x)]
    csum = np.concatenate([[0.0], np.cumsum(p)])

    def G(x: np.ndarray) -> np.ndarray:
        f = np.floor(x).astype(np.int64)
        f = np.minimum(f, n - 1)
        return csum[f] + (x - f) * p[f]

    edges = step * np.arange(q_size + 1)
    edges[-1] = n  # exact top edge
    g = G(edges)
    return (g[1:] - g[:-1]).astype(np.float64)


def expand_to_q(ref_p: np.ndarray, ref_q: np.ndarray) -> np.ndarray:
    """Expand `ref_q` back to len(ref_p) bins, spreading each Q bin's mass
    uniformly over the *non-zero* bins of ref_p it covers (fractional edges
    weighted).  Exact port of `EntropyCalibrator::expand_to_q`, vectorized
    over the Q bins (the scalar loop made the 2048-threshold sweep
    minutes-per-tensor; this form is golden-tested against the literal
    transcription in tests/test_quant.py)."""
    p = np.asarray(ref_p, np.float64)
    n = p.size
    qn = ref_q.size
    coeff = n / qn
    nz = (p != 0)
    nzf = nz.astype(np.float64)

    i = np.arange(qn, dtype=np.float64)
    start = i * coeff
    end = (i + 1) * coeff
    s_floor = np.floor(start).astype(np.int64)
    s_ceil = np.ceil(start).astype(np.int64)
    e_floor = np.floor(end).astype(np.int64)
    e_floor_c = np.minimum(e_floor, n - 1)
    # zeros strictly inside [s_ceil, e_floor) via a cumulative zero count
    zcum = np.concatenate([[0.0], np.cumsum(1.0 - nzf)])
    zero_num = zcum[np.minimum(e_floor, n)] - zcum[np.minimum(s_ceil, n)]
    zero_num += np.where(~nz[s_floor], s_ceil - start, 0.0)
    zero_num += np.where(~nz[e_floor_c], end - e_floor, 0.0)
    dis = coeff - zero_num
    ok = dis > 0
    share = np.where(ok, np.asarray(ref_q, np.float64)
                     / np.where(ok, dis, 1.0), 0.0)

    q = np.zeros(n, np.float64)
    # fractional start edge: q[s_floor] += (s_ceil - start) * share
    np.add.at(q, s_floor, np.where(nz[s_floor],
                                   (s_ceil - start) * share, 0.0))
    # interior whole bins [s_ceil, e_floor): piecewise-constant scatter via
    # a difference array, masked by nz after the cumsum
    diff = np.zeros(n + 1, np.float64)
    np.add.at(diff, np.minimum(s_ceil, n), share)
    np.add.at(diff, np.minimum(e_floor, n), -share)
    q += nzf * np.cumsum(diff[:-1])
    # fractional end edge: q[e_floor_c] += (end - e_floor) * share
    np.add.at(q, e_floor_c, np.where(nz[e_floor_c],
                                     (end - e_floor) * share, 0.0))
    return q


def kl_divergence(hist: np.ndarray, q: np.ndarray) -> float:
    """KL(hist ‖ q) in log2, with q's last bin spread over hist's tail.

    Exact port of `EntropyCalibrator::get_kl_divergence` including its
    integer truncation of sum_q (`int sum_q` accumulating float q bins).
    """
    h = np.asarray(hist, np.float64)
    qq = np.asarray(q, np.float64)
    sum_p = float(h.sum())
    sum_q = float(int(qq.sum()))  # matches the reference's int accumulator
    if sum_p == 0 or sum_q == 0:
        return float("inf")
    m = qq.size
    kl = 0.0
    body_p = h[: m - 1]
    body_q = qq[: m - 1]
    mask = (body_p != 0) & (body_q != 0)
    if mask.any():
        pp = body_p[mask] / sum_p
        pq = body_q[mask] / sum_q
        kl += float(np.sum(pp * np.log2(pp / pq)))
    tail_q_prob = (qq[m - 1] / sum_q) / (h.size - m + 1)
    tail_p = h[m - 1:]
    tmask = tail_p > 0
    if tmask.any() and tail_q_prob > 0:
        pp = tail_p[tmask] / sum_p
        kl += float(np.sum(pp * np.log2(pp / tail_q_prob)))
    return kl


class EntropyCalibrator:
    """Streaming two-pass calibrator over named tensors."""

    def __init__(self, names: Sequence[str], bin_num: int = BIN_NUM):
        self.names = list(names)
        self.bin_num = bin_num
        self.max_vec = {n: 0.0 for n in self.names}
        self.hists = {n: np.zeros(bin_num, np.int64) for n in self.names}

    # pass 1
    def observe_max(self, name: str, value: np.ndarray) -> None:
        v = float(np.max(np.abs(value))) if value.size else 0.0
        if v > self.max_vec[name]:
            self.max_vec[name] = v

    # pass 2
    def observe_hist(self, name: str, value: np.ndarray) -> None:
        mx = self.max_vec[name]
        if mx == 0.0:
            return
        step = mx / self.bin_num
        ids = np.minimum(
            (np.abs(np.asarray(value, np.float32)) / step).astype(np.int64),
            self.bin_num - 1,
        )
        self.hists[name] += np.bincount(ids.ravel(), minlength=self.bin_num)

    def kl_threshold(self, name: str) -> int:
        """Sweep thresholds, return argmin-KL bin index (reference
        `get_kl_threshold` loop, `:320-346`)."""
        hist = self.hists[name]
        best_kl, best_i = float("inf"), self.bin_num - 2
        total = int(hist.sum()) - int(hist[0])
        start_num = int(hist[1:129].sum())
        for i in range(129, self.bin_num - 1):
            ref_p = hist[1: i + 1].astype(np.float64).copy()
            outlier = total - start_num
            ref_p[i - 1] += outlier
            ref_q = get_ref_q(ref_p, QUANT_BINS)
            q = expand_to_q(ref_p, ref_q)
            kl = kl_divergence(hist, q)
            if kl < best_kl:
                best_kl, best_i = kl, i
            start_num += int(hist[i])
        return best_i

    def scales(self, method: str = "entropy") -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n in self.names:
            mx = self.max_vec[n]
            if mx == 0.0:
                out[n] = 1.0
                continue
            if method == "max":
                # shipped reference behavior: max/(127*bins)*bins == max/127
                out[n] = mx / 127.0
            elif method == "entropy":
                thresh = self.kl_threshold(n)
                out[n] = mx / (127.0 * self.bin_num) * thresh
            else:
                raise ValueError(f"unknown calibration method {method!r}")
        return out


def calibrate(
    graph: Graph,
    batches,
    method: str = "entropy",
    edges: Optional[Sequence[str]] = None,
    edge_chunk: Optional[int] = None,
    device=None,
) -> Dict[str, float]:
    """Run calibration batches through the graph, return {edge: scale}.

    A streaming two-pass algorithm, as in the JAX package: pass 1 runs
    every batch observing per-tensor abs-max, pass 2 runs them again
    accumulating histograms.  The forward runs in float32 on `device`
    (None means CUDA, and raises without a GPU; pass "cpu" for the CPU);
    each tapped edge is moved to the host on its own and dropped, so host
    memory stays O(one edge).

    `batches`: a sequence of feed dicts, or a zero-arg callable returning a
    fresh iterator per pass.

    `edge_chunk`: tap only `edge_chunk` edges per forward, bounding the
    device memory the taps hold (at the cost of re-running the forward per
    chunk).
    """
    dev = _resolve_device(device)
    if callable(batches):
        batch_factory = batches
    else:
        _batches = list(batches)

        def batch_factory():
            return iter(_batches)

    if edges is None:
        edges = list(graph.inputs)
        for node in topological_order(graph):
            edges.extend(node.outputs)
    edges = list(edges)
    if edge_chunk is None or edge_chunk >= len(edges):
        chunks = [edges]
    else:
        chunks = [edges[i:i + edge_chunk]
                  for i in range(0, len(edges), edge_chunk)]
    runs = [(chunk, build_forward(graph, precision="fp32", tap_edges=chunk)[0])
            for chunk in chunks]
    # one device-resident weight copy shared by both passes and all chunks
    params = params_from_numpy(graph.params, dev)

    calib = EntropyCalibrator(edges)
    for pass_fn in (calib.observe_max, calib.observe_hist):
        for feed in batch_factory():
            feed = {k: _to_device(v, dev) for k, v in feed.items()}
            for chunk, run in runs:
                with torch.inference_mode():
                    out = run(params, feed)
                for e in chunk:
                    t = out.pop(e, None)
                    if t is not None and t.is_floating_point():
                        # one edge at a time to the host, then dropped
                        pass_fn(e, t.cpu().numpy())
                    del t
                del out
    calib.names = [e for e in edges if calib.max_vec[e] > 0.0]
    return calib.scales(method)


def write_scale_table(scales: Dict[str, float], path: str) -> None:
    """Text "name scale" lines — same sidecar format as the reference."""
    with open(path, "w") as f:
        for k in sorted(scales):
            f.write(f"{k} {scales[k]:f}\n")


def read_scale_table(path: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out[parts[0]] = float(parts[1])
    return out


def calibrate_kv_scales(cfg, params, prompts, margin: float = 1.0,
                        device=None):
    """Per-layer (k_scale, v_scale) for int8 KV caches.

    Runs the float32 prefill graph over sample prompts on `device` (None
    means CUDA, and raises without a GPU) and takes amax/127 of each
    layer's emitted K/V rows.  `prompts`: iterable of [B, P] int32 arrays
    (P may vary).  Returns [(k_scale, v_scale), ...] per layer for the
    builders' `kv_scale=` argument.
    """
    from ..models.transformer import build_transformer_prefill

    dev = _resolve_device(device)
    amax_k = [0.0] * cfg.layers
    amax_v = [0.0] * cfg.layers
    nets = {}
    for prompt in prompts:
        prompt = np.asarray(prompt, np.int32)
        B, P = prompt.shape
        if (B, P) not in nets:
            g = build_transformer_prefill(cfg, B, P, params)
            nets[(B, P)] = (Net(g, device=dev), g)
        net, g = nets[(B, P)]
        out = net.prediction({"input": prompt})
        for i in range(cfg.layers):
            node = g.nodes[f"pre_att_{i}"]
            k = out[node.outputs[1]][:, :, :P]
            v = out[node.outputs[2]][:, :, :P]
            amax_k[i] = max(amax_k[i], float(k.abs().max()))
            amax_v[i] = max(amax_v[i], float(v.abs().max()))
    return [(max(a, 1e-6) * margin / 127.0, max(b, 1e-6) * margin / 127.0)
            for a, b in zip(amax_k, amax_v)]
