"""Profiling utilities: the port of `anakin_tpu/runtime/profiler.py`.

  * `trace(log_dir)` records a `torch.profiler` trace of the block (host
    ops and, on a GPU, the kernels) and writes it as a Chrome trace
    (`trace.json`, viewable in Perfetto or chrome://tracing).
  * `flops_estimate(graph)` gives the JAX package's analytic per-node
    FLOP/byte table, from `infer_shapes` on the meta device.
  * `roofline_report` sets a measured step time against those bounds.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Dict, Iterator

import torch

from ..graph.ir import Graph, topological_order
from ..graph.shape_infer import infer_shapes

__all__ = ["trace", "flops_estimate", "roofline_report",
           "H100_PEAK_INT8_OPS", "H100_HBM_BYTES_PER_S"]

# NVIDIA H100 SXM data sheet: dense int8 tensor-core rate and HBM3 bandwidth
H100_PEAK_INT8_OPS = 1979e12
H100_HBM_BYTES_PER_S = 3.35e12


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block; the trace goes to `log_dir/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _conv_flops(node, shapes) -> int:
    if node.op not in ("conv2d", "conv2d_int8", "dense", "dense_int8",
                       "matmul", "deconv2d"):
        return 0
    out = shapes[node.outputs[0]].shape
    w = shapes[node.inputs[1]].shape
    if node.op == "deconv2d":
        inp = shapes[node.inputs[0]].shape
        return 2 * math.prod(inp) * w[0] * w[1] * w[3]
    if node.op in ("conv2d", "conv2d_int8"):
        kh, kw, cin_g, cout = w
        return 2 * math.prod(out) * kh * kw * cin_g
    if node.op in ("dense", "dense_int8"):
        return 2 * math.prod(out) * w[0]
    if node.op == "matmul":
        a = shapes[node.inputs[0]].shape
        return 2 * math.prod(out) * a[-1]
    return 0


def flops_estimate(graph: Graph) -> Dict[str, Dict[str, float]]:
    """{node: {op, flops, bytes}} analytic cost table."""
    shapes = infer_shapes(graph)
    table: Dict[str, Dict[str, float]] = {}
    for node in topological_order(graph):
        byts = 0
        for e in list(node.inputs) + list(node.outputs):
            s = shapes[e]
            byts += math.prod(s.shape) * s.dtype.itemsize
        table[node.name] = {
            "op": node.op,
            "flops": float(_conv_flops(node, shapes)),
            "bytes": float(byts),
        }
    return table


def roofline_report(graph: Graph, step_seconds: float,
                    peak_flops: float = H100_PEAK_INT8_OPS,
                    hbm_bw: float = H100_HBM_BYTES_PER_S) -> str:
    """Summarize a measured step time against analytic compute/memory
    bounds.  Defaults are the H100 SXM's published peaks: 1,979 TOP/s int8
    (989 TFLOP/s bf16) and 3.35 TB/s HBM3."""
    table = flops_estimate(graph)
    flops = sum(v["flops"] for v in table.values())
    byts = sum(v["bytes"] for v in table.values())
    t_compute = flops / peak_flops
    t_memory = byts / hbm_bw
    bound = "compute" if t_compute > t_memory else "memory"
    util = (max(t_compute, t_memory) / step_seconds) if step_seconds else 0.0
    return (
        f"model: {flops/1e9:.1f} GFLOP, {byts/1e6:.1f} MB moved (analytic)\n"
        f"roofline: compute {t_compute*1e3:.3f} ms vs memory {t_memory*1e3:.3f} ms "
        f"-> {bound}-bound\n"
        f"measured: {step_seconds*1e3:.3f} ms -> {util*100:.1f}% of roofline"
    )
