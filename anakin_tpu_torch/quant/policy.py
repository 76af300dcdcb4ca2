"""Per-(model, batch) precision policy: the port of
`anakin_tpu/quant/policy.py`.

`choose_precision` decides "int8" or "bf16" for a conv graph at a serving
batch size; `apply_precision_policy` is the serving entry point that builds
the graph the decision implies.  The rules:

  * depthwise-dominated nets (MobileNet class: at least a third of the
    convs depthwise) take bf16 below `INT8_DEPTHWISE_MIN_BATCH`;
  * detection graphs (YOLO/SSD/RCNN heads) take bf16 below
    `INT8_DETECTION_MIN_BATCH`;
  * other conv nets served one dispatch per request (`dispatch_bound`)
    take bf16 while the analytic compute per dispatch is below
    `INT8_DISPATCH_MIN_GFLOPS`; callers that amortize dispatch pass
    `dispatch_bound=False` and get int8 at every batch.

The three thresholds are the JAX package's, kept so that both packages
decide alike (tests/test_torch_quant.py checks it).  They come from that
package's own measurements on its own hardware and have not been
re-measured on an H100 (ROADMAP; PERF.md, open questions).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["is_depthwise_dominated", "is_detection_graph",
           "choose_precision", "apply_precision_policy",
           "INT8_DEPTHWISE_MIN_BATCH", "INT8_DETECTION_MIN_BATCH",
           "INT8_DISPATCH_MIN_GFLOPS"]

# The JAX package's thresholds, not re-measured on an H100.
INT8_DEPTHWISE_MIN_BATCH = 4
INT8_DISPATCH_MIN_GFLOPS = 100.0
INT8_DETECTION_MIN_BATCH = 16

_DETECTION_OPS = frozenset({
    "priorbox", "detection_output", "yolo_box", "roi_align", "roi_pool",
    "ps_roi_pooling", "sroi_align", "anchor_generator", "box_coder",
    "box_clip", "rcnn_detection_output", "generate_proposals",
    "rcnn_proposal", "rpn_proposal_ssd", "sproposal"})


def is_detection_graph(graph) -> bool:
    """True when the graph carries detection-head ops (YOLO/SSD/RCNN
    class) — the workload family where int8's batch crossover is late."""
    return any(n.op in _DETECTION_OPS for n in graph.nodes.values())


def is_depthwise_dominated(graph) -> bool:
    """True when >=1/3 of the graph's convs are depthwise (MobileNet
    class).  Depthwise = grouped conv with one input channel per group."""
    convs = dw = 0
    for node in graph.nodes.values():
        if node.op != "conv2d":
            continue
        convs += 1
        groups = int(node.attr("groups", 1))
        w = graph.params.get(node.inputs[1])
        if w is None or groups <= 1:
            continue
        cin = w.shape[2] * groups
        if groups == cin:
            dw += 1
    return convs > 0 and dw * 3 >= convs


def _dispatch_gflops(graph, batch: int) -> float:
    """Analytic compute per dispatch at the given serving batch (from the
    graph's own resolution and batch, scaled to `batch`)."""
    from ..runtime.profiler import flops_estimate

    total = sum(v["flops"] for v in flops_estimate(graph).values())
    spec = graph.input_specs.get("input")
    graph_batch = spec[0][0] if spec else 1
    return total / max(1, graph_batch) * batch / 1e9


def choose_precision(graph, batch: int, dispatch_bound: bool = True) -> str:
    """"int8" or "bf16" for a conv graph at this serving batch size (the
    rules are in the module docstring)."""
    if is_depthwise_dominated(graph) and batch < INT8_DEPTHWISE_MIN_BATCH:
        return "bf16"
    if is_detection_graph(graph) and batch < INT8_DETECTION_MIN_BATCH:
        return "bf16"
    if dispatch_bound and not is_depthwise_dominated(graph) \
            and not is_detection_graph(graph) \
            and _dispatch_gflops(graph, batch) < INT8_DISPATCH_MIN_GFLOPS:
        return "bf16"
    return "int8"


def apply_precision_policy(graph, batch: int,
                           scales: Optional[Dict[str, np.ndarray]] = None,
                           dispatch_bound: bool = True):
    """Serving entry point: return (graph, "int8" or "bf16"), the graph
    quantized or not per the policy.

    With `scales=None` an int8 decision falls back to bf16 (no calibration
    data -> no int8), so callers can pass whatever they have.
    """
    if "quantize_graph" in graph.applied_passes:
        return graph, "int8"  # already quantized upstream
    decision = choose_precision(graph, batch, dispatch_bound)
    if decision == "int8" and scales is not None:
        from .quantize import quantize_graph

        return quantize_graph(graph, scales), "int8"
    return graph, "bf16"
