"""INT8-vs-FP32 accuracy harness: the port of `anakin_tpu/tools/accuracy.py`,
over the port's `Net` (on CUDA unless `device` says otherwise), with the
outputs read back as float32 on the host.

Parity with the reference's accuracy harnesses
(`test/framework/net/model_int8_accuracy.cpp`,
`classification_accuracy.cpp`): run the same inputs through the fp32 and
int8 nets and report top-1/top-5 agreement and the top-1 delta — the
BASELINE.json target is INT8 top-1 within 0.5% of FP32.

Without an offline ImageNet, inputs are a deterministic synthetic set;
with real labeled data pass `labels` to get absolute accuracy too.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np

from .. import Net
from ..graph.ir import Graph

__all__ = ["compare_accuracy"]


def compare_accuracy(
    graph_fp32: Graph,
    graph_int8: Graph,
    batches: Iterable[Dict[str, np.ndarray]],
    labels: Optional[Iterable[np.ndarray]] = None,
    precision: str = "fp32",
    device=None,
) -> Dict[str, float]:
    net_fp = Net(graph_fp32, precision=precision, device=device)
    net_q = Net(graph_int8, precision=precision, device=device)
    out_fp = graph_fp32.outputs[0]
    out_q = graph_int8.outputs[0]
    n = 0
    top1_agree = 0
    top5_overlap = 0.0
    fp_correct = 0
    q_correct = 0
    labels = list(labels) if labels is not None else None
    for i, feed in enumerate(batches):
        y_fp = net_fp.prediction(feed)[out_fp].float().cpu().numpy()
        y_q = net_q.prediction(feed)[out_q].float().cpu().numpy()
        a1 = y_fp.argmax(-1)
        b1 = y_q.argmax(-1)
        top1_agree += int((a1 == b1).sum())
        for r in range(y_fp.shape[0]):
            t5a = set(np.argsort(-y_fp[r])[:5])
            t5b = set(np.argsort(-y_q[r])[:5])
            top5_overlap += len(t5a & t5b) / 5.0
        if labels is not None:
            lab = labels[i]
            fp_correct += int((a1 == lab).sum())
            q_correct += int((b1 == lab).sum())
        n += y_fp.shape[0]
    result = {
        "samples": n,
        "top1_agreement": top1_agree / n,
        "top5_overlap": top5_overlap / n,
    }
    if labels is not None:
        result["fp32_top1"] = fp_correct / n
        result["int8_top1"] = q_correct / n
        result["top1_delta"] = result["fp32_top1"] - result["int8_top1"]
    return result
