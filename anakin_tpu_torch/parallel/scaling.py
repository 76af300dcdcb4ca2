"""Scaling model of a sharded step: the port of `anakin_tpu/parallel/scaling.py`.

The JAX harness parses the collectives GSPMD put into the compiled HLO.
The port's collectives are the ones its executor issues, so they are read
from the mesh's record of the step (`Mesh.records`: kind, dtype, shape,
result bytes, group size) and priced with the same ring formulas, over a
group of N ranks:

  all-reduce:          2 * (N-1)/N * result_bytes
  all-gather:              (N-1)/N * result_bytes     (result = gathered)
  reduce-scatter:          (N-1)   * result_bytes     (result = shard)
  all-to-all:              (N-1)/N * result_bytes
  collective-permute:                result_bytes

`analyze_step` (the counterpart of `analyze_compiled`) runs one step of a
sharded `Net` on this rank and gives the same keys: FLOPs and HBM bytes a
rank from `runtime.profiler.flops_estimate` (a node that runs on its
blocks counts 1/tp of its FLOPs; a batch split divides FLOPs and
activation bytes by the batch degree; each param counts the bytes of the
rank's block), comm from the record, and

  t_compute = flops / peak_flops        (per rank)
  t_hbm     = hbm_bytes / hbm_bw
  t_comm    = wire_bytes / link_bw
  step time in [max(t_work, t_comm), t_work + t_comm],  t_work = max(t_compute, t_hbm).

`weak_scaling_report` holds the work a rank does constant while the mesh
grows and reports efficiency_N = t_step(first) / t_step(N) at both bounds.
The hardware model is `HW_H100`.
"""

from __future__ import annotations

import json
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..graph.shape_infer import infer_shapes
from ..runtime.profiler import flops_estimate

__all__ = ["HW_H100", "collective_stats", "analyze_step",
           "weak_scaling_report"]

# NVIDIA H100 SXM5, from NVIDIA's H100 Tensor Core GPU datasheet: 989
# TFLOP/s dense bf16 tensor core (1,979 with sparsity), 1,979 TOP/s dense
# int8 tensor core, 3.35 TB/s HBM3, NVLink 4 900 GB/s per GPU in both
# directions together (450 GB/s each way).
HW_H100 = {
    "name": "h100_sxm",
    "peak_flops_bf16": 989e12,
    "peak_ops_int8": 1979e12,
    "hbm_bw": 3.35e12,
    "link_bw": 450e9,
}


def _wire(kind: str, rbytes: float, n: int) -> float:
    if kind == "collective-permute":
        return rbytes
    if kind == "all-reduce":
        return 2 * rbytes * (n - 1) / max(n, 1)
    if kind == "all-gather":
        return rbytes * (n - 1) / max(n, 1)
    if kind == "reduce-scatter":
        return rbytes * (n - 1)
    return rbytes * (n - 1) / max(n, 1)  # all-to-all


def collective_stats(records: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """{kind, result_bytes, group_size, wire_bytes} of each recorded
    collective (`Mesh.records` or `Mesh.take_records()`)."""
    return [{"kind": r["kind"], "result_bytes": r["result_bytes"],
             "group_size": r["group_size"],
             "wire_bytes": _wire(r["kind"], r["result_bytes"],
                                 r["group_size"])}
            for r in records]


def analyze_step(net, inputs: Dict[str, Any],
                 hw: Dict[str, Any] = HW_H100) -> Dict[str, Any]:
    """Roofline of one step of a sharded `net` on this rank: the step runs
    once (`net.forward` on this rank's blocks of `inputs`, without the
    outputs' final gather) with the mesh's record read just after."""
    from .mesh import MODEL_AXIS, batch_size_of
    from .tensor_parallel import batch_split, local_block

    mesh, fwd = net.mesh, net.forward
    tp = mesh.shape.get(MODEL_AXIS, 1)
    nb = (batch_size_of(mesh) if any(batch_split(s, mesh)
                                     for s in net.input_specs.values()) else 1)
    table = flops_estimate(net.graph)
    shapes = infer_shapes(net.graph)
    flops = hbm = 0.0
    for node in net.order:
        share = 1.0 / tp if fwd.kinds[node.name] in ("col", "row", "attn") else 1.0
        flops += table[node.name]["flops"] * share / nb
        for e in list(node.inputs) + list(node.outputs):
            if e in net.params:  # the rank's block, as it holds it
                hbm += net.params[e].numel() * net.params[e].element_size()
            else:
                s = shapes[e]
                hbm += math.prod(s.shape) * s.dtype.itemsize / nb
    feed = {}
    for k, v in inputs.items():
        v = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        feed[k] = local_block(v, net.input_specs.get(k, ()), mesh).to(net.device)
    mesh.take_records()
    with torch.inference_mode():
        fwd(net.params, feed, net.prepared)
    colls = collective_stats(mesh.take_records())
    wire = sum(c["wire_bytes"] for c in colls)
    t_compute = flops / hw["peak_flops_bf16"]
    t_hbm = hbm / hw["hbm_bw"]
    t_comm = wire / hw["link_bw"]
    t_work = max(t_compute, t_hbm)
    return {
        "flops_per_device": flops,
        "hbm_bytes_per_device": hbm,
        "collectives": colls,
        "n_collectives": len(colls),
        "wire_bytes_per_device": wire,
        "t_compute_s": t_compute,
        "t_hbm_s": t_hbm,
        "t_comm_s": t_comm,
        "t_step_full_overlap_s": max(t_work, t_comm),
        "t_step_no_overlap_s": t_work + t_comm,
    }


def weak_scaling_report(build_step: Callable[[int], Any],
                        ns: Sequence[int] = (1, 2, 4),
                        hw: Dict[str, Any] = HW_H100,
                        out_path: Optional[str] = None) -> Dict[str, Any]:
    """`build_step(n)` gives (net, inputs) of an n-rank mesh with the work
    a rank does held constant, or None on a rank off that mesh (every rank
    calls it for every n: building a mesh is collective).  Rows for the
    meshes this rank is on; efficiency_n = t_step(first row) / t_step(n)."""
    rows = []
    base = None
    for n in ns:
        built = build_step(n)
        if built is None:
            continue
        a = analyze_step(*built, hw=hw)
        a["n_devices"] = n
        if base is None:
            base = a
        for bound in ("full_overlap", "no_overlap"):
            t0 = base[f"t_step_{bound}_s"]
            tn = a[f"t_step_{bound}_s"]
            a[f"efficiency_{bound}"] = (t0 / tn) if tn > 0 else 1.0
        a["collective_kinds"] = sorted({c["kind"] for c in a.pop("collectives")})
        rows.append(a)
    report = {"hw": hw["name"], "rows": rows,
              "efficiency_at_max_full_overlap": rows[-1]["efficiency_full_overlap"],
              "efficiency_at_max_no_overlap": rows[-1]["efficiency_no_overlap"]}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
    return report
