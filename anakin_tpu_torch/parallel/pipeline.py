"""Pipeline-parallel inference: the port of `anakin_tpu/parallel/pipeline.py`.

A graph is cut into N stages along its topological order, balanced by the
FLOPs of `runtime.profiler.flops_estimate` (`split_graph`, node for node
the JAX package's cut), and each stage runs as a `Net` on its own device.
Microbatches stream through the stages GPipe-style: stage i runs
microbatch m while stage i+1 runs microbatch m-1.  The JAX package gets
the overlap from XLA's asynchronous dispatch; here each stage on a CUDA
device issues its work on a stream of its own, and an event recorded after
a stage's microbatch is what the next stage's stream waits for, so the
host issues everything up front and the card overlaps the stages.  Stages
may share one card (each still on its own stream).  On the CPU the
stages run one after the other.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from ..graph.ir import Graph, topological_order
from ..graph.shape_infer import infer_shapes
from ..runtime.net import Net, _resolve_device
from ..runtime.profiler import flops_estimate

__all__ = ["split_graph", "PipelinedNet"]


def split_graph(graph: Graph, n_stages: int) -> List[Graph]:
    """Cut the graph into `n_stages` FLOP-balanced stage subgraphs.

    Each stage's inputs are the edges crossing into it; its outputs are the
    edges crossing out (plus the graph outputs it produces).
    """
    order = topological_order(graph)
    costs = flops_estimate(graph)
    total = sum(costs[n.name]["flops"] + 1.0 for n in order)
    per_stage = total / n_stages

    stages_nodes: List[List] = [[] for _ in range(n_stages)]
    acc, si = 0.0, 0
    for node in order:
        c = costs[node.name]["flops"] + 1.0
        if acc + c > per_stage * (si + 1) and si < n_stages - 1 and stages_nodes[si]:
            si += 1
        stages_nodes[si].append(node)
        acc += c

    shapes = infer_shapes(graph)
    graphs: List[Graph] = []
    for si, nodes in enumerate(stages_nodes):
        g = Graph(f"{graph.name}_stage{si}")
        produced_here = set()
        for n in nodes:
            produced_here.update(n.outputs)
        needed = set()
        for n in nodes:
            for e in n.inputs:
                if e in graph.params:
                    g.params[e] = graph.params[e]
                elif e not in produced_here:
                    needed.add(e)
        for e in sorted(needed):
            g.add_input(e, shapes[e].shape,
                        str(shapes[e].dtype).replace("torch.", ""))
        for n in nodes:
            g.add_node(n.name, n.op, n.inputs, n.outputs, **dict(n.attrs))
        consumed_later = set()
        for later in stages_nodes[si + 1:]:
            for n in later:
                consumed_later.update(n.inputs)
        for e in sorted(produced_here):
            if e in consumed_later or e in graph.outputs:
                g.mark_output(e)
        g.scales = dict(graph.scales)
        g.validate()
        graphs.append(g)
    return graphs


class PipelinedNet:
    """Stage graphs on a chain of torch devices, microbatches streamed."""

    def __init__(self, graph: Graph, devices: Sequence[Any],
                 precision: str = "fp32"):
        self.devices = [_resolve_device(d) for d in devices]
        self.stage_graphs = split_graph(graph, len(self.devices))
        self.graph = graph
        self.nets = [Net(g, precision=precision, device=d)
                     for g, d in zip(self.stage_graphs, self.devices)]
        self.streams = [torch.cuda.Stream(device=d) if d.type == "cuda"
                        else None for d in self.devices]

    def prediction(self, inputs: Dict[str, Any],
                   microbatches: int = 2) -> Dict[str, torch.Tensor]:
        """Split the batch into microbatches and stream them through the
        stages; returns the graph outputs, joined, on the last stage's
        device."""
        feed = {k: v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v)) for k, v in inputs.items()}
        B = next(iter(feed.values())).shape[0]
        m = min(microbatches, B)
        assert B % m == 0, (B, m)
        mb = B // m
        results = [{k: v[i * mb:(i + 1) * mb] for k, v in feed.items()}
                   for i in range(m)]
        done = [[None] * len(self.nets) for _ in range(m)]  # events
        for d, stream in zip(self.devices, self.streams):
            if stream is not None:  # after the caller's work on the card
                stream.wait_stream(torch.cuda.current_stream(d))
        with torch.inference_mode():
            for i in range(m):
                env = results[i]
                for s, net in enumerate(self.nets):
                    stream = self.streams[s]
                    ctx = (torch.cuda.stream(stream) if stream is not None
                           else contextlib.nullcontext())
                    with ctx:
                        if stream is not None and s > 0 and done[i][s - 1]:
                            stream.wait_event(done[i][s - 1])
                        stage_in = {k: env[k].to(self.devices[s],
                                                 non_blocking=True)
                                    for k in self.stage_graphs[s].inputs}
                        env.update(net.forward(net.params, stage_in,
                                               net.prepared))
                        if stream is not None:
                            done[i][s] = torch.cuda.Event()
                            done[i][s].record(stream)
            last = self.devices[-1]
            for d, stream in zip(self.devices, self.streams):
                # the caller's stream orders after every stage, so that the
                # stages' tensors are freed after their last use
                if stream is not None:
                    torch.cuda.current_stream(d).wait_stream(stream)
            outs = {e: torch.cat([r[e].to(last) for r in results], dim=0)
                    for e in self.graph.outputs}
        return outs
