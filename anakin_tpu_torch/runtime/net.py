"""Net: the executor, the port of `anakin_tpu/runtime/net.py`.

The JAX `Net` traces the graph into one jitted program.  PyTorch runs
eagerly, so here `build_forward` returns a function that walks the nodes in
topological order and calls each op on tensors; the dtype rules are the
JAX package's, so that the two agree node by node:

  * float graph inputs and float params run in the net's compute dtype
    (`precision` "fp32" or "bf16"); int8 tensors stay int8;
  * a node pinned in `graph.precisions` gets its float inputs cast to its
    own dtype, and its float outputs cast back to the compute dtype;
  * every other node's float outputs keep the dtype the op gave them, and
    the next consumer casts them to what it wants.

A `Net` also prepares, once when it is built, the [N][K] copy of every int8
weight that the int8 GEMM kernels read (`ops.quantized.
prepare_int8_weights`), and hands it to the node's op, so that no step
transposes a weight.

`Net(device_params=other.params)` shares another `Net`'s weights on the
device (the decode scheduler's decode, verify and prefill nets run on one
copy): the tensors are the same objects, and so are their prepared copies,
which travel with the param dict (`DeviceParams.prepared`, by weight edge).
`compile(inputs)` records a step into a CUDA graph (`runtime.graphs`), the
port's counterpart of the JAX `Net`'s `jax.jit`.  Sharding (`mesh`,
`param_sharding`, `input_shardings`) waits for the parallelism slice
(ROADMAP module 9) and raises.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import params_from_numpy
from ..graph.ir import Graph, Node, topological_order
from ..ops import get_op
from ..ops.quantized import prepare_int8_weights
from .graphs import compile_step

__all__ = ["DeviceParams", "Net", "build_forward"]

_COMPUTE_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def build_forward(
    graph: Graph,
    precision: str = "fp32",
    stop_at: Optional[str] = None,
    start_from: Optional[str] = None,
    tap_edges: Sequence[str] = (),
) -> Tuple[Callable, List[Node]]:
    """Build `f(params, inputs, prepared=None, timer=None) -> {edge:
    tensor}`, where `prepared` maps node names to the weights
    `prepare_int8_weights` made and `timer` (a `Net`'s op timer) times each
    node.

    `stop_at` / `start_from` cut the node order (with `start_from`, inputs
    feed the interior edges consumed at the cut); `tap_edges` adds interior
    edges to the outputs.
    """
    order = topological_order(graph)
    if start_from is not None:
        idx = [i for i, n in enumerate(order) if n.name == start_from]
        if not idx:
            raise KeyError(f"start_from node {start_from!r} not found")
        order = order[idx[0]:]
    if stop_at is not None:
        idx = [i for i, n in enumerate(order) if n.name == stop_at]
        if not idx:
            raise KeyError(f"stop_at node {stop_at!r} not found")
        order = order[: idx[0] + 1]

    compute_dtype = _COMPUTE_DTYPES[precision]
    if stop_at is not None or start_from is not None:
        outputs = list(order[-1].outputs)
    else:
        outputs = list(graph.outputs)
    outputs = list(dict.fromkeys(outputs + list(tap_edges)))

    node_prec: Dict[str, torch.dtype] = {
        n.name: _COMPUTE_DTYPES[graph.precisions[n.name]]
        for n in order if graph.precisions.get(n.name) in _COMPUTE_DTYPES}

    def forward(params: Dict[str, torch.Tensor],
                inputs: Dict[str, torch.Tensor],
                prepared: Optional[Dict[str, Any]] = None,
                timer: Optional["_OpTimer"] = None
                ) -> Dict[str, torch.Tensor]:
        prepared = prepared or {}
        env: Dict[str, torch.Tensor] = {
            k: v.to(compute_dtype) if v.is_floating_point() else v
            for k, v in inputs.items()}

        def lookup(e: str) -> torch.Tensor:
            if e in env:
                return env[e]
            v = params[e]
            return v.to(compute_dtype) if v.is_floating_point() else v

        for node in order:
            want = node_prec.get(node.name, compute_dtype)
            xs = []
            for e in node.inputs:
                v = lookup(e)
                if v.is_floating_point() and v.dtype != want:
                    v = v.to(want)
                xs.append(v)
            prep = prepared.get(node.name)
            if timer is not None:
                timer.start(node)
            ys = (get_op(node.op)(node, xs) if prep is None
                  else get_op(node.op)(node, xs, prepared=prep))
            if timer is not None:
                timer.stop()
            for e, y in zip(node.outputs, ys):
                if (y.is_floating_point() and y.dtype != compute_dtype
                        and node.name in node_prec):
                    y = y.to(compute_dtype)
                env[e] = y
        return {e: lookup(e) for e in outputs}

    return forward, order


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("Net runs on CUDA by default and no CUDA device is "
                           "present; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:  # as a tensor's device reads
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _to_device(v: Any, device: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.from_numpy(np.array(v)).to(device)


class DeviceParams(dict):
    """A `Net`'s weights on its device, {edge: tensor}, with the int8
    weights prepared for the GEMM kernels so far (`prepared`, {edge:
    PreparedB, or PreparedGroups for a grouped conv}), which every `Net`
    sharing the dict reuses and extends."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 prepared: Optional[Dict[str, Any]] = None):
        super().__init__(params)
        self.prepared = {} if prepared is None else prepared


class _OpTimer:
    """Milliseconds of each node, by "name(op)": CUDA events around the
    node on the card (read after the step's synchronize), the host clock
    on the CPU, whose ops return when they are done."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.times: Dict[str, List[float]] = {}
        self._pending: List[Tuple[str, Any, Any]] = []

    def start(self, node: Node) -> None:
        self._key = f"{node.name}({node.op})"
        if self.cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            self._pending.append((self._key, self._t0, t1))
        else:
            self.times.setdefault(self._key, []).append(
                (time.perf_counter() - self._t0) * 1e3)

    def finish(self) -> None:
        if self._pending:
            torch.cuda.synchronize()
            for key, t0, t1 in self._pending:
                self.times.setdefault(key, []).append(t0.elapsed_time(t1))
            self._pending = []


def _no_sharding(**given) -> None:
    named = [k for k, v in given.items() if v is not None]
    if named:
        raise NotImplementedError(
            f"{', '.join(named)}: sharded nets wait for the port's "
            f"parallelism slice (ROADMAP module 9)")


class Net:
    """Inference executor over a Graph:

        graph = quantize_graph(optimize(build_resnet50(...)), scales)
        net = Net(graph, precision="bf16")          # on CUDA
        out = net.prediction({"input": x})

    `device=None` means CUDA and raises where there is none; the CPU is
    used only when asked for (`device="cpu"`).  Weights go to the device
    once, cast to the compute dtype, and the int8 GEMM weights are prepared
    once (`prepared`).

    `device_params`: another `Net`'s `params` to run on, shared, not
    copied, with their prepared int8 weights (`KeyError` for an edge the
    graph needs and the dict lacks).  `strict_sync`: each step waits for
    the device and raises `FloatingPointError` on a non-finite float
    output.  `enable_op_timer`: each node is timed (`print_and_reset_
    optime_summary` reports them).  `mesh`, `param_sharding` and
    `input_shardings` raise `NotImplementedError` (ROADMAP module 9).
    """

    def __init__(
        self,
        graph: Graph,
        precision: str = "fp32",
        device=None,
        stop_at: Optional[str] = None,
        start_from: Optional[str] = None,
        tap_edges: Sequence[str] = (),
        enable_op_timer: bool = False,
        strict_sync: bool = False,
        device_params: Optional[Dict[str, torch.Tensor]] = None,
        mesh=None,
        param_sharding=None,
        input_shardings=None,
    ) -> None:
        _no_sharding(mesh=mesh, param_sharding=param_sharding,
                     input_shardings=input_shardings)
        graph.validate()
        self.graph = graph
        self.precision = precision
        self.device = _resolve_device(device)
        self._strict_sync = strict_sync
        self._timer = _OpTimer(self.device) if enable_op_timer else None
        self.forward, self.order = build_forward(
            graph, precision, stop_at=stop_at, start_from=start_from,
            tap_edges=tap_edges)
        if device_params is not None:
            missing = set(graph.params) - set(device_params)
            if missing:
                raise KeyError(f"device_params missing {sorted(missing)[:4]}...")
            off = [k for k in graph.params
                   if device_params[k].device != self.device]
            if off:
                raise ValueError(f"device_params {off[:4]} are not on "
                                 f"{self.device}")
            self.params = DeviceParams(
                {k: device_params[k] for k in graph.params},
                getattr(device_params, "prepared", None))
        else:
            dtype = _COMPUTE_DTYPES[precision]
            self.params = DeviceParams({
                k: v.to(dtype) if v.is_floating_point() else v
                for k, v in params_from_numpy(graph.params,
                                              self.device).items()})
        self.prepared = prepare_int8_weights(self.order, self.params,
                                             self.params.prepared)

    def prediction(self, inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One forward step on numpy arrays or tensors; returns tensors on
        the net's device."""
        feed = {k: _to_device(v, self.device) for k, v in inputs.items()}
        with torch.inference_mode():
            out = self.forward(self.params, feed, self.prepared, self._timer)
        if self._timer is not None:
            self._timer.finish()
        if self._strict_sync:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            for k, v in out.items():
                if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                    raise FloatingPointError(f"non-finite values in output {k!r}")
        return out

    def __call__(self, inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return self.prediction(inputs)

    def print_and_reset_optime_summary(self) -> str:
        """The mean ms of each node over the timed steps, slowest first, and
        their sum, in the JAX package's format; then forget them.  With the
        timer off (`enable_op_timer=False`) only the TOTAL line, 0 ms."""
        times = {} if self._timer is None else self._timer.times
        lines = []
        total = 0.0
        for key, ts in sorted(times.items(), key=lambda kv: -np.mean(kv[1])):
            m = float(np.mean(ts))
            total += m
            lines.append(f"{key:60s} {m:10.4f} ms (n={len(ts)})")
        lines.append(f"{'TOTAL (sum of op means)':60s} {total:10.4f} ms")
        times.clear()
        return "\n".join(lines)

    def compile(self, inputs: Dict[str, Any], static: Iterable[str] = ()):
        """The step for the shapes and dtypes of `inputs`, made replayable:
        `step(feed) -> {edge: tensor}`.  On CUDA the forward is captured in
        a CUDA graph (`runtime.graphs.CapturedStep`; a failed capture
        raises); on the CPU it is the eager forward.  `static` names inputs
        the graph binds as they are, such as the caches a decode step
        writes in place: pass those tensors themselves, on the net's device,
        here and at every call (or leave them out of the call).  The step's
        outputs are overwritten by its next call."""
        return compile_step(
            lambda feed: self.forward(self.params, feed, self.prepared),
            inputs, static, self.device)

    def param_bytes(self) -> int:
        """Bytes of the weights on the device."""
        return sum(v.numel() * v.element_size() for v in self.params.values())
