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
port's counterpart of the JAX `Net`'s `jax.jit`.

`Net(mesh=, param_sharding=, input_shardings=)` is one rank of a
tensor- and data-parallel net over a `parallel.Mesh` of processes: the
rank holds its blocks of the params, and `parallel.tensor_parallel`'s
forward issues the collectives (each node's rule is there).
"""

from __future__ import annotations

import threading
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
    order, outputs = cut_order(graph, stop_at, start_from, tap_edges)
    compute_dtype = _COMPUTE_DTYPES[precision]
    node_prec = node_precisions(graph, order)

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


def cut_order(graph: Graph, stop_at: Optional[str] = None,
              start_from: Optional[str] = None, tap_edges: Sequence[str] = ()
              ) -> Tuple[List[Node], List[str]]:
    """The nodes `build_forward` runs, in order, and the edges it returns."""
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
    if stop_at is not None or start_from is not None:
        outputs = list(order[-1].outputs)
    else:
        outputs = list(graph.outputs)
    return order, list(dict.fromkeys(outputs + list(tap_edges)))


def node_precisions(graph: Graph, order: Sequence[Node]
                    ) -> Dict[str, torch.dtype]:
    """The dtype of each node that `graph.precisions` pins."""
    return {n.name: _COMPUTE_DTYPES[graph.precisions[n.name]]
            for n in order if graph.precisions.get(n.name) in _COMPUTE_DTYPES}


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
    on the CPU, whose ops return when they are done.  The node in flight
    and the events not yet read are each thread's own, so that threads
    stepping one `Net` (a `Worker`'s pool) time their own nodes."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.times: Dict[str, List[float]] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def start(self, node: Node) -> None:
        self._local.key = f"{node.name}({node.op})"
        if self.cuda:
            self._local.t0 = torch.cuda.Event(enable_timing=True)
            self._local.t0.record()
        else:
            self._local.t0 = time.perf_counter()

    def stop(self) -> None:
        key, t0 = self._local.key, self._local.t0
        if self.cuda:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            if not hasattr(self._local, "pending"):
                self._local.pending = []
            self._local.pending.append((key, t0, t1))
        else:
            self._add(key, (time.perf_counter() - t0) * 1e3)

    def finish(self) -> None:
        pending = getattr(self._local, "pending", None)
        if pending:
            torch.cuda.synchronize()
            for key, t0, t1 in pending:
                self._add(key, t0.elapsed_time(t1))
            self._local.pending = []

    def _add(self, key: str, ms: float) -> None:
        with self._lock:
            self.times.setdefault(key, []).append(ms)

    def take(self) -> Dict[str, List[float]]:
        """Every node's times so far, forgotten here."""
        with self._lock:
            times, self.times = self.times, {}
        return times


def _check_mesh(mesh, **sharding) -> None:
    """A mesh must be a `parallel.Mesh`; a sharding needs one."""
    if mesh is None:
        given = [k for k, v in sharding.items() if v is not None]
        if given:
            raise ValueError(f"{', '.join(given)}: a sharding splits over a "
                             f"mesh; pass mesh= (a parallel.Mesh)")
        return
    from ..parallel.mesh import Mesh

    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh (make_mesh, "
                        f"make_hybrid_mesh), not {type(mesh).__name__}")


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
    optime_summary` reports them).

    `mesh` (a `parallel.Mesh`; every rank of it builds the same `Net`):
    this rank's part of a sharded net.  `param_sharding` ({param edge:
    Spec}, `parallel.shard_graph_params`; None replicates every param): the
    rank keeps only its block of each param.  `input_shardings` ({input:
    Spec}): an input's split where the default (the batch over the batch
    axes, where it divides) is not wanted, such as head-sharded caches.
    `local_outputs`: outputs that `forward` leaves as this rank's block
    (`prediction` still gathers them).  The collective-overlap options
    installed by `parallel.enable_collective_overlap` when the net is
    built are its `compiler_options`.
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
        local_outputs: Sequence[str] = (),
    ) -> None:
        _check_mesh(mesh, param_sharding=param_sharding,
                    input_shardings=input_shardings)
        graph.validate()
        self.graph = graph
        self.precision = precision
        self.device = _resolve_device(device)
        self._strict_sync = strict_sync
        self._timer = _OpTimer(self.device) if enable_op_timer else None
        self.mesh = mesh
        self.compiler_options = None
        if mesh is None:
            self.forward, self.order = build_forward(
                graph, precision, stop_at=stop_at, start_from=start_from,
                tap_edges=tap_edges)
            host_params = graph.params
        else:
            from ..parallel.tensor_parallel import local_block

            self._build_sharded(param_sharding, input_shardings,
                                local_outputs, stop_at, start_from, tap_edges)
            host_params = {k: np.ascontiguousarray(local_block(
                v, self.forward.param_specs[k], mesh))
                for k, v in graph.params.items()}
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
                for k, v in params_from_numpy(host_params,
                                              self.device).items()})
        self.prepared = prepare_int8_weights(self.order, self.params,
                                             self.params.prepared)

    def _build_sharded(self, param_sharding, input_shardings, local_outputs,
                       stop_at, start_from, tap_edges) -> None:
        from ..parallel.overlap import default_compiler_options
        from ..parallel.tensor_parallel import (ShardedForward,
                                                default_input_specs)

        order, outputs = cut_order(self.graph, stop_at, start_from, tap_edges)
        self.order = order
        self.compiler_options = default_compiler_options() or None
        self.input_specs = default_input_specs(self.graph, self.mesh,
                                               input_shardings)
        self.forward = ShardedForward(
            self.graph, order, dict(param_sharding or {}), self.mesh,
            _COMPUTE_DTYPES[self.precision],
            node_precisions(self.graph, order), outputs, self.input_specs,
            local_outputs, self.compiler_options)

    def _sharded_prediction(self, inputs: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
        """Each input's block to this rank, the rank's step, then every
        output whole."""
        from ..parallel.mesh import MODEL_AXIS, batch_axes
        from ..parallel.tensor_parallel import batch_split, local_block

        fwd, mesh = self.forward, self.mesh
        feed = {}
        for k, v in inputs.items():
            spec = self.input_specs.get(k, ())
            if not isinstance(v, torch.Tensor):
                v = np.asarray(v)
            feed[k] = _to_device(local_block(v, spec, mesh), self.device)
        with torch.inference_mode():
            out = fwd(self.params, feed, self.prepared, self._timer)
            for e in fwd.local_outputs & set(out):
                if e in fwd.block_dim:
                    out[e] = mesh.all_gather(out[e], MODEL_AXIS,
                                             fwd.block_dim[e])
            if any(batch_split(s, mesh) for s in self.input_specs.values()):
                out = {e: mesh.all_gather(v, batch_axes(mesh), 0)
                       if v.dim() else v for e, v in out.items()}
        return out

    def prediction(self, inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One forward step on numpy arrays or tensors; returns tensors on
        the net's device (under a mesh, whole on every rank)."""
        if self.mesh is not None:
            out = self._sharded_prediction(inputs)
        else:
            feed = {k: _to_device(v, self.device) for k, v in inputs.items()}
            with torch.inference_mode():
                out = self.forward(self.params, feed, self.prepared,
                                   self._timer)
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
        times = {} if self._timer is None else self._timer.take()
        lines = []
        total = 0.0
        for key, ts in sorted(times.items(), key=lambda kv: -np.mean(kv[1])):
            m = float(np.mean(ts))
            total += m
            lines.append(f"{key:60s} {m:10.4f} ms (n={len(ts)})")
        lines.append(f"{'TOTAL (sum of op means)':60s} {total:10.4f} ms")
        return "\n".join(lines)

    def compile(self, inputs: Dict[str, Any], static: Iterable[str] = ()):
        """The step for the shapes and dtypes of `inputs`, made replayable:
        `step(feed) -> {edge: tensor}`.  On CUDA the forward is captured in
        a CUDA graph (`runtime.graphs.CapturedStep`; a failed capture
        raises); on the CPU it is the eager forward.  `static` names inputs
        the graph binds as they are, such as the caches a decode step
        writes in place: pass those tensors themselves, on the net's device,
        here and at every call (or leave them out of the call).  The step's
        outputs are overwritten by its next call.

        Under a mesh it raises: the collectives of a gloo mesh run on the
        host, which a CUDA graph cannot capture (ROADMAP: NCCL and capture
        for tensor parallelism on two or more cards)."""
        if self.mesh is not None:
            raise NotImplementedError(
                "Net.compile under a mesh: the rank's collectives run on the "
                "host (gloo) and a CUDA graph cannot capture them; step the "
                "net with prediction() or forward()")
        return compile_step(
            lambda feed: self.forward(self.params, feed, self.prepared),
            inputs, static, self.device)

    def param_bytes(self) -> int:
        """Bytes of the weights on the device."""
        return sum(v.numel() * v.element_size() for v in self.params.values())
