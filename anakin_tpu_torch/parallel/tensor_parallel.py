"""How a rank runs a graph under sharding rules: the executor of a `Net`
built with a mesh.

The JAX `Net` hands GSPMD the shardings and XLA inserts the collectives.
Here each rank holds only its blocks of the params (`local_block` of each
param by its `Spec`) and its block of each input, walks the nodes as
`runtime.net.build_forward` does (the same dtype rules), and issues the
collectives itself, through the mesh.  Node by node:

  * **column-sharded** conv, dense, `dense_w4` and embedding (the weight's
    last dim over `model`): the node runs on its O/tp columns (a residual
    input is taken at the same columns; an int8 node's epilogue is per
    column, so its columns equal the unsharded node's bit for bit), and
    its output is this rank's block of the channels.  That block is
    all-gathered on `model` right after the node, unless every consumer is
    a row partner (below) or an elementwise node that passes the block on;
  * **row-sharded** dense, `dense_w8` and `dense_w4` (the Megatron pair
    behind a column-sharded producer): the op, with attr `partial_out`,
    multiplies its block of the input features by its K/tp rows
    (`matmul_w4` on K/tp packed rows and their scale rows); the rank
    all-reduces the float32 partial products, then `finish_dense` adds the
    bias, the residual and the activation.  The sum's order is
    not the unsharded product's, so outputs agree to float tolerance, not
    bit for bit;
  * an int8 `dense_int8` that a rule row-shards: its kernel's fused
    epilogue cannot be split over partial sums, so the rank keeps the
    whole weight and runs the whole product on the gathered input;
  * **attention** with column-sharded wq / wk / wv and a row-sharded wo:
    the node runs H/tp query heads and Hkv/tp kv heads on its cache blocks
    (the caches are head-sharded, dim 1), its float32 partial output
    projection is all-reduced and then cast, as the unsharded node casts;
  * an **eltwise** or **activation** node whose inputs are all blocks of
    the same split runs on the blocks (the SwiGLU gate between the up and
    down projections);
  * every other node runs on whole tensors: a block it reads is gathered
    first (once, whatever the number of readers).

Inputs are split over the batch axes (`sharding.input_sharding`) unless
the net's `input_shardings` say otherwise; a net's `prediction` gathers
every output whole on every rank.  With the overlap option
`async_all_gather` (`parallel.overlap`) a gather is issued asynchronously
and waited for at its first reader; with `collective_matmul_rings` a
row-sharded float `dense` runs `matmul_reducescatter` and gathers its rows
in place of the all-reduce.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Set

import torch

from ..graph.ir import Graph, Node
from ..ops import get_op
from ..ops.nn import finish_dense
from .mesh import MODEL_AXIS, Mesh, Spec, batch_axes, batch_size_of
from .overlap import matmul_reducescatter
from .sharding import input_sharding

__all__ = ["ShardedForward", "local_block", "spec_dim", "default_input_specs",
           "batch_split"]

_CONV = ("conv2d", "conv2d_int8", "conv2d_w8")
_DENSE = ("dense", "dense_int8", "dense_w8", "dense_w4")
_ATTN = ("mha_decode", "mha_verify", "mha_prefill", "multi_head_attention")
_ELTWISE = ("eltwise", "eltwise_op", "eltwise_relu", "eltwise_act")
_ACT = ("activation", "relu", "elu")
COL = Spec(None, MODEL_AXIS)
ROW = Spec(MODEL_AXIS, None)


def spec_dim(spec: Sequence, axis: str = MODEL_AXIS) -> Optional[int]:
    """The dim a spec splits over `axis` (None if none)."""
    for d, entry in enumerate(spec):
        names = (entry,) if isinstance(entry, str) else (entry or ())
        if axis in names:
            return d
    return None


def local_block(v, spec: Sequence, mesh: Mesh):
    """This rank's block of `v` (numpy or tensor) under `spec`."""
    for d, entry in enumerate(spec):
        if entry is None or entry == ():
            continue
        n, i = mesh.axis_size(entry), mesh.axis_index(entry)
        if v.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(v.shape)} does not split "
                             f"over {entry} ({n})")
        step = v.shape[d] // n
        idx = [slice(None)] * v.ndim
        idx[d] = slice(i * step, (i + 1) * step)
        v = v[tuple(idx)]
    return v


class _Block:
    """An edge's value on this rank: its block along `dim` over `model`,
    with the pending gather of the whole tensor, if one was issued."""

    __slots__ = ("t", "dim", "pending")

    def __init__(self, t: torch.Tensor, dim: int):
        self.t, self.dim, self.pending = t, dim % t.dim(), None


def _is_col(spec, ndim: int) -> bool:
    return spec is not None and spec_dim(spec) == ndim - 1


class ShardedForward:
    """The per-rank forward of `order` (a cut of `graph`) under `rules`.

    `outputs` are returned whole along `model` except those named in
    `local_outputs`, which stay this rank's block (a decode scheduler's
    caches); batch-split outputs stay this rank's rows (`Net.prediction`
    gathers them).
    """

    def __init__(self, graph: Graph, order: List[Node], rules: Dict[str, Spec],
                 mesh: Mesh, compute_dtype: torch.dtype,
                 node_prec: Dict[str, torch.dtype], outputs: List[str],
                 input_specs: Dict[str, Spec],
                 local_outputs: Sequence[str] = (),
                 options: Optional[dict] = None):
        self.graph, self.order, self.mesh = graph, order, mesh
        self.tp = mesh.shape.get(MODEL_AXIS, 1)
        self.compute_dtype, self.node_prec = compute_dtype, node_prec
        self.outputs = outputs
        self.local_outputs = set(local_outputs)
        self.options = dict(options or {})
        self.rules = dict(rules)
        self.replicated_int8: List[str] = []
        for node in order:
            if node.op == "dense_int8" and self.rules.get(node.inputs[1]) == ROW:
                self.rules[node.inputs[1]] = Spec()  # whole weight, whole product
                self.replicated_int8.append(node.name)
        self.param_specs = {e: self.rules.get(e, Spec()) for e in graph.params}
        self.input_specs = input_specs
        self._plan()

    # ---------------------------------------------------------------- plan
    def _kind(self, node: Node, block_dim: Dict[str, int]) -> str:
        r = self.rules
        if node.op in _ATTN and r.get(node.inputs[1]) == COL \
                and r.get(node.inputs[4]) == ROW:
            return "attn"
        if node.op in _DENSE and r.get(node.inputs[1]) == ROW:
            return "row"
        if node.op in _CONV + _DENSE or node.op == "embedding":
            w = self.graph.params.get(node.inputs[1])
            if w is not None and _is_col(r.get(node.inputs[1]), w.ndim):
                return "col"
        acts = [e for e in node.inputs if e not in self.graph.params]
        if (node.op in _ELTWISE or (node.op in _ACT and len(node.inputs) == 1)) \
                and acts and len(acts) == len(node.inputs) \
                and all(e in block_dim for e in acts) \
                and len({block_dim[e] for e in acts}) == 1:
            return "pass"
        return "normal"

    def _plan(self) -> None:
        """Each node's kind, each edge's split (static), and which blocks
        are read whole (so gathered as soon as they exist)."""
        block_dim: Dict[str, int] = {}  # edge -> its split dim (-1 = last)
        for k, spec in self.input_specs.items():
            d = spec_dim(spec)
            if d is not None:
                block_dim[k] = d
        self.kinds: Dict[str, str] = {}
        self.locals: Dict[str, Set[int]] = {}
        whole_readers: Set[str] = set(self.outputs) - self.local_outputs
        for node in self.order:
            kind = self._kind(node, block_dim)
            self.kinds[node.name] = kind
            local = self.locals[node.name] = self._local_inputs(node, kind)
            for j, e in enumerate(node.inputs):
                if j not in local and e not in self.graph.params:
                    whole_readers.add(e)
            if kind == "col":
                block_dim[node.outputs[0]] = -1
            elif kind == "attn" and len(node.outputs) == 3:
                block_dim[node.outputs[1]] = block_dim[node.outputs[2]] = 1
            elif kind == "pass":
                block_dim[node.outputs[0]] = block_dim[node.inputs[0]]
        self.block_dim = block_dim
        self.gather_after = {e for e in block_dim if e in whole_readers}

    def _local_inputs(self, node: Node, kind: str) -> Set[int]:
        """Indices of the inputs the node reads as this rank's block."""
        if kind == "col":  # its params and its residual
            return set(range(1, len(node.inputs)))
        if kind == "row":
            return {j for j in range(1, len(node.inputs))
                    if node.inputs[j] in self.graph.params} | {0}
        if kind == "attn":
            return {1, 2, 3, 4} | ({5, 6} if node.op in ("mha_decode",
                                                          "mha_verify")
                                   else set())
        if kind == "pass":
            return set(range(len(node.inputs)))
        return {j for j, e in enumerate(node.inputs) if e in self.graph.params}

    # ------------------------------------------------------------- running
    def _gather(self, b: _Block) -> torch.Tensor:
        if b.pending is None:
            b.pending = self.mesh.all_gather_async(b.t, MODEL_AXIS, b.dim)
        return b.pending.wait()

    def _whole(self, v) -> torch.Tensor:
        return self._gather(v) if isinstance(v, _Block) else v

    def _local(self, v, dim: int) -> torch.Tensor:
        if isinstance(v, _Block):
            if v.dim != dim % v.t.dim():
                raise ValueError(f"a block split on dim {v.dim} read as one "
                                 f"split on dim {dim}")
            return v.t
        n, i = self.tp, self.mesh.axis_index(MODEL_AXIS)
        step = v.shape[dim] // n
        return v.narrow(dim, i * step, step).contiguous()

    def __call__(self, params: Dict[str, torch.Tensor],
                 inputs: Dict[str, torch.Tensor],
                 prepared: Optional[Dict[str, Any]] = None,
                 timer=None) -> Dict[str, torch.Tensor]:
        prepared = prepared or {}
        cdt = self.compute_dtype
        asynchronous = bool(self.options.get("async_all_gather"))
        env: Dict[str, Any] = {}
        for k, v in inputs.items():
            v = v.to(cdt) if v.is_floating_point() else v
            env[k] = _Block(v, self.block_dim[k]) if k in self.block_dim else v

        def lookup(e: str):
            if e in env:
                return env[e]
            v = params[e]
            return v.to(cdt) if v.is_floating_point() else v

        def cast(v, want):
            return v.to(want) if v.is_floating_point() and v.dtype != want else v

        for node in self.order:
            want = self.node_prec.get(node.name, cdt)
            kind, local = self.kinds[node.name], self.locals[node.name]
            xs = []
            for j, e in enumerate(node.inputs):
                v = lookup(e)
                if e in self.graph.params:
                    pass  # the rank's block already
                elif j not in local:
                    v = self._whole(v)
                elif kind == "attn":
                    v = self._local(v, 1)
                elif kind == "pass":
                    v = v.t
                else:  # a row pair's input, a column node's residual
                    v = self._local(v, -1)
                xs.append(cast(v, want))
            if timer is not None:
                timer.start(node)
            ys = self._run(node, kind, xs, prepared.get(node.name))
            if timer is not None:
                timer.stop()
            for i, (e, y) in enumerate(zip(node.outputs, ys)):
                if (y.is_floating_point() and y.dtype != cdt
                        and node.name in self.node_prec):
                    y = y.to(cdt)
                if e in self.block_dim:
                    y = _Block(y, self.block_dim[e])
                    if e in self.gather_after:
                        y.pending = self.mesh.all_gather_async(
                            y.t, MODEL_AXIS, y.dim)
                        if not asynchronous:
                            y.pending.wait()
                env[e] = y
        out = {}
        for e in self.outputs:
            v = lookup(e)
            if isinstance(v, _Block):
                v = v.t if e in self.local_outputs else self._gather(v)
            out[e] = v
        return out

    def _run(self, node: Node, kind: str, xs: List[torch.Tensor],
             prep) -> List[torch.Tensor]:
        op = get_op(node.op)
        if kind == "attn":
            H = int(node.attr("num_heads"))
            Hkv = int(node.attr("num_kv_heads", H) or H)
            part = dataclasses.replace(node, attrs=dict(
                node.attrs, num_heads=H // self.tp,
                num_kv_heads=Hkv // self.tp, partial_out=True))
            ys = op(part, xs)
            y = self.mesh.all_reduce(ys[0], MODEL_AXIS).to(xs[0].dtype)
            return [y] + list(ys[1:])
        if kind == "row":
            return [self._row(node, xs)]
        return op(node, xs) if prep is None else op(node, xs, prepared=prep)

    def _row(self, node: Node, xs: List[torch.Tensor]) -> torch.Tensor:
        """A row-sharded dense: the op's partial product over this rank's
        K/tp input features (attr `partial_out`), summed over `model`, then
        the op's own end (`finish_dense`)."""
        x, w = xs[0], xs[1]
        xf = x.reshape(math.prod(x.shape[:int(node.attr("axis", 1))]), -1)
        if (self.options.get("collective_matmul_rings") and node.op == "dense"
                and xf.shape[0] % self.tp == 0):
            y = self.mesh.all_gather(
                matmul_reducescatter(xf, w, MODEL_AXIS, mesh=self.mesh),
                MODEL_AXIS, 0)
        else:
            part = dataclasses.replace(node, attrs=dict(node.attrs,
                                                        partial_out=True))
            y = self.mesh.all_reduce(get_op(node.op)(part, xs)[0], MODEL_AXIS)
        return finish_dense(node, y, xs)


def default_input_specs(graph: Graph, mesh: Mesh,
                        given: Optional[Dict[str, Spec]] = None
                        ) -> Dict[str, Spec]:
    """Each input's spec: `given`'s, else split over the batch axes where
    its batch divides the batch degree, else whole (the JAX `Net`'s
    choice)."""
    given = dict(given or {})
    nb = batch_size_of(mesh)
    out = {}
    for k, (shape, _) in graph.input_specs.items():
        if k in given:
            out[k] = Spec(*given[k])
        elif nb > 1 and len(shape) and shape[0] % nb == 0:
            out[k] = input_sharding(mesh, len(shape))
        else:
            out[k] = Spec()
    return out


def batch_split(spec: Sequence, mesh: Mesh) -> bool:
    """True when `spec` splits dim 0 over the mesh's batch axes."""
    axes = batch_axes(mesh)
    return bool(axes) and len(spec) > 0 and spec[0] is not None and set(
        (spec[0],) if isinstance(spec[0], str) else spec[0]) == set(axes) \
        and batch_size_of(mesh) > 1
