"""TensorFlow frontend: frozen GraphDef .pb -> anakin_tpu_torch Graph.

The port of `anakin_tpu/tools/converter/tf_frontend.py`: the same graph,
node for node and param for param, from the same source; shapes come from
the port's ops run on meta tensors (`shapes.py`) where the JAX frontend
calls `jax.eval_shape`.

Parity target: the reference converter's TF parser
(`tools/external_converter_v2/parser/tensorflow/parser_tf.py`, which
requires a frozen graph — freeze_graph folds variables into Const nodes —
then maps through a "med IR").  This frontend reads the frozen .pb
directly with a self-contained schema (`tf_proto/graph.proto`), no
tensorflow install needed.

Layout: TF inference graphs are NHWC-native, which is exactly this
engine's layout — so unlike the torch/ONNX/Caffe/Fluid frontends there is
NO layout translation: Conv2D filters are already HWIO, axis attributes
pass through unchanged.  `data_format: NCHW` graphs are rejected.

TF specifics handled here:
  * SAME/VALID conv padding passes through as the string (lax-native);
    SAME pooling computes TF's asymmetric (extra bottom/right) pads
    explicitly — max-pool pads are -inf and avg-pool divides by the
    valid-element count, both matching `reduce_window` semantics;
  * DepthwiseConv2dNative's (kh, kw, C, mult) filter reshapes to grouped
    HWIO (kh, kw, 1, C*mult) — TF's channel-major depthwise output order
    equals XLA's grouped-conv order;
  * FusedBatchNorm(V3) emits batch_norm + scale (folded by the rewriter);
  * Const nodes are a value pool: weight-consumers take them as params,
    shape/axis-consumers (Reshape, ConcatV2, Mean, Pad) read them as
    static ints; unconsumed consts are dropped.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...graph.ir import Graph
from .tf_proto import graph_pb2 as gp
from .shapes import eval_shape, spec

__all__ = ["from_tf"]

_NP_DTYPES = {
    gp.DT_FLOAT: np.dtype(np.float32),
    gp.DT_DOUBLE: np.dtype(np.float64),
    gp.DT_INT32: np.dtype(np.int32),
    gp.DT_UINT8: np.dtype(np.uint8),
    gp.DT_INT16: np.dtype(np.int16),
    gp.DT_INT8: np.dtype(np.int8),
    gp.DT_INT64: np.dtype(np.int64),
    gp.DT_BOOL: np.dtype(np.bool_),
    gp.DT_HALF: np.dtype(np.float16),
}

_PASSTHROUGH = {"Identity", "StopGradient", "CheckNumerics", "PreventGradient",
                "Snapshot"}


def tensor_to_numpy(t: "gp.TensorProto") -> np.ndarray:
    dtype = _NP_DTYPES[t.dtype]
    shape = tuple(int(d.size) for d in t.tensor_shape.dim)
    if t.tensor_content:
        return np.frombuffer(t.tensor_content, dtype=dtype).reshape(shape).copy()
    for field in ("float_val", "double_val", "int_val", "int64_val",
                  "bool_val"):
        vals = list(getattr(t, field))
        if vals:
            arr = np.array(vals, dtype=dtype)
            count = int(np.prod(shape)) if shape else 1
            if arr.size == 1 and count > 1:     # splat encoding
                arr = np.full(count, arr[0], dtype=dtype)
            return arr.reshape(shape)
    return np.zeros(shape, dtype=dtype)


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF SAME: total pad to reach ceil(size/s) outputs, extra on the
    bottom/right side."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class _Importer:
    def __init__(self, gd: "gp.GraphDef", batch_size: int,
                 outputs: Optional[List[str]]):
        self.gd = gd
        self.batch_size = batch_size
        self.want_outputs = outputs
        self.graph = Graph("tf_model")
        self.edge: Dict[str, str] = {}      # tf tensor name -> IR edge
        self.spec: Dict[str, torch.Tensor] = {}
        self.consts: Dict[str, np.ndarray] = {}
        self._n = 0

    def fresh(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def param(self, hint: str, value: np.ndarray) -> str:
        e = self.fresh(hint)
        v = np.asarray(value, order="C")
        self.graph.add_param(e, v)
        self.spec[e] = spec(v.shape, v.dtype)
        return e

    def emit(self, op: str, inputs: List[str], hint: str,
             out_name: Optional[str] = None, **attrs) -> str:
        name = self.fresh(hint)
        out_edges = [f"{name}:out"]
        node = self.graph.add_node(name, op, inputs, out_edges, **attrs)
        shapes = eval_shape(node, [self.spec[e] for e in inputs])
        self.spec[out_edges[0]] = shapes[0]
        if out_name is not None:
            self.edge[out_name] = out_edges[0]
        return out_edges[0]

    # ------------------------------------------------------------- resolve
    def src(self, ref: str) -> str:
        """tf input ref ('node', 'node:0', '^ctrl') -> IR edge; consts
        materialize as params on first data use."""
        name = ref.split(":")[0]
        if name in self.consts and ref not in self.edge:
            self.edge[ref] = self.edge[name] = self.param(
                f"c_{name.split('/')[-1][:24]}", self.consts[name])
        return self.edge.get(ref) or self.edge[name]

    def const_value(self, ref: str) -> np.ndarray:
        name = ref.split(":")[0]
        if name not in self.consts:
            raise NotImplementedError(
                f"tf input {ref!r} must be a Const (dynamic shapes are not "
                "supported; freeze and fold constants first)")
        return self.consts[name]

    def rank_of(self, ref: str) -> int:
        return len(self.spec[self.src(ref)].shape)

    # ------------------------------------------------------------------ run
    def run(self) -> Graph:
        consumed_as_const: set = set()
        for nd in self.gd.node:
            self.convert(nd, consumed_as_const)
        outs = self.want_outputs
        if outs:
            for o in outs:
                self.graph.mark_output(self.edge[o.split(":")[0]])
        else:
            consumers = self.graph.consumers()
            for e in dict.fromkeys(self.edge.values()):
                if e not in consumers and e not in self.graph.params \
                        and e not in self.graph.inputs:
                    self.graph.mark_output(e)
        self.graph.validate()
        return self.graph

    # ------------------------------------------------------------------ ops
    def convert(self, nd: "gp.NodeDef", consumed: set) -> None:
        t = nd.op
        a = nd.attr
        if t in ("NoOp", "Assert"):
            # control-dependency / debug nodes in real frozen graphs
            # (convert_variables_to_constants_v2 leaves a NoOp behind for
            # each collapsed control group) produce no data tensor
            return
        data_inputs = [i for i in nd.input if not i.startswith("^")]

        def X(i=0):
            return self.src(data_inputs[i])

        def check_nhwc():
            df = a["data_format"].s.decode() if "data_format" in a else "NHWC"
            if df not in ("", "NHWC"):
                raise NotImplementedError(f"tf data_format {df!r}")

        if t == "Placeholder" or t == "PlaceholderWithDefault":
            dims = [int(d.size) for d in a["shape"].shape.dim]
            dims = [self.batch_size if d in (-1, 0) else d for d in dims]
            e = self.graph.add_input(nd.name, tuple(dims), "float32")
            self.edge[nd.name] = e
            self.spec[e] = spec(tuple(dims), np.float32)
        elif t == "Const":
            self.consts[nd.name] = tensor_to_numpy(a["value"].tensor)
        elif t in _PASSTHROUGH:
            name = data_inputs[0].split(":")[0]
            if name in self.consts and name not in self.edge:
                self.consts[nd.name] = self.consts[name]
            else:
                self.edge[nd.name] = X()
        elif t == "Conv2D":
            check_nhwc()
            w = self.const_value(data_inputs[1])          # HWIO already
            strides = [int(s) for s in a["strides"].list.i]
            dil = [int(d) for d in a["dilations"].list.i] or [1, 1, 1, 1]
            pad = a["padding"].s.decode()
            self.emit("conv2d", [X(), self.param("conv_w", w)], "conv",
                      out_name=nd.name, strides=(strides[1], strides[2]),
                      padding=pad, dilation=(dil[1], dil[2]), groups=1,
                      has_bias=False)
        elif t == "DepthwiseConv2dNative":
            check_nhwc()
            w = self.const_value(data_inputs[1])          # (kh, kw, C, mult)
            kh, kw, c, mult = w.shape
            strides = [int(s) for s in a["strides"].list.i]
            pad = a["padding"].s.decode()
            self.emit("conv2d",
                      [X(), self.param("dw_w", w.reshape(kh, kw, 1, c * mult))],
                      "dwconv", out_name=nd.name,
                      strides=(strides[1], strides[2]), padding=pad,
                      groups=int(c), has_bias=False)
        elif t == "BiasAdd":
            check_nhwc()
            b = self.const_value(data_inputs[1]).reshape(-1)
            self.emit("scale", [X(), self.param("b_g", np.ones_like(b)),
                                self.param("b_b", b)], "bias",
                      out_name=nd.name)
        elif t in ("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3"):
            check_nhwc()
            gamma = self.const_value(data_inputs[1]).reshape(-1)
            beta = self.const_value(data_inputs[2]).reshape(-1)
            mean = self.const_value(data_inputs[3]).reshape(-1)
            var = self.const_value(data_inputs[4]).reshape(-1)
            eps = float(a["epsilon"].f) if "epsilon" in a else 1e-3
            y = self.emit("batch_norm",
                          [X(), self.param("bn_m", mean),
                           self.param("bn_v", var)], "bn", eps=eps)
            self.emit("scale", [y, self.param("bn_g", gamma),
                                self.param("bn_b", beta)], "bn_scale",
                      out_name=nd.name)
        elif t in ("MaxPool", "AvgPool"):
            check_nhwc()
            ks = [int(k) for k in a["ksize"].list.i]
            st = [int(s) for s in a["strides"].list.i]
            pad = a["padding"].s.decode()
            n_, h, w_, c = self.spec[X()].shape
            if pad == "SAME":
                pads = (_same_pads(h, ks[1], st[1]),
                        _same_pads(w_, ks[2], st[2]))
            else:
                pads = ((0, 0), (0, 0))
            self.emit("pool2d", [X()], "pool",
                      mode="max" if t == "MaxPool" else "avg",
                      window=(ks[1], ks[2]), strides=(st[1], st[2]),
                      padding=pads, exclusive=True, out_name=nd.name)
        elif t in ("Relu", "Relu6", "Elu", "Sigmoid", "Tanh", "Softplus",
                   "LeakyRelu", "Abs"):
            act = {"Relu": "relu", "Relu6": "relu6", "Elu": "elu",
                   "Sigmoid": "sigmoid", "Tanh": "tanh",
                   "Softplus": "softplus", "LeakyRelu": "leaky_relu",
                   "Abs": "abs"}[t]
            alpha = float(a["alpha"].f) if "alpha" in a else 0.2
            kw = {"act_alpha": alpha} if t == "LeakyRelu" else {}
            self.emit("activation", [X()], act, activation=act,
                      out_name=nd.name, **kw)
        elif t in ("Add", "AddV2", "Sub", "Mul", "RealDiv", "Maximum",
                   "Minimum"):
            kind = {"Add": "sum", "AddV2": "sum", "Sub": "sub",
                    "Mul": "prod", "RealDiv": "div", "Max": "max",
                    "Maximum": "max", "Minimum": "min"}[t]
            yname = data_inputs[1].split(":")[0]
            if yname in self.consts and yname not in self.edge:
                cv = self.consts[yname]
                if cv.ndim <= 1 and self.rank_of(data_inputs[0]) >= 1:
                    b = cv.reshape(-1).astype(np.float32)
                    if b.size == 1 and kind in ("sum", "sub", "prod", "div"):
                        v = float(b[0])
                        s, sh = {"sum": (1.0, v), "sub": (1.0, -v),
                                 "prod": (v, 0.0), "div": (1.0 / v, 0.0)}[kind]
                        self.emit("power", [X()], "scalar", scale=s,
                                  shift=sh, out_name=nd.name)
                        return
                    if kind in ("sum", "sub", "prod", "div") and b.size > 1:
                        g, bb = {
                            "sum": (np.ones_like(b), b),
                            "sub": (np.ones_like(b), -b),
                            "prod": (b, np.zeros_like(b)),
                            "div": (1.0 / b, np.zeros_like(b)),
                        }[kind]
                        self.emit("scale",
                                  [X(), self.param("ew_g", g),
                                   self.param("ew_b", bb)], "cbias",
                                  out_name=nd.name)
                        return
            self.emit("eltwise", [X(0), X(1)], "elt", mode=kind,
                      out_name=nd.name)
        elif t == "MatMul":
            wname = data_inputs[1].split(":")[0]
            ta = bool(a["transpose_a"].b) if "transpose_a" in a else False
            tb = bool(a["transpose_b"].b) if "transpose_b" in a else False
            if wname in self.consts and wname not in self.edge and not ta:
                w = self.consts[wname]
                if tb:
                    w = w.T
                self.emit("dense", [X(), self.param("fc_w", w)], "fc",
                          has_bias=False, out_name=nd.name)
            else:
                self.emit("matmul", [X(0), X(1)], "matmul", transpose_a=ta,
                          transpose_b=tb, out_name=nd.name)
        elif t == "Softmax":
            self.emit("softmax", [X()], "softmax", axis=-1, out_name=nd.name)
        elif t == "Mean":
            axes = [int(v) for v in
                    np.atleast_1d(self.const_value(data_inputs[1]))]
            keep = bool(a["keep_dims"].b) if "keep_dims" in a else False
            if self.rank_of(data_inputs[0]) == 4 and sorted(axes) == [1, 2]:
                y = self.emit("pool2d", [X()], "gap", mode="avg",
                              global_pooling=True)
                if not keep:
                    n_, _, _, c = self.spec[y].shape
                    y = self.emit("reshape", [y], "squeeze", shape=[n_, c])
                self.edge[nd.name] = y
            else:
                self.emit("reduce", [X()], "mean", mode="mean", axes=axes,
                          keep_dims=keep, out_name=nd.name)
        elif t == "Reshape":
            shape = [int(v) for v in self.const_value(data_inputs[1])]
            src = list(self.spec[X()].shape)
            if -1 in shape:
                known = int(np.prod([d for d in shape if d != -1]))
                shape[shape.index(-1)] = int(np.prod(src)) // known
            self.emit("reshape", [X()], "reshape", shape=shape,
                      out_name=nd.name)
        elif t == "Squeeze":
            dims = [int(v) for v in a["squeeze_dims"].list.i]
            src = list(self.spec[X()].shape)
            r = len(src)
            drop = {d % r for d in dims} if dims else \
                {i for i, d in enumerate(src) if d == 1}
            shape = [d for i, d in enumerate(src) if i not in drop]
            self.emit("reshape", [X()], "squeeze", shape=shape,
                      out_name=nd.name)
        elif t in ("ConcatV2", "Concat"):
            if t == "ConcatV2":
                vals, axis_ref = data_inputs[:-1], data_inputs[-1]
            else:
                axis_ref, vals = data_inputs[0], data_inputs[1:]
            axis = int(np.atleast_1d(self.const_value(axis_ref))[0])
            self.emit("concat", [self.src(v) for v in vals], "cat",
                      axis=axis, out_name=nd.name)
        elif t in ("Pad", "PadV2"):
            pads = np.asarray(self.const_value(data_inputs[1]), np.int64)
            if self.rank_of(data_inputs[0]) != 4 or pads[0].any():
                raise NotImplementedError("Pad on non-4D or batch axis")
            value = 0.0
            if t == "PadV2":
                value = float(np.atleast_1d(
                    self.const_value(data_inputs[2]))[0])
            self.emit("pad", [X()], "pad",
                      pad_h=tuple(int(v) for v in pads[1]),
                      pad_w=tuple(int(v) for v in pads[2]),
                      pad_c=tuple(int(v) for v in pads[3]),
                      value=value, out_name=nd.name)
        elif t == "ArgMax":
            axis = int(np.atleast_1d(self.const_value(data_inputs[1]))[0])
            self.emit("argmax", [X()], "argmax", axis=axis,
                      out_name=nd.name)
        else:
            raise NotImplementedError(
                f"tf op {t!r} not supported by the importer")


def from_tf(pb_path: str, batch_size: int = 1,
            outputs: Optional[List[str]] = None) -> Graph:
    """Import a frozen TensorFlow GraphDef (.pb).

    The graph must be frozen (variables folded into Const nodes, as the
    reference requires too).  `outputs` names fetch nodes explicitly;
    otherwise every unconsumed non-const node becomes an output.
    `batch_size` resolves -1 placeholder dims.
    """
    gd = gp.GraphDef()
    with open(pb_path, "rb") as f:
        gd.ParseFromString(f.read())
    return _Importer(gd, batch_size, outputs).run()
