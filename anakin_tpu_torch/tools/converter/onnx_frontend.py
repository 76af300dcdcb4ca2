"""ONNX frontend: .onnx model file -> anakin_tpu_torch Graph.

The port of `anakin_tpu/tools/converter/onnx_frontend.py`: the same graph,
node for node and param for param, from the same source; shapes come from
the port's ops run on meta tensors (`shapes.py`) where the JAX frontend
calls `jax.eval_shape`.

Parity target: the reference converter's ONNX parser
(`tools/external_converter_v2/parser/onnx/parser_onnx.py`), which maps
ONNX nodes onto anakin NodeProto attrs.  We carry our own protobuf schema
(`onnx_proto/onnx.proto`) so no onnx pip package is needed.

Design (same as the torch frontend, `torch_frontend.py`):

* layout translation NCHW -> NHWC: conv/deconv weights are permuted at
  import, channel-indexed axis attrs remapped for 4D tensors, and a
  Flatten-of-4D feeding Gemm permutes the Gemm weight's input rows from
  C*H*W to H*W*C order so fp32 outputs match the source bit-for-bit-ish.
* static-shape import: ONNX graphs exported from torch wrap dynamic-shape
  arithmetic (Shape -> Gather -> Unsqueeze -> Concat -> Reshape) around
  reshapes; since inference shapes are static we CONSTANT-FOLD any node
  whose data inputs are all known (Shape/Gather/Slice/Concat/Cast/... run
  in numpy at import time), so those chains collapse to static attrs.
* shape tracking: after each emitted node we run the op itself on meta
  tensors (one source of truth with the executor); the invariant is
  "internal edge = NHWC permutation of the ONNX value for rank-4,
  identical otherwise".
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...graph.ir import Graph
from .onnx_proto import onnx_pb2 as op2
from .shapes import eval_shape, spec

__all__ = ["from_onnx", "tensor_to_numpy"]

_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def tensor_to_numpy(t: "op2.TensorProto") -> np.ndarray:
    """Decode an ONNX TensorProto (raw_data or typed repeated fields)."""
    dt = _DTYPES.get(t.data_type)
    if dt is None:
        raise NotImplementedError(f"ONNX tensor dtype {t.data_type}")
    shape = tuple(t.dims)
    if t.raw_data:
        arr = np.frombuffer(t.raw_data, dtype=dt)
    elif t.float_data:
        arr = np.array(t.float_data, dtype=np.float32).astype(dt)
    elif t.int64_data:
        arr = np.array(t.int64_data, dtype=np.int64).astype(dt)
    elif t.int32_data:
        arr = np.array(t.int32_data, dtype=np.int32).astype(dt)
    elif t.double_data:
        arr = np.array(t.double_data, dtype=np.float64).astype(dt)
    else:
        arr = np.zeros(int(np.prod(shape)) if shape else 1, dtype=dt)
    return arr.reshape(shape).copy()


def _attrs(node: "op2.NodeProto") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for a in node.attribute:
        T = op2.AttributeProto
        if a.type == T.FLOAT:
            out[a.name] = a.f
        elif a.type == T.INT:
            out[a.name] = int(a.i)
        elif a.type == T.STRING:
            out[a.name] = a.s.decode()
        elif a.type == T.TENSOR:
            out[a.name] = tensor_to_numpy(a.t)
        elif a.type == T.FLOATS:
            out[a.name] = list(a.floats)
        elif a.type == T.INTS:
            out[a.name] = [int(v) for v in a.ints]
        elif a.type == T.STRINGS:
            out[a.name] = [s.decode() for s in a.strings]
        else:
            raise NotImplementedError(f"ONNX attr type {a.type} ({a.name})")
    return out


_NCHW2NHWC = {0: 0, 1: 3, 2: 1, 3: 2}
_TO_NHWC = (0, 2, 3, 1)   # perm taking an NCHW array to NHWC
_TO_NCHW = (0, 3, 1, 2)


class _Importer:
    def __init__(self, model: "op2.ModelProto"):
        self.model = model
        self.g = model.graph
        self.graph = Graph(self.g.name or "onnx_model")
        self.const: Dict[str, np.ndarray] = {}   # foldable values (ONNX domain)
        self.edge: Dict[str, str] = {}           # onnx name -> IR edge
        self.spec: Dict[str, torch.Tensor] = {}  # IR edge -> internal spec
        # onnx values produced by a Flatten/Reshape of a 4D feature map;
        # maps flattened name -> NCHW shape before the flatten (for the
        # Gemm/MatMul weight row fixup).
        self.flat4d: Dict[str, Tuple[int, ...]] = {}
        self._n = 0
        self.opset = 13
        for o in model.opset_import:
            if o.domain in ("", "ai.onnx"):
                self.opset = int(o.version)

    # ------------------------------------------------------------- plumbing
    def fresh(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def onnx_shape(self, name: str) -> Tuple[int, ...]:
        """Shape of an ONNX value in the source (NCHW) domain."""
        if name in self.const:
            return tuple(self.const[name].shape)
        s = self.spec[self.edge[name]].shape
        if len(s) == 4:
            return tuple(s[i] for i in _TO_NCHW)
        return tuple(s)

    def rank(self, name: str) -> int:
        if name in self.const:
            return self.const[name].ndim
        return len(self.spec[self.edge[name]].shape)

    def map_axis(self, name: str, axis: int) -> int:
        r = self.rank(name)
        if axis < 0:
            axis += r
        if r == 4 and name not in self.const:
            return _NCHW2NHWC[axis]
        return axis

    def as_edge(self, name: str, transpose4d: bool = True) -> str:
        """Edge for an ONNX value; materializes folded constants as params
        (rank-4 constants enter the graph in NHWC)."""
        if name in self.edge:
            return self.edge[name]
        v = self.const[name]
        if v.ndim == 4 and transpose4d:
            v = v.transpose(_TO_NHWC)
        e = self.fresh("const")
        self.graph.add_param(e, np.asarray(v, order="C"))
        self.spec[e] = spec(v.shape, v.dtype)
        self.edge[name] = e
        return e

    def param(self, hint: str, value: np.ndarray) -> str:
        e = self.fresh(hint)
        self.graph.add_param(e, np.asarray(value, order="C"))
        self.spec[e] = spec(value.shape, value.dtype)
        return e

    def emit(self, op: str, inputs: List[str], hint: str,
             outputs: Optional[List[str]] = None, **attrs) -> Any:
        """Add an IR node and infer its output spec via the op impl."""
        name = self.fresh(hint)
        n_out = len(outputs) if outputs else 1
        out_edges = [f"{name}:out{i}" if n_out > 1 else f"{name}:out"
                     for i in range(n_out)]
        node = self.graph.add_node(name, op, inputs, out_edges, **attrs)
        outs = eval_shape(node, [self.spec[e] for e in inputs])
        for e, s in zip(out_edges, outs):
            self.spec[e] = s
        if outputs:
            for onnx_name, e in zip(outputs, out_edges):
                self.edge[onnx_name] = e
        return out_edges[0] if n_out == 1 else out_edges

    # -------------------------------------------------------------- folding
    _FOLDABLE = {
        "Shape", "Gather", "Unsqueeze", "Squeeze", "Concat", "Slice", "Cast",
        "Add", "Sub", "Mul", "Div", "Reshape", "Transpose", "Constant",
        "ConstantOfShape", "Range", "Floor", "Ceil", "Identity", "Flatten",
    }

    def try_fold(self, n: "op2.NodeProto") -> bool:
        """Evaluate n in numpy if all its data inputs are known constants
        (Shape needs only the input's static shape)."""
        a = _attrs(n)
        t = n.op_type
        if t == "Constant":
            v = a.get("value")
            if v is None:
                v = np.array(a.get("value_float", a.get("value_int")))
            self.const[n.output[0]] = np.asarray(v)
            return True
        if t == "Shape":
            src = n.input[0]
            if src in self.const or src in self.edge:
                self.const[n.output[0]] = np.array(self.onnx_shape(src),
                                                   dtype=np.int64)
                return True
            return False
        if not all(i == "" or i in self.const for i in n.input):
            return False
        xs = [self.const[i] if i else None for i in n.input]
        if t == "Gather":
            self.const[n.output[0]] = np.take(xs[0], xs[1].astype(np.int64),
                                              axis=a.get("axis", 0))
        elif t == "Unsqueeze":
            axes = a.get("axes") or list(xs[1].reshape(-1).astype(int))
            v = xs[0]
            for ax in sorted(axes):
                v = np.expand_dims(v, ax)
            self.const[n.output[0]] = v
        elif t == "Squeeze":
            axes = a.get("axes")
            if axes is None and len(xs) > 1 and xs[1] is not None:
                axes = list(xs[1].reshape(-1).astype(int))
            self.const[n.output[0]] = (np.squeeze(xs[0], tuple(axes))
                                       if axes else np.squeeze(xs[0]))
        elif t == "Concat":
            self.const[n.output[0]] = np.concatenate(
                [np.atleast_1d(x) for x in xs], axis=a.get("axis", 0))
        elif t == "Slice":
            starts = a.get("starts") or xs[1].reshape(-1).astype(int)
            ends = a.get("ends") or xs[2].reshape(-1).astype(int)
            axes = a.get("axes")
            if axes is None:
                axes = (xs[3].reshape(-1).astype(int)
                        if len(xs) > 3 and xs[3] is not None
                        else list(range(len(starts))))
            steps = (xs[4].reshape(-1).astype(int)
                     if len(xs) > 4 and xs[4] is not None
                     else a.get("steps", [1] * len(starts)))
            idx = [slice(None)] * xs[0].ndim
            for ax, s, e, st in zip(axes, starts, ends, steps):
                idx[int(ax)] = slice(int(s), int(e), int(st))
            self.const[n.output[0]] = xs[0][tuple(idx)]
        elif t == "Cast":
            self.const[n.output[0]] = xs[0].astype(_DTYPES[a["to"]])
        elif t in ("Add", "Sub", "Mul", "Div"):
            fn = {"Add": np.add, "Sub": np.subtract, "Mul": np.multiply,
                  "Div": np.divide}[t]
            self.const[n.output[0]] = fn(xs[0], xs[1])
        elif t == "Reshape":
            self.const[n.output[0]] = xs[0].reshape(
                [int(v) for v in xs[1].reshape(-1)])
        elif t == "Flatten":
            ax = a.get("axis", 1)
            v = xs[0]
            self.const[n.output[0]] = v.reshape(
                (int(np.prod(v.shape[:ax])), -1))
        elif t == "Transpose":
            self.const[n.output[0]] = xs[0].transpose(
                a.get("perm") or tuple(reversed(range(xs[0].ndim))))
        elif t == "ConstantOfShape":
            fill = a.get("value", np.zeros(1, np.float32))
            self.const[n.output[0]] = np.full(
                [int(v) for v in xs[0].reshape(-1)], fill.reshape(-1)[0],
                dtype=fill.dtype)
        elif t == "Range":
            self.const[n.output[0]] = np.arange(xs[0].item(), xs[1].item(),
                                                xs[2].item())
        elif t in ("Floor", "Ceil"):
            self.const[n.output[0]] = getattr(np, t.lower())(xs[0])
        elif t == "Identity":
            self.const[n.output[0]] = xs[0]
        else:
            return False
        return True

    # ------------------------------------------------------------- op rules
    def conv_padding(self, x: str, a: Dict[str, Any], window: Sequence[int],
                     strides: Sequence[int]) -> Tuple[str, Tuple[int, int], Any]:
        """Resolve ONNX pads/auto_pad; returns (possibly padded edge,
        (ph, pw) symmetric padding or 'SAME')."""
        e = self.as_edge(x)
        auto = a.get("auto_pad", "NOTSET")
        if auto in ("SAME_UPPER", "SAME_LOWER"):
            return e, "SAME"
        if auto == "VALID":
            return e, (0, 0)
        pads = a.get("pads", [0, 0, 0, 0])
        pt, pl, pb, pr = pads
        if pt == pb and pl == pr:
            return e, (pt, pl)
        e = self.emit("pad", [e], "pad", pad_h=(pt, pb), pad_w=(pl, pr))
        return e, (0, 0)

    def _binary(self, n, mode: str):
        """Add/Sub/Mul/Div with activation and/or constant operands."""
        lhs, rhs = n.input[0], n.input[1]
        # scalar constant -> power op (shift / scale)
        for act, c, is_lhs in ((lhs, rhs, True), (rhs, lhs, False)):
            if act not in self.const and c in self.const \
                    and self.const[c].size == 1:
                v = float(self.const[c].reshape(()))
                x = self.as_edge(act)
                if mode == "sum":
                    return self.emit("power", [x], "addc", shift=v,
                                     outputs=[n.output[0]])
                if mode == "prod":
                    return self.emit("power", [x], "mulc", scale=v,
                                     outputs=[n.output[0]])
                if mode == "sub" and is_lhs:
                    return self.emit("power", [x], "subc", shift=-v,
                                     outputs=[n.output[0]])
                if mode == "div" and is_lhs:
                    return self.emit("power", [x], "divc", scale=1.0 / v,
                                     outputs=[n.output[0]])
        # general: align a constant operand's layout to the activation's
        edges = []
        ranks = [self.rank(lhs), self.rank(rhs)]
        for name, other_rank in ((lhs, ranks[1]), (rhs, ranks[0])):
            if name in self.const and other_rank == 4:
                v = self.const[name]
                if v.ndim == 3:          # (C,1,1) NCHW broadcast
                    v = v.transpose(1, 2, 0)
                elif v.ndim == 4:
                    v = v.transpose(_TO_NHWC)
                edges.append(self.param("bcast", v))
            else:
                edges.append(self.as_edge(name))
        return self.emit("eltwise", edges, mode, mode=mode,
                         outputs=[n.output[0]])

    def convert(self, n: "op2.NodeProto") -> None:
        t = n.op_type
        a = _attrs(n)
        out = n.output[0]

        def X(i=0):
            return self.as_edge(n.input[i])

        if t == "Conv":
            w = self.const[n.input[1]]                       # OIHW
            kh, kw = a.get("kernel_shape", w.shape[2:])
            strides = a.get("strides", [1, 1])
            x, pad = self.conv_padding(n.input[0], a, (kh, kw), strides)
            ins = [x, self.param("conv_w", w.transpose(2, 3, 1, 0))]
            if len(n.input) > 2:
                ins.append(self.param("conv_b", self.const[n.input[2]]))
            self.emit("conv2d", ins, "conv", strides=tuple(strides),
                      padding=pad, dilation=tuple(a.get("dilations", [1, 1])),
                      groups=a.get("group", 1), has_bias=len(n.input) > 2,
                      outputs=[out])
        elif t == "ConvTranspose":
            w = self.const[n.input[1]]                       # (I, O/g, kh, kw)
            strides = a.get("strides", [1, 1])
            pads = a.get("pads", [0, 0, 0, 0])
            if pads[0] != pads[2] or pads[1] != pads[3]:
                raise NotImplementedError("asymmetric ConvTranspose pads")
            if any(a.get("output_padding", [0, 0])):
                raise NotImplementedError("ConvTranspose output_padding")
            ins = [X(), self.param("deconv_w", w.transpose(2, 3, 0, 1))]
            if len(n.input) > 2:
                ins.append(self.param("deconv_b", self.const[n.input[2]]))
            self.emit("deconv2d", ins, "deconv", strides=tuple(strides),
                      padding=(pads[0], pads[1]), groups=a.get("group", 1),
                      has_bias=len(n.input) > 2, outputs=[out])
        elif t == "BatchNormalization":
            g, b, mean, var = (self.const[n.input[i]] for i in (1, 2, 3, 4))
            y = self.emit("batch_norm",
                          [X(), self.param("bn_mean", mean),
                           self.param("bn_var", var)],
                          "bn", eps=a.get("epsilon", 1e-5))
            self.edge[out] = self.emit(
                "scale", [y, self.param("bn_g", g), self.param("bn_b", b)],
                "scale")
        elif t == "Gemm":
            if a.get("transA", 0):
                raise NotImplementedError("Gemm transA")
            w = self.const[n.input[1]]
            if a.get("transB", 0):
                w = w.T                                       # (in, out)
            w = w * a.get("alpha", 1.0)
            w = self._maybe_permute_rows(n.input[0], w)
            ins = [X(), self.param("fc_w", np.asarray(w, order="C"))]
            has_bias = len(n.input) > 2
            if has_bias:
                ins.append(self.param(
                    "fc_b", self.const[n.input[2]] * a.get("beta", 1.0)))
            self.emit("dense", ins, "fc", has_bias=has_bias, outputs=[out])
        elif t == "MatMul":
            if n.input[1] in self.const and self.const[n.input[1]].ndim == 2:
                w = self._maybe_permute_rows(n.input[0],
                                             self.const[n.input[1]])
                self.emit("dense", [X(), self.param("fc_w", w)], "fc",
                          has_bias=False, axis=self.rank(n.input[0]) - 1,
                          outputs=[out])
            else:
                self.emit("matmul", [X(0), X(1)], "matmul", outputs=[out])
        elif t in ("Relu", "Sigmoid", "Tanh", "Softsign", "Softplus", "Erf"):
            if t == "Erf":
                self.emit("erf", [X()], "erf", outputs=[out])
            else:
                act = {"Relu": "relu", "Sigmoid": "sigmoid", "Tanh": "tanh",
                       "Softsign": "soft_sign", "Softplus": "softplus"}[t]
                self.emit("activation", [X()], "act", activation=act,
                          outputs=[out])
        elif t == "LeakyRelu":
            self.emit("activation", [X()], "act", activation="leaky_relu",
                      act_alpha=a.get("alpha", 0.01), outputs=[out])
        elif t == "Elu":
            self.emit("activation", [X()], "act", activation="elu",
                      act_alpha=a.get("alpha", 1.0), outputs=[out])
        elif t == "HardSigmoid":
            al, be = a.get("alpha", 0.2), a.get("beta", 0.5)
            y = self.emit("power", [X()], "hs_lin", scale=al, shift=be)
            lo = self.param("c0", np.zeros((), np.float32))
            hi = self.param("c1", np.ones((), np.float32))
            y = self.emit("eltwise", [y, lo], "hs_max", mode="max")
            self.edge[out] = self.emit("eltwise", [y, hi], "hs_min",
                                       mode="min")
        elif t == "PRelu":
            s = self.const[n.input[1]].reshape(-1)
            self.emit("prelu", [X(), self.param("prelu_w", s)], "prelu",
                      channel_shared=s.size == 1, outputs=[out])
        elif t == "Clip":
            lo = hi = None
            if self.opset >= 11:
                if len(n.input) > 1 and n.input[1]:
                    lo = float(self.const[n.input[1]].reshape(()))
                if len(n.input) > 2 and n.input[2]:
                    hi = float(self.const[n.input[2]].reshape(()))
            else:
                lo, hi = a.get("min"), a.get("max")
            if lo == 0.0 and hi == 6.0:
                self.emit("activation", [X()], "relu6", activation="relu6",
                          outputs=[out])
            elif lo == 0.0 and hi is None:
                self.emit("activation", [X()], "relu", activation="relu",
                          outputs=[out])
            else:
                y = X()
                if lo is not None:
                    y = self.emit("eltwise",
                                  [y, self.param("clip_lo",
                                                 np.float32(lo).reshape(()))],
                                  "clip_lo", mode="max")
                if hi is not None:
                    y = self.emit("eltwise",
                                  [y, self.param("clip_hi",
                                                 np.float32(hi).reshape(()))],
                                  "clip_hi", mode="min")
                self.edge[out] = y
        elif t in ("MaxPool", "AveragePool"):
            window = a["kernel_shape"]
            strides = a.get("strides", [1, 1])
            mode = "max" if t == "MaxPool" else "avg"
            exclusive = mode == "avg" and not a.get("count_include_pad", 0)
            pads = a.get("pads", [0, 0, 0, 0])
            if (pads[0] != pads[2] or pads[1] != pads[3]) and exclusive:
                raise NotImplementedError(
                    "asymmetric AveragePool pads with count_include_pad=0")
            x, pad = self.conv_padding(n.input[0], a, window, strides)
            if pad == "SAME":
                raise NotImplementedError("auto_pad SAME pooling")
            self.emit("pool2d", [x], "pool", mode=mode, window=tuple(window),
                      strides=tuple(strides), padding=tuple(pad),
                      ceil_mode=bool(a.get("ceil_mode", 0)),
                      exclusive=exclusive, outputs=[out])
        elif t in ("GlobalAveragePool", "GlobalMaxPool"):
            self.emit("pool2d", [X()], "gap",
                      mode="avg" if t == "GlobalAveragePool" else "max",
                      global_pooling=True, outputs=[out])
        elif t in ("Add", "Sub", "Mul", "Div"):
            self._binary(n, {"Add": "sum", "Sub": "sub", "Mul": "prod",
                             "Div": "div"}[t])
        elif t == "Sum":
            self.emit("eltwise", [self.as_edge(i) for i in n.input], "sum",
                      mode="sum", outputs=[out])
        elif t in ("Max", "Min"):
            self.emit("eltwise", [self.as_edge(i) for i in n.input],
                      t.lower(), mode=t.lower(), outputs=[out])
        elif t == "Pow":
            if n.input[1] in self.const and self.const[n.input[1]].size == 1:
                self.emit("power", [X()], "pow",
                          power=float(self.const[n.input[1]].reshape(())),
                          outputs=[out])
            else:
                raise NotImplementedError("Pow with tensor exponent")
        elif t == "Sqrt":
            self.emit("power", [X()], "sqrt", power=0.5, outputs=[out])
        elif t == "Neg":
            self.emit("power", [X()], "neg", scale=-1.0, outputs=[out])
        elif t == "Exp":
            self.emit("exp", [X()], "exp", outputs=[out])
        elif t == "Log":
            self.emit("log", [X()], "log", outputs=[out])
        elif t == "Concat":
            axis = self.map_axis(n.input[0], a.get("axis", 0))
            self.emit("concat", [self.as_edge(i) for i in n.input], "cat",
                      axis=axis, outputs=[out])
        elif t == "Flatten":
            self._flatten(n.input[0], out, a.get("axis", 1))
        elif t == "Reshape":
            shape = [int(v) for v in self.const[n.input[1]].reshape(-1)]
            self._reshape(n.input[0], out, shape)
        elif t in ("Squeeze", "Unsqueeze"):
            axes = a.get("axes")
            if axes is None and len(n.input) > 1:
                axes = [int(v) for v in self.const[n.input[1]].reshape(-1)]
            src_shape = list(self.onnx_shape(n.input[0]))
            if t == "Squeeze":
                axes = ([ax % len(src_shape) for ax in axes] if axes else
                        [i for i, d in enumerate(src_shape) if d == 1])
                shape = [d for i, d in enumerate(src_shape) if i not in axes]
            else:
                shape = src_shape
                r = len(src_shape) + len(axes)
                for ax in sorted(ax % r for ax in axes):
                    shape.insert(ax, 1)
            self._reshape(n.input[0], out, shape)
        elif t == "Transpose":
            perm = a.get("perm") or list(
                reversed(range(self.rank(n.input[0]))))
            if self.rank(n.input[0]) == 4:
                # compose NHWC->NCHW, source perm, NCHW->NHWC so the
                # internal result stays the NHWC image of the ONNX result
                perm = [_TO_NCHW[perm[_TO_NHWC[k]]] for k in range(4)]
            self.emit("permute", [X()], "perm", order=tuple(int(p) for p in perm),
                      outputs=[out])
        elif t == "Softmax":
            default_axis = -1 if self.opset >= 13 else 1
            axis = self.map_axis(n.input[0], a.get("axis", default_axis))
            if self.opset < 13 and self.rank(n.input[0]) > 2:
                # legacy semantics: flatten from axis then softmax — only
                # the common trailing-axes case is equivalent elementwise
                pass
            self.emit("softmax", [X()], "softmax", axis=axis, outputs=[out])
        elif t == "LRN":
            self.emit("lrn", [X()], "lrn", local_size=a.get("size", 5),
                      alpha=a.get("alpha", 1e-4), beta=a.get("beta", 0.75),
                      k=a.get("bias", 1.0), outputs=[out])
        elif t in ("Dropout", "Identity"):
            self.edge[out] = self.as_edge(n.input[0])
            if n.input[0] in self.flat4d:
                self.flat4d[out] = self.flat4d[n.input[0]]
        elif t == "Cast":
            self.emit("cast", [X()], "cast",
                      dtype=np.dtype(_DTYPES[a["to"]]).name, outputs=[out])
        elif t == "Slice":
            if self.opset >= 10:
                starts = [int(v) for v in self.const[n.input[1]].reshape(-1)]
                ends = [int(v) for v in self.const[n.input[2]].reshape(-1)]
                axes = ([int(v) for v in self.const[n.input[3]].reshape(-1)]
                        if len(n.input) > 3 and n.input[3]
                        else list(range(len(starts))))
                steps = ([int(v) for v in self.const[n.input[4]].reshape(-1)]
                         if len(n.input) > 4 and n.input[4]
                         else [1] * len(starts))
            else:
                starts, ends = a["starts"], a["ends"]
                axes = a.get("axes", list(range(len(starts))))
                steps = [1] * len(starts)
            if any(s != 1 for s in steps):
                raise NotImplementedError("strided Slice")
            axes = [self.map_axis(n.input[0], ax) for ax in axes]
            self.emit("slice_v2", [X()], "slice", axes=axes, starts=starts,
                      ends=ends, outputs=[out])
        elif t == "Split":
            axis = self.map_axis(n.input[0], a.get("axis", 0))
            sizes = a.get("split")
            if sizes is None and len(n.input) > 1 and n.input[1]:
                sizes = [int(v) for v in self.const[n.input[1]].reshape(-1)]
            attrs = {}
            if sizes:
                attrs["slice_points"] = list(np.cumsum(sizes[:-1]).tolist())
            self.emit("slice", [X()], "split", axis=axis,
                      outputs=list(n.output), **attrs)
        elif t == "Gather":
            axis = self.map_axis(n.input[0], a.get("axis", 0))
            idx = self.as_edge(n.input[1])
            if self.rank(n.input[0]) == 2 and a.get("axis", 0) == 0 \
                    and n.input[0] in self.const:
                tbl = self.param("embed", self.const[n.input[0]])
                self.emit("embedding", [idx, tbl], "embed", outputs=[out])
            else:
                self.emit("gather", [X(), idx], "gather", axis=axis,
                          outputs=[out])
        elif t == "Pad":
            if self.opset >= 11:
                pads = [int(v) for v in self.const[n.input[1]].reshape(-1)]
                value = (float(self.const[n.input[2]].reshape(()))
                         if len(n.input) > 2 and n.input[2] else 0.0)
            else:
                pads = a["pads"]
                value = a.get("value", 0.0)
            mode = a.get("mode", "constant")
            r = self.rank(n.input[0])
            if r != 4:
                raise NotImplementedError("Pad on non-4D tensor")
            pn0, pc0, pt, pl, pn1, pc1, pb, pr = pads
            if pn0 or pn1:
                raise NotImplementedError("Pad on batch dim")
            self.emit("pad", [X()], "pad", pad_h=(pt, pb), pad_w=(pl, pr),
                      pad_c=(pc0, pc1), mode={"constant": "constant",
                                              "reflect": "reflect",
                                              "edge": "edge"}[mode],
                      value=value, outputs=[out])
        elif t in ("Resize", "Upsample"):
            scales = sizes = None
            if t == "Upsample":
                if self.opset >= 9 and len(n.input) > 1:
                    scales = self.const[n.input[1]].reshape(-1)
                else:
                    scales = np.array(a["scales"])
                mode = a.get("mode", "nearest")
                coord = "asymmetric"
            else:
                if len(n.input) > 2 and n.input[2]:
                    scales = self.const[n.input[2]].reshape(-1)
                if (scales is None or scales.size == 0) and len(n.input) > 3:
                    sizes = self.const[n.input[3]].reshape(-1)
                mode = a.get("mode", "nearest")
                coord = a.get("coordinate_transformation_mode", "half_pixel")
            attrs: Dict[str, Any] = {
                "method": {"nearest": "nearest", "linear": "bilinear",
                           "bilinear": "bilinear"}[mode],
                "align_corners": coord == "align_corners",
            }
            if sizes is not None:
                attrs["out_hw"] = (int(sizes[2]), int(sizes[3]))
            else:
                attrs["scale_h"] = float(scales[2])
                attrs["scale_w"] = float(scales[3])
            self.emit("resize", [X()], "resize", outputs=[out], **attrs)
        elif t in ("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin",
                   "ReduceProd"):
            axes = a.get("axes")
            if axes is None and len(n.input) > 1 and n.input[1]:
                axes = [int(v) for v in self.const[n.input[1]].reshape(-1)]
            keep = bool(a.get("keepdims", 1))
            mode = {"ReduceMean": "mean", "ReduceSum": "sum",
                    "ReduceMax": "max", "ReduceMin": "min",
                    "ReduceProd": "prod"}[t]
            r = self.rank(n.input[0])
            if r == 4 and axes and sorted(ax % r for ax in axes) == [2, 3] \
                    and mode == "mean":
                y = self.emit("pool2d", [X()], "gap", mode="avg",
                              global_pooling=True)
                if not keep:
                    y = self.emit("flatten", [y], "flatten", axis=1)
                self.edge[out] = y
            else:
                maxes = ([self.map_axis(n.input[0], ax) for ax in axes]
                         if axes else None)
                self.emit("reduce", [X()], "reduce", mode=mode, axes=maxes,
                          keep_dims=keep, outputs=[out])
        elif t == "ArgMax":
            axis = self.map_axis(n.input[0], a.get("axis", 0))
            self.emit("argmax", [X()], "argmax", axis=axis,
                      keepdims=bool(a.get("keepdims", 1)), outputs=[out])
        elif t == "DepthToSpace":
            if a.get("mode", "DCR") != "CRD":
                raise NotImplementedError("DepthToSpace DCR mode")
            self.emit("pixel_shuffle", [X()], "ps",
                      upscale_factor=a["blocksize"], outputs=[out])
        else:
            raise NotImplementedError(
                f"ONNX op {t} not supported by the importer")

    # ------------------------------------------------- reshape/flatten glue
    def _flatten(self, src: str, out: str, axis: int) -> None:
        x = self.as_edge(src)
        if self.rank(src) == 4 and axis == 1:
            self.flat4d[out] = self.onnx_shape(src)
        self.edge[out] = self.emit("flatten", [x], "flatten",
                                   axis=max(axis, 1))

    def _reshape(self, src: str, out: str, shape: List[int]) -> None:
        src_shape = list(self.onnx_shape(src))
        n = src_shape[0]
        resolved = list(shape)
        for i, v in enumerate(resolved):
            if v == 0:
                resolved[i] = src_shape[i]
        if -1 in resolved:
            known = int(np.prod([v for v in resolved if v != -1]))
            resolved[resolved.index(-1)] = int(np.prod(src_shape)) // known
        if self.rank(src) == 4:
            if len(resolved) == 2 and resolved[0] == n:
                self._flatten(src, out, 1)
                return
            if resolved == src_shape:
                self.edge[out] = self.as_edge(src)
                return
            raise NotImplementedError(
                f"Reshape of 4D feature map to {resolved}")
        if len(resolved) == 4:
            raise NotImplementedError("Reshape to 4D feature map")
        self.edge[out] = self.emit("reshape", [self.as_edge(src)], "reshape",
                                   shape=resolved)

    def _maybe_permute_rows(self, src: str, w: np.ndarray) -> np.ndarray:
        if src in self.flat4d:
            _, c, h, ww = self.flat4d[src]
            idx = np.arange(c * h * ww).reshape(c, h, ww)
            perm = idx.transpose(1, 2, 0).reshape(-1)   # HWC row order
            return np.ascontiguousarray(w[perm])
        return w

    # ----------------------------------------------------------------- main
    def run(self) -> Graph:
        for init in self.g.initializer:
            self.const[init.name] = tensor_to_numpy(init)
        init_names = set(self.const)
        for vi in self.g.input:
            if vi.name in init_names:
                continue
            dims = [d.dim_value for d in vi.type.tensor_type.shape.dim]
            if any(d <= 0 for d in dims):
                raise ValueError(
                    f"input {vi.name} has dynamic dims {dims}; static "
                    "shapes required (re-export with a fixed batch)")
            elem = vi.type.tensor_type.elem_type or 1
            np_dt = np.dtype(_DTYPES[elem])
            dt = "int32" if np_dt.kind in "iu" else "float32"
            if len(dims) == 4:
                n_, c, h, w = dims
                e = self.graph.add_input(vi.name, (n_, h, w, c), dt)
            else:
                e = self.graph.add_input(vi.name, tuple(dims), dt)
            self.edge[vi.name] = e
            self.spec[e] = spec(self.graph.input_specs[e][0], dt)
        for n in self.g.node:
            if self.try_fold(n):
                continue
            self.convert(n)
        for vo in self.g.output:
            self.graph.mark_output(self.as_edge(vo.name))
        self.graph.validate()
        return self.graph


def from_onnx(model: Any) -> Graph:
    """Import an ONNX model (path, bytes, or ModelProto) into a Graph.

    4D values are translated NCHW->NHWC exactly like the torch frontend;
    fp32 outputs match the source runtime to ~1e-4.
    """
    if isinstance(model, (str, bytes)):
        m = op2.ModelProto()
        if isinstance(model, str):
            with open(model, "rb") as f:
                m.ParseFromString(f.read())
        else:
            m.ParseFromString(model)
        model = m
    return _Importer(model).run()
