"""Paddle Fluid frontend: __model__ ProgramDesc (+ params) -> anakin_tpu_torch Graph.

The port of `anakin_tpu/tools/converter/fluid_frontend.py`: the same graph,
node for node and param for param, from the same source; shapes come from
the port's ops run on meta tensors (`shapes.py`) where the JAX frontend
calls `jax.eval_shape`.

Parity target: the reference converter's Fluid parser
(`tools/external_converter_v2/parser/fluid/parser_fluid.py` +
`fluid_layer_param_transmit.py`) — Fluid was Paddle's own serving format
and the reference's first-party frontend.  Unlike the reference (which
imports `paddle.fluid` and runs an Executor scope just to materialize
weights), this frontend reads the on-disk formats directly:

  * `__model__`: a `ProgramDesc` protobuf (self-contained schema in
    `fluid_proto/framework.proto`);
  * weights: Paddle's LoDTensor save format — uint32 version, uint64
    lod-level (+ per-level byte runs), uint32 tensor version, int32-length
    `VarType.TensorDesc` proto (dtype + dims), then raw data — one file
    per persistable var (`save_persistables`) or a single combined file
    (`save_inference_model(..., params_filename=...)`, vars concatenated
    in sorted-name order, matching paddle's `io.save_vars`).

Layout policy matches the torch/ONNX/Caffe frontends: NCHW -> NHWC at
import (conv filters OIHW -> HWIO, channel axes remapped, `mul` on a 4D
input gets the implicit flatten plus the HWC row fixup on its weight).

Fluid specifics handled here:
  * `feed` / `fetch` ops delimit graph I/O; feed var dims of -1/0 resolve
    to `batch_size`;
  * `batch_norm` carries learned Scale/Bias as extra inputs -> emitted as
    batch_norm + scale (the optimizer folds both into conv);
  * `elementwise_add` against a rank-1 persistable var is a channel bias
    (fluid's conv bias idiom) -> emitted as `scale`;
  * inference `dropout` honors `dropout_implementation`
    (downgrade_in_infer multiplies by 1-p; upscale_in_train is identity);
  * fluid `lrn` does not normalize alpha by the window size (caffe does;
    our `lrn` op follows caffe) -> alpha is pre-multiplied by n here.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...graph.ir import Graph
from .fluid_proto import framework_pb2 as fp
from .shapes import eval_shape, spec

__all__ = ["from_fluid"]

_NCHW2NHWC = {0: 0, 1: 3, 2: 1, 3: 2}
_TO_NHWC = (0, 2, 3, 1)
_TO_NCHW = (0, 3, 1, 2)

_VT = fp.VarType
_DTYPES = {
    _VT.BOOL: np.dtype(np.bool_),
    _VT.INT16: np.dtype(np.int16),
    _VT.INT32: np.dtype(np.int32),
    _VT.INT64: np.dtype(np.int64),
    _VT.FP16: np.dtype(np.float16),
    _VT.FP32: np.dtype(np.float32),
    _VT.FP64: np.dtype(np.float64),
    _VT.UINT8: np.dtype(np.uint8),
    _VT.INT8: np.dtype(np.int8),
}

# ops that exist only for training / bookkeeping and carry through no data
_SKIP_OPS = {"assign", "share_data"}


def _read_lod_tensor(f) -> np.ndarray:
    """One LoDTensor in Paddle's SerializeToStream framing
    (`paddle/fluid/framework/lod_tensor.cc`)."""
    (_version,) = struct.unpack("<I", f.read(4))
    (lod_level,) = struct.unpack("<Q", f.read(8))
    for _ in range(lod_level):
        (nbytes,) = struct.unpack("<Q", f.read(8))
        f.read(nbytes)
    (_tensor_version,) = struct.unpack("<I", f.read(4))
    (desc_size,) = struct.unpack("<i", f.read(4))
    desc = fp.VarType.TensorDesc()
    desc.ParseFromString(f.read(desc_size))
    dtype = _DTYPES[desc.data_type]
    dims = tuple(int(d) for d in desc.dims)
    count = int(np.prod(dims)) if dims else 1
    arr = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype)
    return arr.reshape(dims).copy()


def _load_weights(model_dir: Optional[str], params_path: Optional[str],
                  names: List[str]) -> Dict[str, np.ndarray]:
    weights: Dict[str, np.ndarray] = {}
    if params_path:
        with open(params_path, "rb") as f:
            for name in sorted(names):
                weights[name] = _read_lod_tensor(f)
    elif model_dir:
        for name in names:
            p = os.path.join(model_dir, name)
            if os.path.exists(p):
                with open(p, "rb") as f:
                    weights[name] = _read_lod_tensor(f)
    return weights


def _attr_value(a: "fp.OpDesc.Attr") -> Any:
    t = a.type
    if t == fp.INT:
        return int(a.i)
    if t == fp.FLOAT:
        return float(a.f)
    if t == fp.STRING:
        return a.s
    if t == fp.INTS:
        return [int(v) for v in a.ints]
    if t == fp.FLOATS:
        return [float(v) for v in a.floats]
    if t == fp.STRINGS:
        return list(a.strings)
    if t == fp.BOOLEAN:
        return bool(a.b)
    if t == fp.BOOLEANS:
        return [bool(v) for v in a.bools]
    if t == fp.LONG:
        return int(a.l)
    if t == fp.LONGS:
        return [int(v) for v in a.longs]
    if t == fp.FLOAT64:
        return float(a.float64)
    if t == fp.FLOAT64S:
        return [float(v) for v in a.float64s]
    return None


class _Importer:
    def __init__(self, block: "fp.BlockDesc",
                 weights: Dict[str, np.ndarray], batch_size: int):
        self.block = block
        self.weights = weights
        self.batch_size = batch_size
        self.graph = Graph("fluid_model")
        self.edge: Dict[str, str] = {}      # fluid var name -> IR edge
        self.spec: Dict[str, torch.Tensor] = {}
        self.flat4d: Dict[str, Tuple[int, ...]] = {}  # var -> NCHW pre-flat
        self.vars = {v.name: v for v in block.vars}
        self._n = 0

    # ------------------------------------------------------------- plumbing
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
             outs: Optional[List[str]] = None, **attrs) -> Any:
        name = self.fresh(hint)
        n_out = len(outs) if outs else 1
        out_edges = [f"{name}:out{i}" if n_out > 1 else f"{name}:out"
                     for i in range(n_out)]
        node = self.graph.add_node(name, op, inputs, out_edges, **attrs)
        shapes = eval_shape(node, [self.spec[e] for e in inputs])
        for e, s in zip(out_edges, shapes):
            self.spec[e] = s
        if outs:
            for var, e in zip(outs, out_edges):
                self.edge[var] = e
        return out_edges[0] if n_out == 1 else out_edges

    def rank(self, var: str) -> int:
        return len(self.spec[self.edge[var]].shape)

    def nchw_shape(self, var: str) -> Tuple[int, ...]:
        s = self.spec[self.edge[var]].shape
        return tuple(s[i] for i in _TO_NCHW) if len(s) == 4 else tuple(s)

    def map_axis(self, var: str, axis: int) -> int:
        r = self.rank(var)
        if axis < 0:
            axis += r
        return _NCHW2NHWC[axis] if r == 4 else axis

    def var_dims(self, name: str) -> List[int]:
        v = self.vars[name]
        dims = [int(d) for d in v.type.lod_tensor.tensor.dims]
        return [self.batch_size if d in (-1, 0) else d for d in dims]

    def weight(self, op: "fp.OpDesc", slot: str, idx: int = 0) -> np.ndarray:
        name = _ins(op)[slot][idx]
        if name not in self.weights:
            raise ValueError(f"fluid var {name!r} ({slot} of {op.type}) "
                             "has no weight data")
        return self.weights[name]

    # ------------------------------------------------------------------ run
    def run(self) -> Graph:
        fetched = []
        for op in self.block.ops:
            ins, outs = _ins(op), _outs(op)
            if op.type == "feed":
                var = outs["Out"][0]
                dims = self.var_dims(var)
                if len(dims) == 4:
                    n, c, h, w = dims
                    e = self.graph.add_input(var, (n, h, w, c), "float32")
                else:
                    e = self.graph.add_input(var, tuple(dims), "float32")
                self.edge[var] = e
                self.spec[e] = spec(self.graph.input_specs[e][0], np.float32)
            elif op.type == "fetch":
                fetched.append(ins["X"][0])
            elif op.type in _SKIP_OPS:
                self.edge[outs["Out"][0]] = self.edge[ins["X"][0]]
            else:
                self.convert(op)
        for var in fetched:
            self.graph.mark_output(self.edge[var])
        if not fetched:
            consumers = self.graph.consumers()
            for e in dict.fromkeys(self.edge.values()):
                if e not in consumers and e not in self.graph.params \
                        and e not in self.graph.inputs:
                    self.graph.mark_output(e)
        self.graph.validate()
        return self.graph

    # ------------------------------------------------------------------ ops
    def convert(self, op: "fp.OpDesc") -> None:
        t = op.type
        ins, outs = _ins(op), _outs(op)
        attrs = {a.name: _attr_value(a) for a in op.attrs}

        def X(slot="X", i=0):
            return self.edge[ins[slot][i]]

        if t in ("conv2d", "depthwise_conv2d"):
            w = self.weight(op, "Filter")                      # OIHW
            sh, sw = attrs.get("strides", [1, 1])
            pads = attrs.get("paddings", [0, 0])
            ph, pw = (pads[0], pads[1]) if len(pads) <= 2 else \
                ((pads[0], pads[1]), (pads[2], pads[3]))       # t,b,l,r
            dh, dw = attrs.get("dilations", [1, 1])
            groups = int(attrs.get("groups", 1) or 1)
            if t == "depthwise_conv2d":
                groups = max(groups, w.shape[0] // max(w.shape[1], 1))
            e = self.emit(
                "conv2d", [X("Input"),
                           self.param("conv_w", w.transpose(2, 3, 1, 0))],
                "conv", strides=(int(sh), int(sw)), padding=(ph, pw),
                dilation=(int(dh), int(dw)), groups=groups, has_bias=False)
            self.edge[outs["Output"][0]] = e
        elif t == "conv2d_transpose":
            w = self.weight(op, "Filter")                      # (in, out, kh, kw)
            sh, sw = attrs.get("strides", [1, 1])
            ph, pw = attrs.get("paddings", [0, 0])[:2]
            e = self.emit(
                "deconv2d", [X("Input"),
                             self.param("deconv_w", w.transpose(2, 3, 0, 1))],
                "deconv", strides=(int(sh), int(sw)),
                padding=(int(ph), int(pw)),
                groups=int(attrs.get("groups", 1) or 1), has_bias=False)
            self.edge[outs["Output"][0]] = e
        elif t == "batch_norm":
            mean = self.weight(op, "Mean").reshape(-1)
            var = self.weight(op, "Variance").reshape(-1)
            gamma = self.weight(op, "Scale").reshape(-1)
            beta = self.weight(op, "Bias").reshape(-1)
            y = self.emit("batch_norm",
                          [X(), self.param("bn_mean", mean),
                           self.param("bn_var", var)],
                          "bn", eps=float(attrs.get("epsilon", 1e-5)))
            self.edge[outs["Y"][0]] = self.emit(
                "scale", [y, self.param("bn_g", gamma),
                          self.param("bn_b", beta)], "bn_scale")
        elif t == "mul":
            xvar = ins["X"][0]
            w = self.weights[ins["Y"][0]]
            if int(attrs.get("x_num_col_dims", 1)) != 1:
                raise NotImplementedError("mul with x_num_col_dims != 1")
            if self.rank(xvar) == 4:
                _, c, h, ww = self.nchw_shape(xvar)
                idx = np.arange(c * h * ww).reshape(c, h, ww)
                perm = idx.transpose(1, 2, 0).reshape(-1)
                w = np.asarray(w.reshape(c * h * ww, -1)[perm], order="C")
                x = self.emit("flatten", [X()], "flatten", axis=1)
            elif xvar in self.flat4d:
                _, c, h, ww = self.flat4d[xvar]
                idx = np.arange(c * h * ww).reshape(c, h, ww)
                perm = idx.transpose(1, 2, 0).reshape(-1)
                w = np.asarray(w.reshape(c * h * ww, -1)[perm], order="C")
                x = X()
            else:
                x = X()
            self.edge[outs["Out"][0]] = self.emit(
                "dense", [x, self.param("fc_w", w)], "fc", has_bias=False)
        elif t in ("matmul", "matmul_v2"):
            ta = attrs.get("transpose_X", attrs.get("trans_x", False))
            tb = attrs.get("transpose_Y", attrs.get("trans_y", False))
            inputs = []
            for slot in ("X", "Y"):
                var = ins[slot][0]
                if var in self.weights:
                    inputs.append(self.param("mm_w", self.weights[var]))
                else:
                    inputs.append(self.edge[var])
            kw = {}
            alpha = float(attrs.get("alpha", 1.0))
            if alpha != 1.0:
                kw["coeff"] = alpha
            self.edge[outs["Out"][0]] = self.emit(
                "matmul", inputs, "matmul", transpose_a=bool(ta),
                transpose_b=bool(tb), **kw)
        elif t in ("elementwise_add", "elementwise_sub", "elementwise_mul",
                   "elementwise_div", "elementwise_max", "elementwise_min"):
            kind = t.split("_")[1]
            yvar = ins["Y"][0]
            if yvar in self.weights and self.weights[yvar].ndim == 1 \
                    and self.rank(ins["X"][0]) > 1:
                b = self.weights[yvar].astype(np.float32)
                if kind == "add":
                    g, bb = np.ones_like(b), b
                elif kind == "sub":
                    g, bb = np.ones_like(b), -b
                elif kind == "mul":
                    g, bb = b, np.zeros_like(b)
                elif kind == "div":
                    g, bb = 1.0 / b, np.zeros_like(b)
                else:
                    raise NotImplementedError(f"{t} against a 1-D param")
                self.edge[outs["Out"][0]] = self.emit(
                    "scale", [X(), self.param("ew_g", g),
                              self.param("ew_b", bb)], "bias")
                return
            b_edge = (self.param("ew_y", self.weights[yvar])
                      if yvar in self.weights else self.edge[yvar])
            mode = {"add": "sum", "sub": "sub", "mul": "prod",
                    "div": "div", "max": "max", "min": "min"}[kind]
            self.edge[outs["Out"][0]] = self.emit(
                "eltwise", [X(), b_edge], "elt", mode=mode)
        elif t == "pool2d":
            mode = "avg" if attrs.get("pooling_type") == "avg" else "max"
            adaptive = bool(attrs.get("adaptive", False))
            ksize = [int(k) for k in attrs.get("ksize", [1, 1])]
            if attrs.get("global_pooling") or (adaptive and ksize == [1, 1]):
                self.edge[outs["Out"][0]] = self.emit(
                    "pool2d", [X()], "gap", mode=mode, global_pooling=True)
                return
            if adaptive:
                raise NotImplementedError("adaptive pool2d with ksize != 1")
            sh, sw = attrs.get("strides", [1, 1])
            ph, pw = attrs.get("paddings", [0, 0])[:2]
            self.edge[outs["Out"][0]] = self.emit(
                "pool2d", [X()], "pool", mode=mode,
                window=(ksize[0], ksize[1]), strides=(int(sh), int(sw)),
                padding=(int(ph), int(pw)),
                ceil_mode=bool(attrs.get("ceil_mode", False)),
                exclusive=bool(attrs.get("exclusive", True)))
        elif t in ("relu", "sigmoid", "tanh", "sqrt", "abs", "exp", "log",
                   "relu6", "leaky_relu", "swish", "hard_swish", "gelu",
                   "softplus"):
            act = {"relu": "relu", "sigmoid": "sigmoid", "tanh": "tanh",
                   "abs": "abs", "relu6": "relu6", "gelu": "gelu",
                   "softplus": "softplus", "swish": "swish"}.get(t)
            if t == "exp":
                self.edge[outs["Out"][0]] = self.emit("exp", [X()], "exp")
            elif t == "log":
                self.edge[outs["Out"][0]] = self.emit("log", [X()], "log")
            elif t == "sqrt":
                self.edge[outs["Out"][0]] = self.emit(
                    "power", [X()], "sqrt", power=0.5)
            elif t == "leaky_relu":
                self.edge[outs["Out"][0]] = self.emit(
                    "activation", [X()], "lrelu", activation="leaky_relu",
                    act_alpha=float(attrs.get("alpha", 0.02)))
            elif t == "swish":
                self.edge[outs["Out"][0]] = self.emit(
                    "activation", [X()], "swish", activation="swish",
                    act_alpha=float(attrs.get("beta", 1.0)))
            elif t == "hard_swish":
                # x * relu6(x + 3) / 6 with fluid's (threshold, scale, offset)
                th = float(attrs.get("threshold", 6.0))
                sc = float(attrs.get("scale", 6.0))
                off = float(attrs.get("offset", 3.0))
                g = self.emit("power", [X()], "hs_shift", shift=off)
                g = self.emit("activation", [g], "hs_clip",
                              activation="clipped_relu", act_alpha=th)
                g = self.emit("power", [g], "hs_scale", scale=1.0 / sc)
                self.edge[outs["Out"][0]] = self.emit(
                    "eltwise", [X(), g], "hs_mul", mode="prod")
            elif t == "relu6":
                th = float(attrs.get("threshold", 6.0))
                if th == 6.0:
                    self.edge[outs["Out"][0]] = self.emit(
                        "activation", [X()], "relu6", activation="relu6")
                else:
                    self.edge[outs["Out"][0]] = self.emit(
                        "activation", [X()], "crelu",
                        activation="clipped_relu", act_alpha=th)
            else:
                self.edge[outs["Out"][0]] = self.emit(
                    "activation", [X()], act, activation=act)
        elif t == "prelu":
            alpha = self.weight(op, "Alpha").reshape(-1)
            self.edge[outs["Out"][0]] = self.emit(
                "prelu", [X(), self.param("prelu_w", alpha)], "prelu",
                channel_shared=attrs.get("mode", b"all") in ("all", b"all"))
        elif t == "softmax":
            axis = int(attrs.get("axis", -1))
            self.edge[outs["Out"][0]] = self.emit(
                "softmax", [X()], "softmax",
                axis=self.map_axis(ins["X"][0], axis))
        elif t == "scale":
            s = float(attrs.get("scale", 1.0))
            b = float(attrs.get("bias", 0.0))
            if not attrs.get("bias_after_scale", True):
                b = s * b
            self.edge[outs["Out"][0]] = self.emit(
                "power", [X()], "scale", scale=s, shift=b)
        elif t == "dropout":
            impl = attrs.get("dropout_implementation", b"downgrade_in_infer")
            impl = impl.decode() if isinstance(impl, bytes) else impl
            if impl == "downgrade_in_infer":
                p = float(attrs.get("dropout_prob", 0.0))
                self.edge[outs["Out"][0]] = self.emit(
                    "power", [X()], "dropout", scale=1.0 - p)
            else:
                self.edge[outs["Out"][0]] = self.edge[ins["X"][0]]
        elif t == "concat":
            axis = self.map_axis(ins["X"][0], int(attrs.get("axis", 0)))
            self.edge[outs["Out"][0]] = self.emit(
                "concat", [self.edge[v] for v in ins["X"]], "cat", axis=axis)
        elif t == "split":
            xvar = ins["X"][0]
            axis = self.map_axis(xvar, int(attrs.get("axis", 0)))
            sections = attrs.get("sections") or []
            kw = {}
            if sections:
                pts = np.cumsum(sections[:-1]).tolist()
                kw["slice_points"] = [int(p) for p in pts]
            self.emit("slice", [self.edge[xvar]], "split", axis=axis,
                      outs=outs["Out"], **kw)
        elif t in ("transpose", "transpose2"):
            order = [int(a) for a in attrs["axis"]]
            if self.rank(ins["X"][0]) == 4:
                order = [_TO_NCHW[order[_TO_NHWC[k]]] for k in range(4)]
            self.edge[outs["Out"][0]] = self.emit(
                "permute", [X()], "perm", order=tuple(order))
        elif t in ("reshape", "reshape2"):
            shape = [int(s) for s in attrs["shape"]]
            xvar = ins["X"][0]
            src = list(self.nchw_shape(xvar))
            resolved = [src[i] if d == 0 else d for i, d in enumerate(shape)]
            if -1 in resolved:
                known = int(np.prod([d for d in resolved if d != -1]))
                resolved[resolved.index(-1)] = int(np.prod(src)) // known
            if self.rank(xvar) == 4:
                if len(resolved) == 2 and resolved[0] == src[0]:
                    self.flat4d[outs["Out"][0]] = tuple(src)
                    self.edge[outs["Out"][0]] = self.emit(
                        "flatten", [X()], "flatten", axis=1)
                    return
                raise NotImplementedError(
                    f"reshape of 4D feature map to {resolved}")
            if len(resolved) == 4:
                raise NotImplementedError("reshape to 4D feature map")
            self.edge[outs["Out"][0]] = self.emit(
                "reshape", [X()], "reshape", shape=resolved)
        elif t in ("flatten", "flatten2", "flatten_contiguous_range"):
            xvar = ins["X"][0]
            axis = int(attrs.get("axis", attrs.get("start_axis", 1)))
            if t == "flatten_contiguous_range" and \
                    int(attrs.get("stop_axis", -1)) not in (-1, self.rank(xvar) - 1):
                raise NotImplementedError("partial flatten stop_axis")
            if self.rank(xvar) == 4 and axis == 1:
                self.flat4d[outs["Out"][0]] = self.nchw_shape(xvar)
            self.edge[outs["Out"][0]] = self.emit(
                "flatten", [X()], "flatten", axis=max(axis, 1))
        elif t in ("lookup_table", "lookup_table_v2"):
            table = self.weight(op, "W")
            ids = self.edge[ins["Ids"][0]]
            if t == "lookup_table" and self.spec[ids].shape[-1] == 1:
                r = len(self.spec[ids].shape)
                ids = self.emit("reshape", [ids], "squeeze",
                                shape=list(self.spec[ids].shape[:-1]))
            self.edge[outs["Out"][0]] = self.emit(
                "embedding", [ids, self.param("emb_w", table)], "emb",
                padding_idx=int(attrs.get("padding_idx", -1)))
        elif t == "layer_norm":
            gamma = self.weight(op, "Scale").reshape(-1)
            beta = self.weight(op, "Bias").reshape(-1)
            self.edge[outs["Y"][0]] = self.emit(
                "layer_norm", [X(), self.param("ln_g", gamma),
                               self.param("ln_b", beta)], "ln",
                eps=float(attrs.get("epsilon", 1e-5)),
                begin_norm_axis=int(attrs.get("begin_norm_axis", 1)))
        elif t == "lrn":
            n = int(attrs.get("n", 5))
            self.edge[outs["Out"][0]] = self.emit(
                "lrn", [X()], "lrn", local_size=n,
                alpha=float(attrs.get("alpha", 1e-4)) * n,  # ours divides by n
                beta=float(attrs.get("beta", 0.75)),
                k=float(attrs.get("k", 1.0)))
        elif t in ("bilinear_interp", "bilinear_interp_v2",
                   "nearest_interp", "nearest_interp_v2"):
            method = "nearest" if t.startswith("nearest") else "bilinear"
            kw: Dict[str, Any] = {"method": method}
            oh, ow = int(attrs.get("out_h", 0)), int(attrs.get("out_w", 0))
            if oh > 0 and ow > 0:
                kw["out_hw"] = (oh, ow)
            else:
                sc = attrs.get("scale", 1.0)
                sc = sc[0] if isinstance(sc, list) and sc else sc
                kw["scale"] = float(sc)
            kw["align_corners"] = bool(attrs.get("align_corners", True))
            self.edge[outs["Out"][0]] = self.emit("resize", [X()], "resize",
                                                  **kw)
        elif t == "pixel_shuffle":
            self.edge[outs["Out"][0]] = self.emit(
                "pixel_shuffle", [X()], "ps",
                upscale_factor=int(attrs.get("upscale_factor", 2)))
        elif t == "shuffle_channel":
            self.edge[outs["Out"][0]] = self.emit(
                "shuffle_channel", [X()], "shuf",
                group=int(attrs.get("group", 1)))
        elif t == "affine_channel":
            g = self.weight(op, "Scale").reshape(-1)
            b = self.weight(op, "Bias").reshape(-1)
            self.edge[outs["Out"][0]] = self.emit(
                "scale", [X(), self.param("ac_g", g),
                          self.param("ac_b", b)], "affine")
        elif t == "norm":
            # fluid norm = l2-normalize along `axis` (channel for conv maps)
            axis = int(attrs.get("axis", 1))
            if self.rank(ins["X"][0]) == 4 and axis not in (1, -3):
                raise NotImplementedError("norm along a spatial axis")
            self.edge[outs["Out"][0]] = self.emit(
                "l2_normalize", [X()], "norm", across_spatial=False,
                eps=float(attrs.get("epsilon", 1e-10)))
        elif t == "slice":
            xvar = ins["Input"][0]
            axes = [self.map_axis(xvar, a) for a in attrs["axes"]]
            self.edge[outs["Out"][0]] = self.emit(
                "slice_v2", [self.edge[xvar]], "slice", axes=axes,
                starts=[int(s) for s in attrs["starts"]],
                ends=[int(e) for e in attrs["ends"]])
        elif t == "cast":
            np_dtype = {0: "bool", 1: "int16", 2: "int32", 3: "int64",
                        4: "float16", 5: "float32", 6: "float64"}[
                            int(attrs["out_dtype"])]
            self.edge[outs["Out"][0]] = self.emit("cast", [X()], "cast",
                                                  dtype=np_dtype)
        elif t == "prior_box":
            img_dims = self.var_dims(ins["Image"][0])
            kw = dict(
                min_sizes=[float(s) for s in attrs.get("min_sizes", [])],
                max_sizes=[float(s) for s in attrs.get("max_sizes", [])],
                aspect_ratios=[float(a)
                               for a in attrs.get("aspect_ratios", [])],
                flip=bool(attrs.get("flip", False)),
                clip=bool(attrs.get("clip", False)),
                img_hw=(img_dims[2], img_dims[3]),
                offset=float(attrs.get("offset", 0.5)))
            if attrs.get("variances"):
                kw["variances"] = [float(v) for v in attrs["variances"]]
            if attrs.get("step_h") or attrs.get("step_w"):
                kw["step"] = float(attrs.get("step_h") or attrs["step_w"])
            self.emit("priorbox", [X("Input")], "priorbox",
                      outs=[outs["Boxes"][0]], **kw)
            # Variances output is folded into the priorbox edge (row 2)
            if "Variances" in outs:
                self.edge[outs["Variances"][0]] = self.edge[outs["Boxes"][0]]
        else:
            raise NotImplementedError(
                f"fluid op {t!r} not supported by the importer")


def _ins(op: "fp.OpDesc") -> Dict[str, List[str]]:
    return {v.parameter: list(v.arguments) for v in op.inputs if v.arguments}


def _outs(op: "fp.OpDesc") -> Dict[str, List[str]]:
    return {v.parameter: list(v.arguments) for v in op.outputs if v.arguments}


def from_fluid(model_path: str, params_path: Optional[str] = None,
               batch_size: int = 1) -> Graph:
    """Import a Paddle Fluid inference model.

    model_path: directory containing `__model__` (+ one file per
    persistable var), or a path to the ProgramDesc file itself.
    params_path: combined params file (when the model was saved with
    `params_filename=`); vars are read in sorted-name order.
    batch_size resolves -1/0 leading dims of feed vars.
    """
    if os.path.isdir(model_path):
        model_file = os.path.join(model_path, "__model__")
        model_dir = model_path
    else:
        model_file = model_path
        model_dir = os.path.dirname(model_path)
    prog = fp.ProgramDesc()
    with open(model_file, "rb") as f:
        prog.ParseFromString(f.read())
    block = prog.blocks[0]
    persistable = [v.name for v in block.vars
                   if v.persistable and v.type.type == _VT.LOD_TENSOR
                   and v.name not in ("feed", "fetch")]
    weights = _load_weights(model_dir, params_path, persistable)
    return _Importer(block, weights, batch_size).run()
