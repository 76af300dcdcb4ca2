"""Caffe frontend: deploy.prototxt (+ .caffemodel) -> anakin_tpu_torch Graph.

The port of `anakin_tpu/tools/converter/caffe_frontend.py`: the same graph,
node for node and param for param, from the same source; shapes come from
the port's ops run on meta tensors (`shapes.py`) where the JAX frontend
calls `jax.eval_shape`.

Parity target: the reference converter's Caffe parser
(`tools/external_converter_v2/parser/caffe/parser_caffe.py` +
`caffe_layer_param_transmit.py`) — Caffe was Anakin's primary source
framework (SSD/VGG/ResNet deployments).

Same layout policy as the torch/ONNX frontends: NCHW -> NHWC at import
(conv weights permuted OIHW->HWIO, channel axes remapped, InnerProduct on
a 4D bottom gets the implicit caffe flatten plus the HWC row fixup on its
weight so fp32 outputs match caffe numerics).

Caffe specifics handled here:
  * in-place layers (top == bottom) rebind the blob name;
  * TRAIN-phase / data / loss layers are skipped;
  * BatchNorm's blobs[2] scale factor divides mean/var;
  * the SSD fork's Permute/Normalize/PriorBox/DetectionOutput layers map
    onto `ops/detection.py`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from google.protobuf import text_format

from ...graph.ir import Graph
from .caffe_proto import caffe_pb2 as cp2
from .shapes import eval_shape, spec

__all__ = ["from_caffe"]

_NCHW2NHWC = {0: 0, 1: 3, 2: 1, 3: 2}
_TO_NHWC = (0, 2, 3, 1)
_TO_NCHW = (0, 3, 1, 2)

_SKIP_TYPES = {
    "Data", "ImageData", "HDF5Data", "WindowData", "MemoryData", "DummyData",
    "Accuracy", "SoftmaxWithLoss", "EuclideanLoss", "SigmoidCrossEntropyLoss",
    "Silence", "Python",
}


def blob_to_numpy(b: "cp2.BlobProto") -> np.ndarray:
    data = np.array(b.data, dtype=np.float32)
    if b.shape.dim:
        return data.reshape(tuple(b.shape.dim))
    dims = [d for d in (b.num, b.channels, b.height, b.width)]
    if any(dims):
        return data.reshape(tuple(dims))
    return data


def _spatial(p, base: str, field: str, default: int = 0) -> Tuple[int, int]:
    """Resolve caffe's (X | X_h/X_w) spatial param convention; `field` is
    the non-_h/_w field (repeated in ConvolutionParameter, scalar in
    PoolingParameter)."""
    h = getattr(p, base + "_h", 0)
    w = getattr(p, base + "_w", 0)
    if h or w:
        return int(h), int(w)
    v = getattr(p, field)
    rep = list(v) if hasattr(v, "__len__") else ([int(v)] if v else [])
    if len(rep) >= 2:
        return int(rep[0]), int(rep[1])
    if len(rep) == 1:
        return int(rep[0]), int(rep[0])
    return default, default


class _Importer:
    def __init__(self, net: "cp2.NetParameter",
                 weights: Dict[str, List[np.ndarray]]):
        self.net = net
        self.weights = weights
        self.graph = Graph(net.name or "caffe_model")
        self.edge: Dict[str, str] = {}      # caffe blob name -> IR edge
        self.spec: Dict[str, torch.Tensor] = {}
        self.flat4d: Dict[str, Tuple[int, ...]] = {}  # blob -> NCHW pre-flat
        self.img_hw: Optional[Tuple[int, int]] = None  # net input H, W
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
             tops: Optional[List[str]] = None, **attrs) -> Any:
        name = self.fresh(hint)
        n_out = len(tops) if tops else 1
        out_edges = [f"{name}:out{i}" if n_out > 1 else f"{name}:out"
                     for i in range(n_out)]
        node = self.graph.add_node(name, op, inputs, out_edges, **attrs)
        outs = eval_shape(node, [self.spec[e] for e in inputs])
        for e, s in zip(out_edges, outs):
            self.spec[e] = s
        if tops:
            for blob, e in zip(tops, out_edges):
                self.edge[blob] = e
        return out_edges[0] if n_out == 1 else out_edges

    def rank(self, blob: str) -> int:
        return len(self.spec[self.edge[blob]].shape)

    def nchw_shape(self, blob: str) -> Tuple[int, ...]:
        s = self.spec[self.edge[blob]].shape
        if len(s) == 4:
            return tuple(s[i] for i in _TO_NCHW)
        return tuple(s)

    def map_axis(self, blob: str, axis: int) -> int:
        r = self.rank(blob)
        if axis < 0:
            axis += r
        return _NCHW2NHWC[axis] if r == 4 else axis

    def add_input(self, blob: str, dims: List[int]) -> None:
        if len(dims) == 4:
            n, c, h, w = dims
            e = self.graph.add_input(blob, (n, h, w, c), "float32")
            if self.img_hw is None:
                self.img_hw = (h, w)
        else:
            e = self.graph.add_input(blob, tuple(dims), "float32")
        self.edge[blob] = e
        self.spec[e] = spec(self.graph.input_specs[e][0], np.float32)

    # --------------------------------------------------------------- layers
    def convert(self, l: "cp2.LayerParameter") -> None:
        t = l.type
        blobs = self.weights.get(l.name) or [blob_to_numpy(b)
                                             for b in l.blobs]
        bottom = list(l.bottom)
        top = list(l.top)

        def X(i=0):
            return self.edge[bottom[i]]

        if t == "Input":
            for i, blob in enumerate(top):
                self.add_input(blob, list(l.input_param.shape[i].dim))
            return
        if t == "Convolution" or t == "Deconvolution":
            p = l.convolution_param
            w = blobs[0]
            kh, kw = _spatial(p, "kernel", "kernel_size", w.shape[-2])
            sh, sw = _spatial(p, "stride", "stride", 1)
            ph, pw = _spatial(p, "pad", "pad", 0)
            dil = list(p.dilation) or [1]
            has_bias = p.bias_term and len(blobs) > 1
            if t == "Convolution":
                ins = [X(), self.param("conv_w", w.transpose(2, 3, 1, 0))]
                if has_bias:
                    ins.append(self.param("conv_b", blobs[1]))
                self.emit("conv2d", ins, "conv", strides=(sh, sw),
                          padding=(ph, pw), dilation=(dil[0], dil[-1]),
                          groups=int(p.group), has_bias=has_bias, tops=top)
            else:
                ins = [X(), self.param("deconv_w", w.transpose(2, 3, 0, 1))]
                if has_bias:
                    ins.append(self.param("deconv_b", blobs[1]))
                self.emit("deconv2d", ins, "deconv", strides=(sh, sw),
                          padding=(ph, pw), groups=int(p.group),
                          has_bias=has_bias, tops=top)
        elif t == "Pooling":
            p = l.pooling_param
            mode = "max" if p.pool == cp2.PoolingParameter.MAX else "avg"
            if p.global_pooling:
                self.emit("pool2d", [X()], "gap", mode=mode,
                          global_pooling=True, tops=top)
                return
            kh, kw = _spatial(p, "kernel", "kernel_size", int(p.kernel_size))
            sh, sw = _spatial(p, "stride", "stride", int(p.stride))
            ph, pw = _spatial(p, "pad", "pad", int(p.pad))
            self.emit("pool2d", [X()], "pool", mode=mode, window=(kh, kw),
                      strides=(sh, sw), padding=(ph, pw),
                      ceil_mode=p.round_mode == cp2.PoolingParameter.CEIL,
                      exclusive=False, tops=top)
        elif t == "InnerProduct":
            p = l.inner_product_param
            w = blobs[0].reshape(int(p.num_output), -1)
            if not p.transpose:
                w = w.T                                   # (in, out)
            if self.rank(bottom[0]) == 4 and p.axis == 1:
                # caffe implicitly flattens the 4D bottom from axis 1
                pre = self.nchw_shape(bottom[0])
                _, c, h, ww = pre
                idx = np.arange(c * h * ww).reshape(c, h, ww)
                perm = idx.transpose(1, 2, 0).reshape(-1)
                w = np.asarray(w[perm], order="C")
                x = self.emit("flatten", [X()], "flatten", axis=1)
            elif bottom[0] in self.flat4d:
                _, c, h, ww = self.flat4d[bottom[0]]
                idx = np.arange(c * h * ww).reshape(c, h, ww)
                perm = idx.transpose(1, 2, 0).reshape(-1)
                w = np.asarray(w[perm], order="C")
                x = X()
            else:
                x = X()
            ins = [x, self.param("fc_w", w)]
            has_bias = p.bias_term and len(blobs) > 1
            if has_bias:
                ins.append(self.param("fc_b", blobs[1].reshape(-1)))
            self.emit("dense", ins, "fc", has_bias=has_bias, tops=top)
        elif t == "BatchNorm":
            mean, var = blobs[0].reshape(-1), blobs[1].reshape(-1)
            if len(blobs) > 2:
                sf = float(blobs[2].reshape(-1)[0])
                if sf != 0:
                    mean, var = mean / sf, var / sf
            self.emit("batch_norm",
                      [X(), self.param("bn_mean", mean),
                       self.param("bn_var", var)],
                      "bn", eps=float(l.batch_norm_param.eps), tops=top)
        elif t == "Scale":
            p = l.scale_param
            if len(bottom) == 2:
                self.emit("eltwise", [X(0), X(1)], "scale2", mode="prod",
                          tops=top)
                return
            g = blobs[0].reshape(-1)
            if p.bias_term and len(blobs) > 1:
                b = blobs[1].reshape(-1)
            else:
                b = np.zeros_like(g)
            self.emit("scale", [X(), self.param("sc_g", g),
                                self.param("sc_b", b)], "scale", tops=top)
        elif t == "Bias":
            b = blobs[0].reshape(-1)
            self.emit("scale", [X(), self.param("bias_g", np.ones_like(b)),
                                self.param("bias_b", b)], "bias", tops=top)
        elif t == "ReLU":
            slope = float(l.relu_param.negative_slope)
            if slope:
                self.emit("activation", [X()], "lrelu",
                          activation="leaky_relu", act_alpha=slope, tops=top)
            else:
                self.emit("activation", [X()], "relu", activation="relu",
                          tops=top)
        elif t in ("Sigmoid", "TanH", "AbsVal", "BNLL"):
            act = {"Sigmoid": "sigmoid", "TanH": "tanh", "AbsVal": "abs",
                   "BNLL": "softplus"}[t]
            self.emit("activation", [X()], "act", activation=act, tops=top)
        elif t == "ELU":
            self.emit("activation", [X()], "elu", activation="elu",
                      act_alpha=float(l.elu_param.alpha), tops=top)
        elif t == "PReLU":
            s = blobs[0].reshape(-1)
            self.emit("prelu", [X(), self.param("prelu_w", s)], "prelu",
                      channel_shared=bool(l.prelu_param.channel_shared),
                      tops=top)
        elif t == "Power":
            p = l.power_param
            self.emit("power", [X()], "pow", power=float(p.power),
                      scale=float(p.scale), shift=float(p.shift), tops=top)
        elif t == "Exp":
            p = l.exp_param
            y = X()
            if p.scale != 1.0 or p.shift != 0.0:
                y = self.emit("power", [y], "exp_lin", scale=float(p.scale),
                              shift=float(p.shift))
            if p.base > 0:
                y = self.emit("power", [y], "exp_base",
                              scale=float(np.log(p.base)))
            self.edge[top[0]] = self.emit("exp", [y], "exp")
        elif t == "Log":
            p = l.log_param
            y = X()
            if p.scale != 1.0 or p.shift != 0.0:
                y = self.emit("power", [y], "log_lin", scale=float(p.scale),
                              shift=float(p.shift))
            y = self.emit("log", [y], "log")
            if p.base > 0:
                y = self.emit("power", [y], "log_base",
                              scale=float(1.0 / np.log(p.base)))
            self.edge[top[0]] = y
        elif t == "LRN":
            p = l.lrn_param
            if p.norm_region != cp2.LRNParameter.ACROSS_CHANNELS:
                raise NotImplementedError("WITHIN_CHANNEL LRN")
            self.emit("lrn", [X()], "lrn", local_size=int(p.local_size),
                      alpha=float(p.alpha), beta=float(p.beta),
                      k=float(p.k), tops=top)
        elif t == "Concat":
            axis = l.concat_param.axis
            self.emit("concat", [X(i) for i in range(len(bottom))], "cat",
                      axis=self.map_axis(bottom[0], axis), tops=top)
        elif t == "Eltwise":
            p = l.eltwise_param
            mode = {cp2.EltwiseParameter.PROD: "prod",
                    cp2.EltwiseParameter.SUM: "sum",
                    cp2.EltwiseParameter.MAX: "max"}[p.operation]
            attrs = {}
            if list(p.coeff):
                attrs["coeffs"] = [float(c) for c in p.coeff]
            self.emit("eltwise", [X(i) for i in range(len(bottom))], "elt",
                      mode=mode, tops=top, **attrs)
        elif t == "Softmax":
            axis = self.map_axis(bottom[0], l.softmax_param.axis)
            self.emit("softmax", [X()], "softmax", axis=axis, tops=top)
        elif t == "Flatten":
            p = l.flatten_param
            if p.end_axis not in (-1, self.rank(bottom[0]) - 1):
                raise NotImplementedError("partial Flatten end_axis")
            if self.rank(bottom[0]) == 4 and p.axis == 1:
                self.flat4d[top[0]] = self.nchw_shape(bottom[0])
            self.emit("flatten", [X()], "flatten", axis=max(int(p.axis), 1),
                      tops=top)
        elif t == "Reshape":
            p = l.reshape_param
            if p.axis != 0 or p.num_axes != -1:
                raise NotImplementedError("partial Reshape axis/num_axes")
            dims = list(p.shape.dim)
            src = list(self.nchw_shape(bottom[0]))
            resolved = [src[i] if d == 0 else int(d)
                        for i, d in enumerate(dims)]
            if -1 in resolved:
                known = int(np.prod([d for d in resolved if d != -1]))
                resolved[resolved.index(-1)] = int(np.prod(src)) // known
            if self.rank(bottom[0]) == 4:
                if len(resolved) == 2 and resolved[0] == src[0]:
                    self.flat4d[top[0]] = tuple(src)
                    self.emit("flatten", [X()], "flatten", axis=1, tops=top)
                    return
                raise NotImplementedError(
                    f"Reshape of 4D feature map to {resolved}")
            if len(resolved) == 4:
                raise NotImplementedError("Reshape to 4D feature map")
            self.emit("reshape", [X()], "reshape", shape=resolved, tops=top)
        elif t == "Slice":
            p = l.slice_param
            axis = self.map_axis(bottom[0], int(p.axis))
            attrs = {}
            if list(p.slice_point):
                attrs["slice_points"] = [int(s) for s in p.slice_point]
            self.emit("slice", [X()], "slice", axis=axis, tops=top, **attrs)
        elif t == "Split":
            e = X()
            for blob in top:
                self.edge[blob] = e
                if bottom[0] in self.flat4d:
                    self.flat4d[blob] = self.flat4d[bottom[0]]
        elif t == "Dropout":
            self.edge[top[0]] = X()
            if bottom[0] in self.flat4d:
                self.flat4d[top[0]] = self.flat4d[bottom[0]]
        elif t == "Crop":
            # both shapes are static at import, so caffe's ref-tensor crop
            # lowers to an explicit slice (the ref bottom is not consumed)
            p = l.crop_param
            caxis = int(p.axis)
            src = self.nchw_shape(bottom[0])
            ref = self.nchw_shape(bottom[1])
            offs = [int(o) for o in p.offset] or [0]
            n_axes = len(src) - caxis
            if len(offs) == 1:
                offs = offs * n_axes
            axes, starts, ends = [], [], []
            for i, a in enumerate(range(caxis, len(src))):
                axes.append(self.map_axis(bottom[0], a))
                starts.append(offs[i])
                ends.append(offs[i] + ref[a])
            self.emit("slice_v2", [X(0)], "crop", axes=axes, starts=starts,
                      ends=ends, tops=top)
        elif t == "ArgMax":
            p = l.argmax_param
            axis = (self.map_axis(bottom[0], int(p.axis))
                    if p.HasField("axis") else None)
            if axis is None:
                raise NotImplementedError("ArgMax over flattened tail")
            self.emit("argmax", [X()], "argmax", axis=axis,
                      out_max_val=bool(p.out_max_val), tops=top)
        elif t == "Reduction":
            p = l.reduction_param
            r = self.rank(bottom[0])
            axes_nchw = list(range(int(p.axis), r))
            axes = [self.map_axis(bottom[0], a) for a in axes_nchw]
            mode = {cp2.ReductionParameter.SUM: "sum",
                    cp2.ReductionParameter.MEAN: "mean"}.get(p.operation)
            if mode is None:
                raise NotImplementedError("Reduction ASUM/SUMSQ")
            y = self.emit("reduce", [X()], "reduce", mode=mode, axes=axes,
                          keep_dims=False)
            if p.coeff != 1.0:
                y = self.emit("power", [y], "coeff", scale=float(p.coeff))
            self.edge[top[0]] = y
        elif t == "Tile":
            p = l.tile_param
            r = self.rank(bottom[0])
            times = [1] * r
            times[self.map_axis(bottom[0], int(p.axis))] = int(p.tiles)
            self.emit("expand", [X()], "tile", expand_times=times, tops=top)
        elif t == "MVN":
            p = l.mvn_param
            self.emit("mvn", [X()], "mvn",
                      normalize_variance=bool(p.normalize_variance),
                      across_channels=bool(p.across_channels),
                      eps=float(p.eps), tops=top)
        elif t == "Permute":
            order = [int(o) for o in l.permute_param.order]
            if self.rank(bottom[0]) == 4:
                order = [_TO_NCHW[order[_TO_NHWC[k]]] for k in range(4)]
            self.emit("permute", [X()], "perm", order=tuple(order), tops=top)
        elif t == "Normalize":
            p = l.norm_param
            scale = blobs[0].reshape(-1) if blobs else None
            ins = [X()]
            if scale is not None:
                if p.channel_shared and scale.size == 1:
                    scale = np.full(
                        (self.spec[X()].shape[-1],), float(scale[0]),
                        np.float32)
                ins.append(self.param("norm_scale", scale))
            self.emit("l2_normalize", ins, "norm",
                      across_spatial=bool(p.across_spatial),
                      eps=float(p.eps), tops=top)
        elif t == "PriorBox":
            p = l.prior_box_param
            if p.img_h or p.img_w:
                img_hw = (int(p.img_h), int(p.img_w))
            elif p.img_size:
                img_hw = (int(p.img_size), int(p.img_size))
            else:
                img_hw = self.img_hw
            attrs = dict(
                min_sizes=[float(s) for s in p.min_size],
                max_sizes=[float(s) for s in p.max_size],
                aspect_ratios=[float(a) for a in p.aspect_ratio],
                flip=bool(p.flip), clip=bool(p.clip), img_hw=img_hw,
                offset=float(p.offset))
            if list(p.variance):
                attrs["variances"] = [float(v) for v in p.variance]
            if p.step:
                attrs["step"] = float(p.step)
            self.emit("priorbox", [X(0)], "priorbox", tops=top, **attrs)
        elif t == "DetectionOutput":
            p = l.detection_output_param
            if p.code_type != cp2.DetectionOutputParameter.CENTER_SIZE:
                raise NotImplementedError("DetectionOutput CORNER code type")
            self.emit(
                "detection_output", [X(0), X(1), X(2)], "det", tops=top,
                num_classes=int(p.num_classes),
                background_id=int(p.background_label_id),
                keep_top_k=int(p.keep_top_k if p.keep_top_k > 0 else 200),
                top_k=int(p.nms_param.top_k or 100),
                nms_thresh=float(p.nms_param.nms_threshold),
                conf_thresh=float(p.confidence_threshold or 0.01),
                share_location=bool(p.share_location),
                variance_encoded_in_target=bool(
                    p.variance_encoded_in_target))
        else:
            raise NotImplementedError(
                f"caffe layer type {t!r} not supported by the importer")

    # ----------------------------------------------------------------- main
    def run(self) -> Graph:
        # net-level inputs (old style)
        for i, blob in enumerate(self.net.input):
            if self.net.input_shape:
                dims = list(self.net.input_shape[i].dim)
            else:
                dims = list(self.net.input_dim[i * 4:(i + 1) * 4])
            self.add_input(blob, dims)
        for l in self.net.layer:
            if l.type in _SKIP_TYPES:
                continue
            if any(r.phase == cp2.TRAIN for r in l.include):
                continue
            self.convert(l)
        # outputs = edges nobody consumes (in-place caffe layers rebind blob
        # names, so leaf detection must run on IR edges, not blob names)
        consumers = self.graph.consumers()
        for e in dict.fromkeys(self.edge.values()):
            if e not in consumers and e not in self.graph.params \
                    and e not in self.graph.inputs:
                self.graph.mark_output(e)
        self.graph.validate()
        return self.graph


def from_caffe(prototxt: str, caffemodel: Optional[str] = None) -> Graph:
    """Import a Caffe deploy prototxt (+ optional caffemodel weights).

    Layer params come from the prototxt (text format, unknown fields
    tolerated); weights are matched by layer name from the binary
    caffemodel.  Layers missing from the caffemodel fall back to blobs
    embedded in the prototxt (rare, but used by tests).
    """
    net = cp2.NetParameter()
    with open(prototxt) as f:
        text_format.Parse(f.read(), net, allow_unknown_field=True)
    weights: Dict[str, List[np.ndarray]] = {}
    if caffemodel:
        wnet = cp2.NetParameter()
        with open(caffemodel, "rb") as f:
            wnet.ParseFromString(f.read())
        for l in wnet.layer:
            if l.blobs:
                weights[l.name] = [blob_to_numpy(b) for b in l.blobs]
    return _Importer(net, weights).run()
