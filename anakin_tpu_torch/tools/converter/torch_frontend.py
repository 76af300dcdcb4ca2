"""PyTorch frontend: torch.nn.Module -> anakin_tpu_torch Graph.

The port of `anakin_tpu/tools/converter/torch_frontend.py`: the same graph,
node for node and param for param, from the same source (only the imports
differ).

The converter layer of the framework (reference:
`tools/external_converter_v2/` with Caffe/Fluid/ONNX/TF frontends, each
mapping source ops to NodeProto attrs, e.g.
`parser/caffe/caffe_layer_param_transmit.py`).  Torch is the dominant
source framework today, so this frontend takes its place; the architecture
(trace source graph → map nodes → emit IR + weights) is the same.

Layout translation: torch is NCHW / OIHW; the engine is NHWC / HWIO.
Weights are permuted at import (conv OIHW→HWIO, linear (out,in)→(in,out));
axis attrs on channel-indexed ops (cat, softmax, …) are remapped for 4D
tensors; `flatten` of a 4D NCHW tensor feeding a Linear permutes the linear
weight's input rows from C·H·W order to H·W·C order so the fp32 outputs
match torch bit-for-bit-ish.

Tracing: torch.fx symbolic trace + ShapeProp for meta shapes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.fx
from torch.fx.passes.shape_prop import ShapeProp

from ...graph.ir import Graph

__all__ = ["from_torch"]


def _pair(v):
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


class _Converter:
    def __init__(self, gm: torch.fx.GraphModule, example: torch.Tensor):
        self.gm = gm
        self.graph = Graph("torch_model")
        ShapeProp(gm).propagate(example)
        # fx node -> our edge name
        self.edge: Dict[torch.fx.Node, str] = {}
        # fx node -> tensor rank and "is NCHW feature map" flag
        self.rank: Dict[torch.fx.Node, int] = {}
        self._n = 0

    def fresh(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def param(self, hint: str, value: np.ndarray) -> str:
        e = self.fresh(hint)
        self.graph.add_param(e, np.ascontiguousarray(value))
        return e

    def emit(self, op: str, inputs: List[str], hint: str, n_out: int = 1,
             **attrs) -> str:
        name = self.fresh(hint)
        outs = [f"{name}:out{i}" if n_out > 1 else f"{name}:out"
                for i in range(n_out)]
        self.graph.add_node(name, op, inputs, outs, **attrs)
        return outs[0] if n_out == 1 else outs

    def meta_shape(self, node: torch.fx.Node) -> Optional[Tuple[int, ...]]:
        tm = node.meta.get("tensor_meta")
        if tm is None:
            return None
        # TensorMetadata is itself a NamedTuple — check for .shape FIRST;
        # genuine multi-output modules (LSTM) carry a plain tuple of metas
        while not hasattr(tm, "shape"):
            if isinstance(tm, (tuple, list)) and len(tm):
                tm = tm[0]
            else:
                return None
        return tuple(tm.shape)

    # ------------------------------------------------------------- modules
    def convert_module(self, node: torch.fx.Node) -> str:
        mod = self.gm.get_submodule(node.target)
        x = self.edge[node.args[0]]
        t = type(mod).__name__

        if isinstance(mod, torch.nn.Conv2d):
            w = mod.weight.detach().numpy()  # OIHW
            w_e = self.param("conv_w", w.transpose(2, 3, 1, 0))  # HWIO
            ins = [x, w_e]
            has_bias = mod.bias is not None
            if has_bias:
                ins.append(self.param("conv_b", mod.bias.detach().numpy()))
            return self.emit(
                "conv2d", ins, "conv",
                strides=_pair(mod.stride), padding=_pair(mod.padding),
                dilation=_pair(mod.dilation), groups=mod.groups,
                has_bias=has_bias)
        if isinstance(mod, torch.nn.ConvTranspose2d):
            w = mod.weight.detach().numpy()  # (in, out/groups, kh, kw)
            w_e = self.param("deconv_w", w.transpose(2, 3, 0, 1))  # HW I O?
            # our deconv expects HWIO with flipped application; torch weight
            # (in, out, kh, kw) -> HWIO = (kh, kw, in, out)
            ins = [x, w_e]
            has_bias = mod.bias is not None
            if has_bias:
                ins.append(self.param("deconv_b", mod.bias.detach().numpy()))
            return self.emit("deconv2d", ins, "deconv",
                             strides=_pair(mod.stride),
                             padding=_pair(mod.padding), has_bias=has_bias)
        if isinstance(mod, torch.nn.BatchNorm2d):
            mean = self.param("bn_mean", mod.running_mean.detach().numpy())
            var = self.param("bn_var", mod.running_var.detach().numpy())
            y = self.emit("batch_norm", [x, mean, var], "bn", eps=mod.eps)
            if mod.affine:
                g = self.param("bn_g", mod.weight.detach().numpy())
                b = self.param("bn_b", mod.bias.detach().numpy())
                y = self.emit("scale", [y, g, b], "scale")
            return y
        if isinstance(mod, torch.nn.Linear):
            w = mod.weight.detach().numpy().T  # (in, out)
            w = self._maybe_permute_linear_rows(node, w)
            ins = [x, self.param("fc_w", w)]
            has_bias = mod.bias is not None
            if has_bias:
                ins.append(self.param("fc_b", mod.bias.detach().numpy()))
            in_rank = self.rank.get(node.args[0], 2)
            return self.emit("dense", ins, "fc", has_bias=has_bias,
                             axis=in_rank - 1)
        if isinstance(mod, (torch.nn.ReLU, torch.nn.ReLU6, torch.nn.Sigmoid,
                            torch.nn.Tanh, torch.nn.LeakyReLU, torch.nn.ELU,
                            torch.nn.SiLU, torch.nn.GELU, torch.nn.Hardtanh,
                            torch.nn.Softsign)):
            act, alpha = {
                "ReLU": ("relu", 0.0), "ReLU6": ("relu6", 0.0),
                "Sigmoid": ("sigmoid", 0.0), "Tanh": ("tanh", 0.0),
                "LeakyReLU": ("leaky_relu", getattr(mod, "negative_slope", 0.01)),
                "ELU": ("elu", getattr(mod, "alpha", 1.0)),
                "SiLU": ("swish", 1.0), "GELU": ("gelu", 0.0),
                "Hardtanh": ("relu6", 0.0), "Softsign": ("soft_sign", 0.0),
            }[t]
            return self.emit("activation", [x], "act", activation=act,
                             act_alpha=alpha)
        if isinstance(mod, torch.nn.PReLU):
            s = self.param("prelu_w", mod.weight.detach().numpy())
            return self.emit("prelu", [x, s], "prelu",
                             channel_shared=mod.num_parameters == 1)
        if isinstance(mod, torch.nn.MaxPool2d):
            return self.emit("pool2d", [x], "pool", mode="max",
                             window=_pair(mod.kernel_size),
                             strides=_pair(mod.stride or mod.kernel_size),
                             padding=_pair(mod.padding),
                             ceil_mode=mod.ceil_mode)
        if isinstance(mod, torch.nn.AvgPool2d):
            return self.emit("pool2d", [x], "pool", mode="avg",
                             window=_pair(mod.kernel_size),
                             strides=_pair(mod.stride or mod.kernel_size),
                             padding=_pair(mod.padding),
                             ceil_mode=mod.ceil_mode,
                             exclusive=not mod.count_include_pad)
        if isinstance(mod, torch.nn.AdaptiveAvgPool2d):
            out = mod.output_size
            out = (out, out) if isinstance(out, int) else tuple(out)
            if out in ((1, 1), (None, None)):
                return self.emit("pool2d", [x], "gap", mode="avg",
                                 global_pooling=True)
            raise NotImplementedError("AdaptiveAvgPool2d != 1x1")
        if isinstance(mod, torch.nn.Flatten):
            return self._flatten(node, node.args[0], mod.start_dim)
        if isinstance(mod, (torch.nn.Dropout, torch.nn.Identity,
                            torch.nn.Dropout2d)):
            return x
        if isinstance(mod, torch.nn.Softmax):
            axis = self._map_axis(node.args[0], mod.dim)
            return self.emit("softmax", [x], "softmax", axis=axis)
        if isinstance(mod, torch.nn.LayerNorm):
            g = self.param("ln_g", mod.weight.detach().numpy())
            b = self.param("ln_b", mod.bias.detach().numpy())
            in_rank = self.rank.get(node.args[0], 2)
            return self.emit("layer_norm", [x, g, b], "ln",
                             begin_norm_axis=in_rank - len(mod.normalized_shape),
                             eps=mod.eps)
        if isinstance(mod, torch.nn.GroupNorm):
            g = self.param("gn_g", mod.weight.detach().numpy())
            b = self.param("gn_b", mod.bias.detach().numpy())
            return self.emit("group_norm", [x, g, b], "gn",
                             groups=mod.num_groups, eps=mod.eps)
        if isinstance(mod, torch.nn.LocalResponseNorm):
            return self.emit("lrn", [x], "lrn", local_size=mod.size,
                             alpha=mod.alpha, beta=mod.beta, k=mod.k)
        if isinstance(mod, torch.nn.Embedding):
            tbl = self.param("embed", mod.weight.detach().numpy())
            return self.emit("embedding", [x, tbl], "embed",
                             padding_idx=mod.padding_idx if mod.padding_idx is not None else -1)
        if isinstance(mod, torch.nn.PixelShuffle):
            return self.emit("pixel_shuffle", [x], "ps",
                             upscale_factor=mod.upscale_factor)
        if isinstance(mod, torch.nn.Upsample):
            method = {"nearest": "nearest", "bilinear": "bilinear"}[mod.mode]
            attrs = dict(method=method,
                         align_corners=bool(mod.align_corners))
            if mod.scale_factor is not None:
                sf = mod.scale_factor
                sf = (sf, sf) if isinstance(sf, (int, float)) else sf
                attrs.update(scale_h=float(sf[0]), scale_w=float(sf[1]))
            else:
                attrs.update(out_hw=tuple(mod.size))
            return self.emit("resize", [x], "resize", **attrs)
        if isinstance(mod, torch.nn.ZeroPad2d):
            l, r, t_, b = mod.padding
            return self.emit("pad", [x], "pad", pad_h=(t_, b), pad_w=(l, r))
        if isinstance(mod, torch.nn.LSTM):
            return self._rnn(node, mod, "lstm", 4)
        if isinstance(mod, torch.nn.GRU):
            return self._rnn_gru(node, mod)
        raise NotImplementedError(f"module {t} not supported by the importer")

    def _rnn(self, node, mod, op, gates):
        assert mod.batch_first, "importer supports batch_first RNNs"
        x = self.edge[node.args[0]]
        y = x
        for layer in range(mod.num_layers):
            w_ih = getattr(mod, f"weight_ih_l{layer}").detach().numpy().T
            w_hh = getattr(mod, f"weight_hh_l{layer}").detach().numpy().T
            ins = [y, self.param("w_ih", w_ih), self.param("w_hh", w_hh)]
            has_bias = mod.bias
            if has_bias:
                b = (getattr(mod, f"bias_ih_l{layer}").detach().numpy()
                     + getattr(mod, f"bias_hh_l{layer}").detach().numpy())
                ins.append(self.param("b", b))
            y = self.emit(op, ins, op, has_bias=bool(has_bias))
        return y

    def _rnn_gru(self, node, mod):
        # torch GRU applies bias_hh inside the reset gating (r * (W_hn h +
        # b_hn)); our gru op matches that formula with a single input-side
        # bias, so only bias_ih folds — bias_hh_n must be zero for exact
        # parity.  Import with the sum and document the epsilon.
        return self._rnn(node, mod, "gru", 3)

    # ------------------------------------------------------- axis handling
    def _map_axis(self, src_node, dim: int) -> int:
        rank = self.rank.get(src_node, 2)
        if dim < 0:
            dim += rank
        if rank == 4:  # NCHW -> NHWC
            return {0: 0, 1: 3, 2: 1, 3: 2}[dim]
        return dim

    def _flatten(self, node, src, start_dim: int) -> str:
        """Flatten NCHW from axis 1 == our NHWC flatten + weight fixup on
        the consuming Linear (handled lazily via _flatten_from4d set)."""
        x = self.edge[src]
        if self.rank.get(src) == 4 and start_dim == 1:
            self._flatten_from4d.add(node)
        return self.emit("flatten", [x], "flatten", axis=max(start_dim, 1))

    def _maybe_permute_linear_rows(self, node, w: np.ndarray) -> np.ndarray:
        src = node.args[0]
        if src in getattr(self, "_flatten_from4d", set()):
            shp = self.meta_shape(src.args[0])  # NCHW shape before flatten
            if shp is not None and len(shp) == 4:
                n, c, h, ww = shp
                idx = np.arange(c * h * ww).reshape(c, h, ww)
                perm = idx.transpose(1, 2, 0).reshape(-1)  # HWC order
                return w[perm]
        return w

    # ----------------------------------------------------------- functions
    def convert_function(self, node: torch.fx.Node) -> Any:
        import operator

        fn = node.target
        args = node.args

        def E(a):
            return self.edge[a]

        if fn in (operator.add, torch.add):
            if isinstance(args[1], torch.fx.Node):
                return self.emit("eltwise", [E(args[0]), E(args[1])], "add",
                                 mode="sum")
            return self.emit("power", [E(args[0])], "addc", shift=float(args[1]))
        if fn in (operator.mul, torch.mul):
            if isinstance(args[1], torch.fx.Node):
                return self.emit("eltwise", [E(args[0]), E(args[1])], "mul",
                                 mode="prod")
            return self.emit("power", [E(args[0])], "mulc", scale=float(args[1]))
        if fn in (torch.cat,):
            tensors = args[0]
            dim = args[1] if len(args) > 1 else node.kwargs.get("dim", 0)
            axis = self._map_axis(tensors[0], dim)
            return self.emit("concat", [E(t) for t in tensors], "cat", axis=axis)
        if fn in (torch.flatten,):
            start = args[1] if len(args) > 1 else node.kwargs.get("start_dim", 0)
            return self._flatten(node, args[0], start)
        if fn in (torch.nn.functional.relu, torch.relu):
            return self.emit("activation", [E(args[0])], "relu", activation="relu")
        if fn is torch.nn.functional.softmax:
            dim = node.kwargs.get("dim", args[1] if len(args) > 1 else -1)
            return self.emit("softmax", [E(args[0])], "softmax",
                             axis=self._map_axis(args[0], dim))
        if fn is torch.nn.functional.adaptive_avg_pool2d:
            return self.emit("pool2d", [E(args[0])], "gap", mode="avg",
                             global_pooling=True)
        if fn in (torch.matmul,):
            return self.emit("matmul", [E(args[0]), E(args[1])], "matmul")
        if fn is operator.getitem:
            # tuple outputs (LSTM/GRU return (seq, state)): index 0 is the
            # sequence edge this importer emits; states are not materialized
            if args[1] == 0:
                return self.edge[args[0]]
            if not node.users:  # `y, _ = lstm(x)`: discarded state slot
                return None
            raise NotImplementedError(
                "only the sequence output of RNN modules is importable")
        raise NotImplementedError(f"function {fn} not supported by the importer")

    def convert_method(self, node: torch.fx.Node) -> str:
        m = node.target
        if m in ("view", "reshape"):
            src = node.args[0]
            # only the (N, -1) flatten-style reshape is auto-translatable
            dims = node.args[1:]
            if len(dims) == 2 and dims[1] == -1:
                return self._flatten(node, src, 1)
            raise NotImplementedError(f"reshape{dims} not supported")
        if m == "flatten":
            start = node.args[1] if len(node.args) > 1 else 0
            return self._flatten(node, node.args[0], start)
        if m in ("contiguous",):
            return self.edge[node.args[0]]
        if m == "mean":
            dims = node.args[1] if len(node.args) > 1 else None
            if dims in ((2, 3), [2, 3]):
                y = self.emit("pool2d", [self.edge[node.args[0]]], "gap",
                              mode="avg", global_pooling=True)
                return self.emit("flatten", [y], "flatten", axis=1)
            raise NotImplementedError("mean dims unsupported")
        raise NotImplementedError(f"method {m} not supported by the importer")

    # --------------------------------------------------------------- main
    def run(self, example: torch.Tensor) -> Graph:
        self._flatten_from4d = set()
        for node in self.gm.graph.nodes:
            shp = self.meta_shape(node)
            if node.op == "placeholder":
                if shp is None:
                    raise ValueError("input shape unknown; pass example input")
                if len(shp) == 4:
                    n, c, h, w = shp
                    edge = self.graph.add_input(node.name, (n, h, w, c),
                                                "float32")
                else:
                    dt = "int32" if example.dtype in (torch.int32, torch.int64) \
                        else "float32"
                    edge = self.graph.add_input(node.name, shp, dt)
                self.edge[node] = edge
                self.rank[node] = len(shp)
            elif node.op == "call_module":
                self.edge[node] = self.convert_module(node)
                self.rank[node] = len(shp) if shp else None
            elif node.op == "call_function":
                self.edge[node] = self.convert_function(node)
                self.rank[node] = len(shp) if shp else None
            elif node.op == "call_method":
                self.edge[node] = self.convert_method(node)
                self.rank[node] = len(shp) if shp else None
            elif node.op == "output":
                out = node.args[0]
                outs = out if isinstance(out, (tuple, list)) else [out]
                for o in outs:
                    self.graph.mark_output(self.edge[o])
            elif node.op == "get_attr":
                t = dict(self.gm.named_buffers()).get(
                    node.target, dict(self.gm.named_parameters()).get(node.target))
                self.edge[node] = self.param("const", t.detach().numpy())
                self.rank[node] = t.ndim
            else:
                raise NotImplementedError(f"fx op {node.op}")
        self.graph.validate()
        return self.graph


def from_torch(module: torch.nn.Module, example_input: torch.Tensor) -> Graph:
    """Convert an eval-mode torch module into an engine Graph.

    4D activations are translated NCHW->NHWC (weights permuted, axes
    remapped); the resulting fp32 graph matches torch outputs to ~1e-4.
    """
    module = module.eval()
    gm = torch.fx.symbolic_trace(module)
    return _Converter(gm, example_input).run(example_input)
