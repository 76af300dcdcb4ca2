"""Fused int8 identity-shortcut bottleneck block: the port of
`anakin_tpu/kernels/bottleneck_int8.py::bottleneck_int8`.

    a = requant_a(relu(x @ wa * (in_scale * wsa) + ba))          1x1, C -> P
    b = requant_b(relu(conv3x3(a, wb) * (a_scale * wsb) + bb))   3x3 s1 p1
    y = relu(b @ wc * (b_scale * wsc) + bc + x * res_scale)      1x1, P -> C
    out = requant_out(y) as int8 when `out_scale` is given, else y as
          `out_dtype` (float32 or bfloat16)

with requant_s(v) = clip(round(v * (1 / s)), -127, 127) as int8.  x is
[N, H, W, C] int8, wa [C, P], wb [3, 3, P, P] (HWIO), wc [P, C] int8; the
weight scales and biases are widened to float32, as the Pallas wrapper
does.  Each bias may be given or not.

The plain version is the composition of the port's plain GEMM and 3x3
conv: exactly the Pallas kernel's arithmetic, step for step.  On a CUDA
tensor `bottleneck_int8` launches the fused Hopper kernel in
`csrc/bottleneck_int8.cu` (its header says what bounds it and what its
design does about that), which equals the unfused chain `matmul_int8 ->
conv3x3_int8 -> matmul_int8` bit for bit; on a CPU tensor it runs
`bottleneck_int8_plain`.  The kernel takes C and P that are multiples of 64
(ResNet's identity blocks: C = 4 P, P 64 ... 512); a narrower block (C or P
not a multiple of 64, as in a ResNet at a cut width) is widened with zero
channels (`pad_block`, for each call) and its output sliced back, which
changes no value: a zero channel adds exactly 0 to every int32 sum, and a
padded channel of a and b is requant(relu(0)) = 0.  A call is one launch,
counted in `bottleneck_int8.launches`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch
import torch.nn.functional as F

from . import _build
from .conv_int8 import conv3x3_int8_plain
from .matmul_int8 import (_OUT_KINDS, PreparedB, as_prepared,
                          matmul_int8_plain, prepare_b, scale_row)

__all__ = ["bottleneck_int8", "bottleneck_int8_plain", "identity_block",
           "pad_block"]

_INVALID_VALUE = 1  # cudaErrorInvalidValue: the shapes were refused
_WIDTH = 64  # the CUDA kernel takes C and P that are multiples of this


def bottleneck_int8_plain(x, wa, wsa, wb, wsb, wc, wsc, ba=None, bb=None,
                          bc=None, *, in_scale: float, a_scale: float,
                          b_scale: float, res_scale: float,
                          out_scale: Optional[float] = None,
                          out_dtype=torch.float32) -> torch.Tensor:
    """`bottleneck_int8` in plain PyTorch, on any device: the three plain
    kernels in a row."""
    N, H, W, C = x.shape
    P = wa.shape[1]
    rows = x.reshape(N * H * W, C)
    a = matmul_int8_plain(rows, wa, wsa, ba, in_scale=in_scale,
                          activation="relu", out_scale=a_scale)
    b = conv3x3_int8_plain(a.reshape(N, H, W, P), wb, wsb, bb,
                           in_scale=a_scale, activation="relu",
                           out_scale=b_scale)
    y = matmul_int8_plain(b.reshape(N * H * W, P), wc, wsc, bc, rows,
                          in_scale=b_scale, activation="relu",
                          out_scale=out_scale, out_dtype=out_dtype,
                          residual_scale=res_scale)
    return y.reshape(N, H, W, C)


Weight = Union[torch.Tensor, PreparedB]


def _kn(w: Weight):
    """A weight's (K, N), whether raw or prepared; None for a raw weight
    that is not 2-D (the caller names the shape it wanted)."""
    if isinstance(w, PreparedB):
        return (w.k, w.n)
    return tuple(w.shape) if w.dim() == 2 else None


def _raw(w: Weight, shape) -> torch.Tensor:
    """The weight itself in `shape`: a prepared copy is checked against its
    weight's version counter and read back as [K, N]."""
    if isinstance(w, PreparedB):
        w.check()
        return w.kn().reshape(shape)
    return w


def _check(x, wa, wsa, wb, wsb, wc, wsc, ba, bb, bc, out_scale, out_dtype):
    ts = [w.t if isinstance(w, PreparedB) else w for w in (wa, wb, wc)]
    if any(t.dtype != torch.int8 for t in [x] + ts):
        raise TypeError(f"bottleneck_int8 takes int8 x and weights, got "
                        f"{x.dtype}, {ts[0].dtype}, {ts[1].dtype}, "
                        f"{ts[2].dtype}")
    kn_a = _kn(wa)
    if x.dim() != 4 or kn_a is None or kn_a[0] != x.shape[3]:
        raise ValueError(f"bottleneck_int8 shapes x {tuple(x.shape)}, wa "
                         f"{tuple(wa.shape)}")
    C, P = kn_a
    shape_b = tuple(wb.shape)
    b_ok = (shape_b[:3] == (3, 3, P) and wb.n == P
            if isinstance(wb, PreparedB) else shape_b == (3, 3, P, P))
    if not b_ok or _kn(wc) != (P, C):
        raise ValueError(f"bottleneck_int8 needs wb [3, 3, {P}, {P}] and wc "
                         f"[{P}, {C}], got {shape_b}, {tuple(wc.shape)}")
    for name, v, n in (("wsa", wsa, P), ("wsb", wsb, P), ("wsc", wsc, C),
                       ("ba", ba, P), ("bb", bb, P), ("bc", bc, C)):
        if v is not None and tuple(v.shape) != (n,):
            raise ValueError(f"bottleneck_int8: {name} must be [{n}], got "
                             f"{tuple(v.shape)}")
    if any(t is not None and t.device != x.device
           for t in ts + [wsa, wsb, wsc, ba, bb, bc]):
        raise ValueError("bottleneck_int8 operands on different devices")
    if out_scale is None and out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype {out_dtype} not supported")


def _lib() -> ctypes.CDLL:
    lib = _build.load("bottleneck_int8")
    fn = lib.ak_bottleneck_int8
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous, on a 16-byte boundary (the kernels' 16-byte copies)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _widen(n: int) -> int:
    return -(-n // _WIDTH) * _WIDTH


def pad_block(x, wa, wsa, wb, wsb, wc, wsc, ba=None, bb=None, bc=None):
    """The block's operands widened to C and P that are multiples of 64:
    x, the scales and the biases padded with zero channels, the weights
    (raw or prepared) zero-padded and prepared.  `bottleneck_int8` of the
    result, sliced to the first C channels, equals the narrow block's."""
    C, P = _kn(wa)
    c_pad, p_pad = _widen(C) - C, _widen(P) - P
    wa_ = prepare_b(F.pad(_raw(wa, (C, P)), (0, p_pad, 0, c_pad)))
    wb_ = prepare_b(F.pad(_raw(wb, (3, 3, P, P)), (0, p_pad, 0, p_pad)))
    wc_ = prepare_b(F.pad(_raw(wc, (P, C)), (0, c_pad, 0, p_pad)))

    def vec(v, pad):
        return None if v is None else F.pad(v, (0, pad))

    return (F.pad(x, (0, c_pad)), wa_, vec(wsa, p_pad), wb_, vec(wsb, p_pad),
            wc_, vec(wsc, c_pad), vec(ba, p_pad), vec(bb, p_pad),
            vec(bc, c_pad))


def bottleneck_int8(x: torch.Tensor, wa: Weight, wsa: torch.Tensor,
                    wb: Weight, wsb: torch.Tensor, wc: Weight,
                    wsc: torch.Tensor, ba: Optional[torch.Tensor] = None,
                    bb: Optional[torch.Tensor] = None,
                    bc: Optional[torch.Tensor] = None, *, in_scale: float,
                    a_scale: float, b_scale: float, res_scale: float,
                    out_scale: Optional[float] = None,
                    out_dtype=torch.float32) -> torch.Tensor:
    """The fused identity bottleneck; returns [N, H, W, C] int8 when
    `out_scale` is given, else `out_dtype`.  wa, wb and wc may be raw or
    prepared (`prepare_b`)."""
    _check(x, wa, wsa, wb, wsb, wc, wsc, ba, bb, bc, out_scale, out_dtype)
    kw = dict(in_scale=in_scale, a_scale=a_scale, b_scale=b_scale,
              res_scale=res_scale, out_scale=out_scale, out_dtype=out_dtype)
    N, H, W, C = x.shape
    P = _kn(wa)[1]
    if _build.runs_plain(x.device, "bottleneck_int8"):
        return bottleneck_int8_plain(
            x, _raw(wa, (C, P)), wsa, _raw(wb, (3, 3, P, P)), wsb,
            _raw(wc, (P, C)), wsc, ba, bb, bc, **kw)
    if C % _WIDTH or P % _WIDTH:
        padded = pad_block(x, wa, wsa, wb, wsb, wc, wsc, ba, bb, bc)
        return bottleneck_int8(*padded, **kw)[..., :C].contiguous()
    # [N][K] with K contiguous (K = C, 9 P, P: multiples of 16, so no pad)
    wa_, wb_, wc_ = (as_prepared(w).t for w in (wa, wb, wc))
    lib = _lib()
    with torch.cuda.device(x.device):
        x_ = _aligned(x)
        sa, sb, sc = (scale_row(s, v).contiguous() for s, v in
                      ((wsa, in_scale), (wsb, a_scale), (wsc, b_scale)))
        biases = [None if v is None else _aligned(v.to(torch.float32))
                  for v in (ba, bb, bc)]
        odt = torch.int8 if out_scale is not None else out_dtype
        out = torch.empty((N, H, W, C), dtype=odt, device=x.device)

        def ptr(t):
            return ctypes.c_void_p(None if t is None else t.data_ptr())

        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ak_bottleneck_int8(
            ptr(x_), ptr(wa_), ptr(sa), ptr(biases[0]), ptr(wb_), ptr(sb),
            ptr(biases[1]), ptr(wc_), ptr(sc), ptr(biases[2]), ptr(out),
            _OUT_KINDS[odt], N, H, W, C, P, 1.0 / float(a_scale),
            1.0 / float(b_scale), float(res_scale),
            0.0 if out_scale is None else 1.0 / float(out_scale),
            ctypes.c_void_p(stream))
    if rc == _INVALID_VALUE:
        raise ValueError(f"the CUDA bottleneck_int8 needs one row of the "
                         f"image in shared memory, got W {W}, C {C}, P {P}")
    if rc != 0:
        raise RuntimeError(f"bottleneck_int8 kernel launch failed: CUDA error "
                           f"{rc}")
    bottleneck_int8.launches += 1
    return out


bottleneck_int8.launches = 0


def identity_block(block, params, x: torch.Tensor,
                   prepared: Optional[dict] = None) -> torch.Tensor:
    """`bottleneck_int8` on one (A, B, C) node triple of
    `models.resnet.identity_bottlenecks`, with the graph's params as a `Net`
    holds them (`Net.params`: on its device, float params in its compute
    dtype) and the block's int8 input x.  `prepared`: the `Net`'s prepared
    weights by node name (`Net.prepared`), handed to the kernel as they are;
    without it the CUDA kernel prepares the three weights for this call.
    Gives what the net gives on C's output edge."""
    a, b, c = block
    C, P = x.shape[3], params[a.inputs[1]].shape[3]

    def weights(node, shape):
        w = params[node.inputs[1]]
        if prepared is not None:
            w = prepared[node.name]
        elif w.shape != shape:
            w = w.reshape(shape)
        bias = params[node.inputs[3]] if node.attr("has_bias") else None
        return w, params[node.inputs[2]], bias

    wa, wsa, ba = weights(a, (C, P))
    wb, wsb, bb = weights(b, (3, 3, P, P))
    wc, wsc, bc = weights(c, (P, C))
    out_scale = c.attr("out_scale")
    return bottleneck_int8(
        x, wa, wsa, wb, wsb, wc, wsc, ba, bb, bc,
        in_scale=float(a.attr("in_scale")), a_scale=float(a.attr("out_scale")),
        b_scale=float(b.attr("out_scale")),
        res_scale=float(c.attr("residual_scale")),
        out_scale=None if out_scale is None else float(out_scale),
        out_dtype=getattr(torch, c.attr("out_dtype", "float32")))
