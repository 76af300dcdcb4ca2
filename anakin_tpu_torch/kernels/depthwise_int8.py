"""int8 3x3 depthwise NHWC convolution, pad 1, stride 1 or 2, channel
multiplier 1, with the fused epilogue: the port of
`anakin_tpu/kernels/depthwise_int8.py::depthwise3x3_int8`.

    acc[n,ho,wo,c] = sum_{dy,dx} x[n, s*ho+dy-1, s*wo+dx-1, c] * w[dy,dx,0,c]
                     (int32, exact, zero halo)
    y   = act(acc * (in_scale * w_scale[c]) + bias[c])
    out = clip(round(y * (1 / out_scale)), -127, 127) as int8,  or y as
          float32 / bfloat16 when there is no out_scale

x is [N, H, W, C] int8, w is [3, 3, 1, C] int8; Ho = (H - 1) // s + 1.
As on the TPU there is no residual, and the activation is relu, relu6 or
leaky_relu (sigmoid and tanh are refused).  Any H and W are taken at
either stride: the Pallas kernel asserts even sizes at stride 2, but the
JAX package's default route (XLA) computes odd ones, and so does this.

On a CUDA tensor `depthwise3x3_int8` launches the Hopper kernel in
`csrc/depthwise3x3_int8.cu` (its header says what bounds it and what the
design does about that); on a CPU tensor, or a meta tensor during shape
inference, it runs `depthwise3x3_int8_plain`.  The epilogue and its
numerics are those of `matmul_int8`: float32 w_scale and bias (a bf16 net's
are widened here), the scale row formed once in float32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .matmul_int8 import (_TAIL_ARGTYPES, check_epilogue, epilogue_launch_args,
                          epilogue_plain, scale_row)

__all__ = ["depthwise3x3_int8", "depthwise3x3_int8_plain"]

_DW_ACTS = (None, "identity", "relu", "relu6", "leaky_relu")


def _lib() -> ctypes.CDLL:
    lib = _build.load("depthwise3x3_int8")
    fn = lib.ak_depthwise3x3_int8
    # x, w, scale, bias, out; out kind, N, H, W, C, stride; then act,
    # alpha, 1 / out_scale, stream
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + _TAIL_ARGTYPES)
    fn.restype = ctypes.c_int
    return lib


def depthwise3x3_int8_plain(x, w, w_scale, bias=None, *, stride: int = 1,
                            in_scale: float, activation: Optional[str] = None,
                            act_alpha: float = 0.0,
                            out_scale: Optional[float] = None,
                            out_dtype=torch.float32) -> torch.Tensor:
    """`depthwise3x3_int8` in plain PyTorch: nine shifted int32 products
    of a zero-padded copy (|acc| <= 9 * 127 * 127, exact in int32), then
    the shared epilogue."""
    N, H, W, C = x.shape
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    xp = F.pad(x, (0, 0, 1, 1, 1, 1)).to(torch.int32)
    k = w.reshape(3, 3, C).to(torch.int32)
    acc = None
    for dy in range(3):
        for dx in range(3):
            t = xp[:, dy:dy + stride * (Ho - 1) + 1:stride,
                   dx:dx + stride * (Wo - 1) + 1:stride, :] * k[dy, dx]
            acc = t if acc is None else acc + t
    return epilogue_plain(acc, scale_row(w_scale, in_scale), bias, None, None,
                          activation, act_alpha, out_scale, out_dtype)


def depthwise3x3_int8(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None, *, stride: int = 1,
                      in_scale: float, activation: Optional[str] = None,
                      act_alpha: float = 0.0, out_scale: Optional[float] = None,
                      out_dtype=torch.float32) -> torch.Tensor:
    """Fused int8 depthwise 3x3 conv.  Returns [N, Ho, Wo, C] int8 when
    `out_scale` is given, else `out_dtype`."""
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"depthwise3x3_int8 takes int8 operands, got "
                        f"{x.dtype}, {w.dtype}")
    if x.dim() != 4 or tuple(w.shape) != (3, 3, 1, x.shape[3]):
        raise ValueError(f"depthwise3x3_int8 shapes {tuple(x.shape)} * "
                         f"{tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError("depthwise3x3_int8 operands on different devices")
    if stride not in (1, 2):
        raise ValueError(f"depthwise3x3_int8 takes stride 1 or 2, not {stride}")
    N, H, W, C = x.shape
    if activation not in _DW_ACTS:
        raise ValueError(f"unsupported epilogue act {activation!r}")
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    check_epilogue(x.device, C, N * Ho * Wo, w_scale, bias, None, None,
                   activation, out_scale, out_dtype)
    kw = dict(stride=stride, in_scale=in_scale, activation=activation,
              act_alpha=act_alpha, out_scale=out_scale, out_dtype=out_dtype)
    if _build.runs_plain(x.device, "depthwise3x3_int8"):
        return depthwise3x3_int8_plain(x, w, w_scale, bias, **kw)
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("depthwise3x3_int8 operands must be contiguous")
    lib = _lib()
    with torch.cuda.device(x.device):
        out, args, tail, _keep = epilogue_launch_args(
            w_scale, bias, None, None, in_scale, activation, act_alpha,
            out_scale, out_dtype, (N, Ho, Wo, C), x.device)
        scale_p, bias_p, _res, _res_kind, _res_scale, out_p, out_kind = args
        act, alpha, inv = tail
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ak_depthwise3x3_int8(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w.data_ptr()),
            scale_p, bias_p, out_p, out_kind, N, H, W, C, stride, act, alpha,
            inv, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"depthwise3x3_int8 kernel launch failed: CUDA "
                           f"error {rc}")
    depthwise3x3_int8.launches += 1
    return out


depthwise3x3_int8.launches = 0
