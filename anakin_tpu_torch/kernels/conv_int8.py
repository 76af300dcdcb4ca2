"""int8 3x3 stride-1 pad-1 NHWC convolution with the fused epilogue: the port
of `anakin_tpu/kernels/conv_int8.py::conv3x3_int8`.

    acc = conv3x3(x, w), stride 1, zero halo of 1   (int32, exact)
    y   = act(acc * (in_scale * w_scale[o]) + bias[o] + residual[n, h, w, o])
    out = clip(round(y * (1 / out_scale)), -127, 127) as int8,  or y as
          float32 / bfloat16 when there is no out_scale

x is [N, H, W, C] int8, w is HWIO [3, 3, C, O] int8.  As on the TPU, the
activation is relu, relu6 or leaky_relu; sigmoid and tanh are refused.

On a CUDA tensor `conv3x3_int8` launches the implicit-GEMM Hopper kernel in
`csrc/conv3x3_int8.cu` (its header says what bounds it and what the design
does about that); on a CPU tensor it runs `conv3x3_int8_plain`.  The
epilogue and its numerics are those of `matmul_int8`, and so is the weight:
`w` may be `prepare_b(w)` (the [O][9 C] copy a `Net` makes once), or the
HWIO weight itself, which the CUDA path then prepares for that one call.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Union

import torch
import torch.nn.functional as F

from . import _build
from .matmul_int8 import (_EPILOGUE_ARGTYPES, _TAIL_ARGTYPES, PreparedB,
                          _int_matmul, as_prepared, check_epilogue,
                          epilogue_launch_args, epilogue_plain, join_prepared,
                          opt_float, scale_row, split_prepared)

__all__ = ["conv3x3_int8", "conv3x3_int8_plain", "conv3x3_int8_op"]

_CONV_ACTS = (None, "identity", "relu", "relu6", "leaky_relu")


def _lib() -> ctypes.CDLL:
    lib = _build.load("conv3x3_int8")
    fn = lib.ak_conv3x3_int8
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                   + _EPILOGUE_ARGTYPES + [ctypes.c_int] * 5
                   + _TAIL_ARGTYPES)
    fn.restype = ctypes.c_int
    return lib


def conv3x3_int8_plain(x, w, w_scale, bias=None, residual=None, *,
                       in_scale: float, activation: Optional[str] = None,
                       act_alpha: float = 0.0,
                       out_scale: Optional[float] = None,
                       out_dtype=torch.float32,
                       residual_scale: Optional[float] = None) -> torch.Tensor:
    """`conv3x3_int8` in plain PyTorch: im2col in (dy, dx, c) order, then
    an exact integer product and the shared epilogue."""
    if isinstance(w, PreparedB):
        w.check()
        w = w.kn()
    N, H, W, C = x.shape
    O = w.shape[-1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, dy:dy + H, dx:dx + W, :]
                      for dy in range(3) for dx in range(3)], dim=-1)
    acc = _int_matmul(cols.reshape(N * H * W, 9 * C), w.reshape(9 * C, O))
    res = None if residual is None else residual.reshape(N * H * W, O)
    y = epilogue_plain(acc, scale_row(w_scale, in_scale), bias, res,
                       residual_scale, activation, act_alpha, out_scale,
                       out_dtype)
    return y.reshape(N, H, W, O)


def conv3x3_int8(x: torch.Tensor, w: Union[torch.Tensor, PreparedB],
                 w_scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None, *,
                 in_scale: float, activation: Optional[str] = None,
                 act_alpha: float = 0.0, out_scale: Optional[float] = None,
                 out_dtype=torch.float32,
                 residual_scale: Optional[float] = None) -> torch.Tensor:
    """Fused int8 3x3 s1 p1 conv.  Returns [N, H, W, O] int8 when
    `out_scale` is given, else `out_dtype`.  Launches directly when eager;
    goes through the registered op `conv3x3_int8_op` while a trace runs,
    as `matmul_int8` does."""
    wt = w.t if isinstance(w, PreparedB) else w
    if x.dtype != torch.int8 or wt.dtype != torch.int8:
        raise TypeError(f"conv3x3_int8 takes int8 operands, got {x.dtype}, {wt.dtype}")
    shape = tuple(w.shape)
    if x.dim() != 4 or len(shape) != 4 or shape[:3] != (3, 3, x.shape[3]):
        raise ValueError(f"conv3x3_int8 shapes {tuple(x.shape)} * {shape}")
    if wt.device != x.device:
        raise ValueError("conv3x3_int8 operands on different devices")
    if activation not in _CONV_ACTS:
        raise ValueError(f"unsupported epilogue act {activation!r}")
    N, H, W, C = x.shape
    O = shape[3]
    check_epilogue(x.device, O, N * H * W, w_scale, bias, residual,
                   residual_scale, activation, out_scale, out_dtype)
    kw = dict(in_scale=in_scale, activation=activation, act_alpha=act_alpha,
              out_scale=out_scale, out_dtype=out_dtype,
              residual_scale=residual_scale)
    if torch.compiler.is_compiling():  # a trace records the registered op
        t, wshape = split_prepared(w)
        return conv3x3_int8_op(x, t, wshape, w_scale, bias, residual,
                               float(in_scale), activation, float(act_alpha),
                               opt_float(out_scale), out_dtype,
                               opt_float(residual_scale))
    return _conv3x3_int8(x, w, w_scale, bias, residual, **kw)


def _conv3x3_int8(x, w, w_scale, bias, residual, *, in_scale, activation,
                  act_alpha, out_scale, out_dtype, residual_scale):
    """The wrapper's run on checked operands: the plain version on a CPU or
    meta tensor, the kernel launch on a CUDA one."""
    kw = dict(in_scale=in_scale, activation=activation, act_alpha=act_alpha,
              out_scale=out_scale, out_dtype=out_dtype,
              residual_scale=residual_scale)
    if _build.runs_plain(x.device, "conv3x3_int8"):
        return conv3x3_int8_plain(x, w, w_scale, bias, residual, **kw)
    if not x.is_contiguous():
        raise ValueError("conv3x3_int8 operands must be contiguous")
    w = as_prepared(w)
    N, H, W, C = x.shape
    O = w.n
    lib = _lib()
    with torch.cuda.device(x.device):
        out, args, tail, _keep = epilogue_launch_args(
            w_scale, bias, residual, residual_scale, in_scale, activation,
            act_alpha, out_scale, out_dtype, (N, H, W, O), x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ak_conv3x3_int8(ctypes.c_void_p(x.data_ptr()),
                                 ctypes.c_void_p(w.t.data_ptr()), w.t.shape[1],
                                 *args, N, H, W, C, O, *tail,
                                 ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"conv3x3_int8 kernel launch failed: CUDA error {rc}")
    conv3x3_int8.launches += 1
    return out


conv3x3_int8.launches = 0


@torch.library.custom_op("anakin_tpu_torch::conv3x3_int8", mutates_args=())
def conv3x3_int8_op(x: torch.Tensor, w: torch.Tensor,
                    w_shape: Optional[List[int]], w_scale: torch.Tensor,
                    bias: Optional[torch.Tensor],
                    residual: Optional[torch.Tensor], in_scale: float,
                    activation: Optional[str], act_alpha: float,
                    out_scale: Optional[float], out_dtype: torch.dtype,
                    residual_scale: Optional[float]) -> torch.Tensor:
    """The kernel as a registered op (see `matmul_int8_op`)."""
    return _conv3x3_int8(x, join_prepared(w, w_shape), w_scale, bias,
                         residual, in_scale=in_scale, activation=activation,
                         act_alpha=act_alpha, out_scale=out_scale,
                         out_dtype=out_dtype, residual_scale=residual_scale)


@conv3x3_int8_op.register_fake
def _(x, w, w_shape, w_scale, bias, residual, in_scale, activation,
      act_alpha, out_scale, out_dtype, residual_scale):
    return conv3x3_int8_plain(x, join_prepared(w, w_shape), w_scale, bias,
                              residual, in_scale=in_scale,
                              activation=activation, act_alpha=act_alpha,
                              out_scale=out_scale, out_dtype=out_dtype,
                              residual_scale=residual_scale)
