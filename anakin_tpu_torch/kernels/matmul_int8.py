"""int8 GEMM with a fused dequant / bias / residual / activation / requant
epilogue: the port of `anakin_tpu/kernels/matmul_int8.py::matmul_int8`.

    acc = a @ b                                     (int32, exact)
    y   = act(acc * (in_scale * w_scale[n]) + bias[n] + residual[m, n])
    out = clip(round(y * (1 / out_scale)), -127, 127) as int8,  or y as
          float32 / bfloat16 when there is no out_scale

On a CUDA tensor `matmul_int8` launches the hand-written Hopper kernel in
`csrc/matmul_int8.cu` (what bounds it and what its design does about that
are in that file's header); on a CPU tensor it runs `matmul_int8_plain`,
the same arithmetic in plain PyTorch.  There is no fallback from one to the
other.

The kernel reads the weight as [N][K], K contiguous (int8 wgmma takes
K-major operands only).  `prepare_b` makes that copy; a `Net` makes it once
per weight when it is built and hands it to the op, so no step transposes a
weight.  `b` may be the weight itself ([K, N], the JAX layout): the CUDA
path then prepares it for that one call.  A prepared copy remembers its
weight's version counter and refuses to run once the weight has changed in
place.

Numerics follow the Pallas kernel bit for bit: the scale row is
`in_scale * w_scale` in float32, every epilogue step is a separately
rounded float32 operation, the requant multiplies by the float32 reciprocal
of `out_scale` (the op path's `quantize_array` divides instead), and
rounding is half-to-even.  An int8 residual is dequantized with
`residual_scale` inside the epilogue, as the op path does before calling
the TPU kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["matmul_int8", "matmul_int8_plain", "matmul_int8_op",
           "epilogue_plain", "PreparedB", "prepare_b"]

_ACTS = {None: 0, "identity": 0, "relu": 1, "relu6": 2, "leaky_relu": 3,
         "sigmoid": 4, "tanh": 5}
_RES_KINDS = {torch.float32: 1, torch.bfloat16: 2, torch.int8: 3}
_OUT_KINDS = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}


class PreparedB(NamedTuple):
    """An int8 weight as the int8 GEMM core reads it (made by `prepare_b`):
    `t` is [N, ldb], K contiguous, zero from K to ldb (a multiple of 16);
    `shape` is the weight's own shape, [K, N] or HWIO [kh, kw, C, O] with
    K = kh * kw * C; `source` and `version` are the weight and its version
    counter when the copy was made (None for an inference tensor, which
    cannot change outside inference mode)."""

    t: torch.Tensor
    shape: Tuple[int, ...]
    source: torch.Tensor
    version: Optional[int]

    @property
    def k(self) -> int:
        return math.prod(self.shape[:-1])

    @property
    def n(self) -> int:
        return self.shape[-1]

    def kn(self) -> torch.Tensor:
        """The weight as [K, N] again (a view of `t`)."""
        return self.t[:, :self.k].t()

    def check(self) -> None:
        if self.version is not None and self.source._version != self.version:
            raise RuntimeError("an int8 weight changed in place after it was "
                               "prepared; prepare it again (prepare_b)")


def _version(w: torch.Tensor) -> Optional[int]:
    return None if w.is_inference() else w._version


def prepare_b(w: torch.Tensor) -> PreparedB:
    """The [N, ldb] K-contiguous copy of an int8 weight [..., N] flattened
    to [K, N]: one transpose, on the weight's device."""
    if w.dtype != torch.int8:
        raise TypeError(f"prepare_b takes an int8 weight, got {w.dtype}")
    k, n = math.prod(w.shape[:-1]), w.shape[-1]
    ldb = -(-k // 16) * 16
    t = F.pad(w.reshape(k, n).t(), (0, ldb - k)).contiguous()
    prepare_b.calls += 1
    return PreparedB(t, tuple(w.shape), w, _version(w))


prepare_b.calls = 0

def as_prepared(b: Union[torch.Tensor, PreparedB]) -> PreparedB:
    """`b` prepared: checked when it already is, else prepared now."""
    if isinstance(b, PreparedB):
        b.check()
        return b
    return prepare_b(b)


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 product.  int64 on the CPU; on the card in float64, which
    is exact below 2**53 (cuBLAS has no integer mm)."""
    if a.device.type == "cpu":
        return a.to(torch.int64) @ b.to(torch.int64)
    return a.to(torch.float64) @ b.to(torch.float64)


def epilogue_plain(acc, scale_row, bias, residual, residual_scale, activation,
                   act_alpha, out_scale, out_dtype):
    """The kernels' epilogue in plain PyTorch, on an exact accumulator."""
    y = acc.to(torch.float32) * scale_row
    if bias is not None:
        y = y + bias.to(torch.float32)
    if residual is not None:
        if residual.dtype == torch.int8:
            y = y + residual.to(torch.float32) * float(residual_scale)
        else:
            y = y + residual.to(torch.float32)
    if activation == "relu":
        y = torch.clamp_min(y, 0.0)
    elif activation == "relu6":
        y = torch.clamp(y, 0.0, 6.0)
    elif activation == "leaky_relu":
        y = torch.where(y >= 0, y, y * float(act_alpha))
    elif activation == "sigmoid":
        y = torch.sigmoid(y)
    elif activation == "tanh":
        y = torch.tanh(y)
    elif activation not in (None, "identity"):
        raise ValueError(f"epilogue activation {activation!r} not supported")
    if out_scale is not None:
        q = torch.round(y * (1.0 / float(out_scale)))
        return torch.clamp(q, -127.0, 127.0).to(torch.int8)
    return y.to(out_dtype)


def check_epilogue(device, n_out, out_rows, w_scale, bias, residual,
                   residual_scale, activation, out_scale, out_dtype):
    """Validate the epilogue operands shared by both kernels."""
    if activation not in _ACTS:
        raise ValueError(f"epilogue activation {activation!r} not supported")
    if w_scale.shape != (n_out,) or w_scale.device != device:
        raise ValueError(f"w_scale must be [{n_out}] on {device}")
    if bias is not None and (bias.shape != (n_out,) or bias.device != device):
        raise ValueError(f"bias must be [{n_out}] on {device}")
    if residual is not None:
        if residual.numel() != out_rows * n_out or residual.device != device:
            raise ValueError(f"residual must hold {out_rows}x{n_out} on {device}")
        if residual.dtype not in _RES_KINDS:
            raise TypeError(f"residual dtype {residual.dtype} not supported")
        if residual.dtype == torch.int8 and residual_scale is None:
            raise ValueError("an int8 residual needs residual_scale")
    if out_scale is None and out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype {out_dtype} not supported")


def scale_row(w_scale: torch.Tensor, in_scale: float) -> torch.Tensor:
    return w_scale.to(torch.float32) * float(in_scale)


def epilogue_launch_args(w_scale, bias, residual, residual_scale, in_scale,
                         activation, act_alpha, out_scale, out_dtype, shape,
                         device):
    """The output tensor and the C arguments of the epilogue, in the order
    both entry points take them.  Tensors made here are returned so that
    the caller holds them across the launch."""
    if residual is not None and not residual.is_contiguous():
        raise ValueError("residual must be contiguous")
    scale = scale_row(w_scale, in_scale).contiguous()
    bias32 = None if bias is None else bias.to(torch.float32).contiguous()
    odt = torch.int8 if out_scale is not None else out_dtype
    out = torch.empty(shape, dtype=odt, device=device)
    inv = 0.0 if out_scale is None else 1.0 / float(out_scale)
    args = [
        ctypes.c_void_p(scale.data_ptr()),
        ctypes.c_void_p(None if bias32 is None else bias32.data_ptr()),
        ctypes.c_void_p(None if residual is None else residual.data_ptr()),
        0 if residual is None else _RES_KINDS[residual.dtype],
        float(residual_scale or 0.0),
        ctypes.c_void_p(out.data_ptr()),
        _OUT_KINDS[odt],
    ]
    tail = [_ACTS[activation], float(act_alpha), inv]
    return out, args, tail, (scale, bias32)


_EPILOGUE_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                      ctypes.c_int]
_TAIL_ARGTYPES = [ctypes.c_int, ctypes.c_float, ctypes.c_float,
                  ctypes.c_void_p]


def igemm_config(M: int, N: int, K: int) -> Tuple[int, int, int]:
    """(block tile rows, block tile N width, K splits) that the card's
    launch of an M x N x K product takes (the same for the 3x3 conv with
    M = N H W and K = 9 C).  Needs the built kernel, so CUDA only."""
    fn = _lib().ak_igemm_config
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = None
    bm, bn, splits = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    fn(M, N, K, ctypes.byref(bm), ctypes.byref(bn), ctypes.byref(splits))
    return bm.value, bn.value, splits.value


def _lib() -> ctypes.CDLL:
    lib = _build.load("matmul_int8")
    fn = lib.ak_matmul_int8
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                   + _EPILOGUE_ARGTYPES + [ctypes.c_int] * 3
                   + _TAIL_ARGTYPES)
    fn.restype = ctypes.c_int
    return lib


def matmul_int8_plain(a, b, w_scale, bias=None, residual=None, *,
                      in_scale: float, activation: Optional[str] = None,
                      act_alpha: float = 0.0,
                      out_scale: Optional[float] = None,
                      out_dtype=torch.float32,
                      residual_scale: Optional[float] = None) -> torch.Tensor:
    """`matmul_int8` in plain PyTorch, on any device; `b` [K, N] or
    prepared."""
    if isinstance(b, PreparedB):
        b.check()
        b = b.kn()
    res = None if residual is None else residual.reshape(a.shape[0], b.shape[1])
    return epilogue_plain(_int_matmul(a, b), scale_row(w_scale, in_scale),
                          bias, res, residual_scale, activation, act_alpha,
                          out_scale, out_dtype)


def matmul_int8(a: torch.Tensor, b: Union[torch.Tensor, PreparedB],
                w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                residual: Optional[torch.Tensor] = None, *,
                in_scale: float, activation: Optional[str] = None,
                act_alpha: float = 0.0, out_scale: Optional[float] = None,
                out_dtype=torch.float32,
                residual_scale: Optional[float] = None) -> torch.Tensor:
    """Fused int8 GEMM: a [M, K] int8, b [K, N] int8 (or `prepare_b` of
    it), w_scale [N], bias [N], residual [M, N] (float, or int8 with
    `residual_scale`).  Returns [M, N] int8 when `out_scale` is given, else
    `out_dtype`.

    An eager call launches the kernel directly; while `torch.export` (or
    `torch.compile`) traces, the call goes through the registered op
    `matmul_int8_op`, which a trace can record, and the launch happens when
    the program runs.  Eager calls skip the op so that a host-bound step
    pays no custom-op dispatch (measured in `chip_smoke.py` phase 22)."""
    bt = b.t if isinstance(b, PreparedB) else b
    if a.dtype != torch.int8 or bt.dtype != torch.int8:
        raise TypeError(f"matmul_int8 takes int8 operands, got {a.dtype}, {bt.dtype}")
    kn = (b.k, b.n) if isinstance(b, PreparedB) else tuple(b.shape)
    if a.dim() != 2 or len(kn) != 2 or a.shape[1] != kn[0]:
        raise ValueError(f"matmul_int8 shapes {tuple(a.shape)} x {kn}")
    if bt.device != a.device:
        raise ValueError("matmul_int8 operands on different devices")
    M, K = a.shape
    N = kn[1]
    check_epilogue(a.device, N, M, w_scale, bias, residual, residual_scale,
                   activation, out_scale, out_dtype)
    kw = dict(in_scale=in_scale, activation=activation, act_alpha=act_alpha,
              out_scale=out_scale, out_dtype=out_dtype,
              residual_scale=residual_scale)
    if torch.compiler.is_compiling():  # a trace records the registered op
        t, shape = split_prepared(b)
        return matmul_int8_op(a, t, shape, w_scale, bias, residual,
                              float(in_scale), activation, float(act_alpha),
                              opt_float(out_scale), out_dtype,
                              opt_float(residual_scale))
    return _matmul_int8(a, b, w_scale, bias, residual, **kw)


def _matmul_int8(a, b, w_scale, bias, residual, *, in_scale, activation,
                 act_alpha, out_scale, out_dtype, residual_scale):
    """The wrapper's run on checked operands: the plain version on a CPU or
    meta tensor, the kernel launch on a CUDA one."""
    kw = dict(in_scale=in_scale, activation=activation, act_alpha=act_alpha,
              out_scale=out_scale, out_dtype=out_dtype,
              residual_scale=residual_scale)
    if _build.runs_plain(a.device, "matmul_int8"):
        return matmul_int8_plain(a, b, w_scale, bias, residual, **kw)
    if not a.is_contiguous():
        raise ValueError("matmul_int8 operands must be contiguous")
    b = as_prepared(b)
    M, K = a.shape
    N = b.n
    lib = _lib()
    with torch.cuda.device(a.device):
        out, args, tail, _keep = epilogue_launch_args(
            w_scale, bias, residual, residual_scale, in_scale, activation,
            act_alpha, out_scale, out_dtype, (M, N), a.device)
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.ak_matmul_int8(ctypes.c_void_p(a.data_ptr()),
                                ctypes.c_void_p(b.t.data_ptr()), b.t.shape[1],
                                *args, M, N, K, *tail,
                                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"matmul_int8 kernel launch failed: CUDA error {rc}")
    matmul_int8.launches += 1
    return out


matmul_int8.launches = 0


# The kernel entries as registered PyTorch operators (`torch.ops.
# anakin_tpu_torch.*`), which a `torch.export` trace can record where it
# cannot go through a ctypes launch.  An op's implementation is its
# wrapper's run on checked operands (on a CUDA tensor the launch, counted
# and raising when the build or the launch fails); its fake is the plain
# version, which computes shapes and dtypes on fake and meta tensors.  A
# prepared weight crosses the op boundary as its [N, ldb] tensor and the
# weight's shape.

def split_prepared(w: Union[torch.Tensor, PreparedB]
                   ) -> Tuple[torch.Tensor, Optional[List[int]]]:
    """A weight as an op takes it: (tensor, the weight's shape when the
    tensor is its prepared [N, ldb] copy, else None)."""
    if isinstance(w, PreparedB):
        w.check()
        return w.t, list(w.shape)
    return w, None


def join_prepared(t: torch.Tensor, shape: Optional[List[int]]):
    """`split_prepared` undone inside an op."""
    return t if shape is None else PreparedB(t, tuple(shape), t, None)


def opt_float(v) -> Optional[float]:
    return None if v is None else float(v)


@torch.library.custom_op("anakin_tpu_torch::matmul_int8", mutates_args=())
def matmul_int8_op(a: torch.Tensor, b: torch.Tensor,
                   b_shape: Optional[List[int]], w_scale: torch.Tensor,
                   bias: Optional[torch.Tensor],
                   residual: Optional[torch.Tensor], in_scale: float,
                   activation: Optional[str], act_alpha: float,
                   out_scale: Optional[float], out_dtype: torch.dtype,
                   residual_scale: Optional[float]) -> torch.Tensor:
    """`matmul_int8` as a registered op: `b` is the weight or, with
    `b_shape`, its prepared copy."""
    return _matmul_int8(a, join_prepared(b, b_shape), w_scale, bias, residual,
                        in_scale=in_scale, activation=activation,
                        act_alpha=act_alpha, out_scale=out_scale,
                        out_dtype=out_dtype, residual_scale=residual_scale)


@matmul_int8_op.register_fake
def _(a, b, b_shape, w_scale, bias, residual, in_scale, activation,
      act_alpha, out_scale, out_dtype, residual_scale):
    return matmul_int8_plain(a, join_prepared(b, b_shape), w_scale, bias,
                             residual, in_scale=in_scale,
                             activation=activation, act_alpha=act_alpha,
                             out_scale=out_scale, out_dtype=out_dtype,
                             residual_scale=residual_scale)
