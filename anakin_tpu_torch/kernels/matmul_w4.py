"""Weight-only int4 matmul with group-wise scales: the port of
`anakin_tpu/kernels/matmul_w4.py::matmul_w4`, variants v1 and v2.

    v1: W[k, n] = cast_to_x_dtype(float(int4[k, n]) * scales[k // G, n])
    v2: W[k, n] = cast_to_x_dtype(float(int4[k, n]) * cast_to_x_dtype(scales))
    out = x @ W as [M, N] float32

x [M, K] bf16 or float32, packed [K/2, N] int8 and scales [K/G, N]
float32 or bf16 (read as they are handed over; widening bf16 is exact) in
the layout of `quant.quantize._w4_group_quantize`: in each group of G
rows, packed row r holds row r in its low nibble and row r + G/2 in its
high nibble.  The epilogue (bias, residual, activation) stays with the
caller, as in the JAX package.

v2 is the Pallas kernel's second unpack (`_make_kernel_v2`), written in
x's dtype: `unpack_w4_v2` repeats its steps.  Every product there is exact
before its one rounding, so v2 differs from v1 only where float32 scales
meet bf16 x: v2 rounds the scale to bf16 before the product.  The JAX
package runs v1 for any variant name but "v2"; the port raises on an
unknown name.

On a CUDA tensor `matmul_w4` launches the hand-written Hopper kernel in
`csrc/matmul_w4.cu` (v1 and v2 share its routes and differ only in the
dequant; `matmul_w4.launches` counts v1's launches, `matmul_w4.launches_v2`
v2's, `matmul_w4.launches_wgmma` those of either variant that take the
wgmma route, and `matmul_w4.launches_f32` those on the two float32 routes);
on a CPU tensor it runs `matmul_w4_plain`.  Both take every group the
quantizer writes: any even G that divides K.  The kernel's routes (`route`
names the one a launch takes): "small" for bf16 x with M <= 16 (the decode
steps), "wgmma" for bf16 x with M > 16 (the bucket admissions),
"small_tf32" and "wgmma_tf32" for float32 x with M <= 16 and M > 16, each
for every group that is a multiple of 32, and "rows" for the other groups
(G 6, 16, 48, or K = G = 100).  The bf16 routes and "rows" agree with the
plain version up to the order of the float32 sums.  The float32 routes
run on the TF32 tensor cores, x split into a TF32 high and low part and
the nibble exact, and stay within the same bound, 2 K 2^-24 (|x| @ |W|):
x_hi + x_lo is x within 2^-21 of |x|, and the group scale multiplies the
group's float32 sum where `unpack_w4` rounds each weight.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["matmul_w4", "matmul_w4_plain", "matmul_w4_op", "route",
           "unpack_w4", "unpack_w4_v2"]

VARIANTS = ("v1", "v2")
ROUTES = ("small", "wgmma", "small_tf32", "wgmma_tf32", "rows")  # by code
F32_ROUTES = ("small_tf32", "wgmma_tf32")  # float32 x on the TF32 tensor cores


def unpack_w4(packed: torch.Tensor, scales: torch.Tensor, group: int,
              dtype: torch.dtype) -> torch.Tensor:
    """The dequantized weight [K, N] in `dtype`: nibbles sign-extended,
    times the group's float32 scale, then rounded to `dtype`."""
    K2, N = packed.shape
    K = 2 * K2
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = p >> 4
    ng = K // group
    w = torch.cat([lo.reshape(ng, group // 2, N), hi.reshape(ng, group // 2, N)],
                  dim=1).to(torch.float32)
    w = w * scales.to(torch.float32)[:, None, :]
    return w.reshape(K, N).to(dtype)


def unpack_w4_v2(packed: torch.Tensor, scales: torch.Tensor, group: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """v2's dequantized weight [K, N], each step in `dtype` as the Pallas
    kernel takes it: s = dtype(scale); low nibble (lo_u ^ 8) - 8, times s;
    high nibble p - lo_u (16 times its value), times s / 16."""
    K2, N = packed.shape
    ng = 2 * K2 // group
    lo_u = packed & 0xF
    s = scales.to(dtype)[:, None, :]
    lo = (lo_u ^ 8).to(dtype) - 8.0
    hi16 = packed.to(dtype) - lo_u.to(dtype)
    w_lo = lo.reshape(ng, group // 2, N) * s
    w_hi = hi16.reshape(ng, group // 2, N) * (s * 0.0625)
    return torch.cat([w_lo, w_hi], dim=1).reshape(2 * K2, N)


def matmul_w4_plain(x: torch.Tensor, packed: torch.Tensor,
                    scales: torch.Tensor, *, group: int,
                    variant: str = "v1") -> torch.Tensor:
    """`matmul_w4` in plain PyTorch, on any device: dequantize, then one
    float32 product (bf16 operands are exact in float32)."""
    unpack = unpack_w4_v2 if variant == "v2" else unpack_w4
    w = unpack(packed, scales, group, x.dtype)
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def _check(x, packed, scales, group, variant):
    if variant not in VARIANTS:
        raise ValueError(f"matmul_w4 variant {variant!r}: the variants are "
                         f"{VARIANTS}")
    if x.dim() != 2 or packed.dim() != 2 or x.shape[1] != 2 * packed.shape[0]:
        raise ValueError(f"matmul_w4 shapes x {tuple(x.shape)}, packed "
                         f"{tuple(packed.shape)}")
    K, N = x.shape[1], packed.shape[1]
    if group <= 0 or group % 2 or K % group or tuple(scales.shape) != (K // group, N):
        raise ValueError(f"matmul_w4: K {K}, group {group}, scales "
                         f"{tuple(scales.shape)}")
    floats = (torch.float32, torch.bfloat16)
    if x.dtype not in floats or scales.dtype not in floats \
            or packed.dtype != torch.int8:
        raise TypeError(f"matmul_w4 takes float32/bf16 x and scales and int8 "
                        f"packed weights, got {x.dtype}, {scales.dtype}, "
                        f"{packed.dtype}")
    if packed.device != x.device or scales.device != x.device:
        raise ValueError("matmul_w4 operands on different devices")


def _lib() -> ctypes.CDLL:
    lib = _build.load("matmul_w4")
    for fn in (lib.ak_matmul_w4_splits, lib.ak_matmul_w4_route,
               lib.ak_matmul_w4_kernel_splits):
        fn.argtypes = [ctypes.c_int] * 5
        fn.restype = ctypes.c_int
    lib.ak_matmul_w4.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    lib.ak_matmul_w4.restype = ctypes.c_int
    return lib


def _dtypes(x_dtype: torch.dtype, scale_dtype: torch.dtype) -> int:
    """The kernel's dtype flags: bit 0 bf16 x, bit 1 bf16 scales."""
    return (int(x_dtype == torch.bfloat16)
            | 2 * int(scale_dtype == torch.bfloat16))


def route(M: int, N: int, K: int, group: int, x_dtype: torch.dtype,
          scale_dtype: torch.dtype):
    """(route name, splits of K) of a kernel launch at these shapes, as
    the built kernel chooses them (it needs the CUDA build)."""
    lib, flags = _lib(), _dtypes(x_dtype, scale_dtype)
    return (ROUTES[lib.ak_matmul_w4_route(M, N, K, group, flags)],
            lib.ak_matmul_w4_kernel_splits(M, N, K, group, flags))


def matmul_w4(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *,
              group: int, variant: str = "v1") -> torch.Tensor:
    """x [M, K] @ dequant(packed [K/2, N], scales [K/G, N]) -> [M, N]
    float32, with the dequant of `variant` ("v1" or "v2").  Launches
    directly when eager; goes through the registered op `matmul_w4_op`
    while a trace runs, as `matmul_int8` does."""
    _check(x, packed, scales, group, variant)
    if torch.compiler.is_compiling():  # a trace records the registered op
        return matmul_w4_op(x, packed, scales, int(group), variant)
    return _matmul_w4(x, packed, scales, group=group, variant=variant)


def _matmul_w4(x, packed, scales, *, group, variant):
    """The wrapper's run on checked operands: the plain version on a CPU or
    meta tensor, the kernel launch on a CUDA one."""
    if _build.runs_plain(x.device, "matmul_w4"):
        return matmul_w4_plain(x, packed, scales, group=group, variant=variant)
    M, K = x.shape
    N = packed.shape[1]
    x = x.contiguous()
    if x.data_ptr() % 16:  # copied in 16-byte pieces (cp.async, TMA)
        x = x.clone()
    packed = packed.contiguous()
    scales = scales.contiguous()
    lib = _lib()
    dtypes = _dtypes(x.dtype, scales.dtype)
    splits = lib.ak_matmul_w4_splits(M, N, K, group, dtypes)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ak_matmul_w4(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(packed.data_ptr()),
            ctypes.c_void_p(scales.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(None if ws is None else ws.data_ptr()), dtypes,
            int(variant == "v2"), M, N, K, group, splits,
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"matmul_w4 kernel launch failed: CUDA error {rc}")
    if variant == "v2":
        matmul_w4.launches_v2 += 1
    else:
        matmul_w4.launches += 1
    name = ROUTES[lib.ak_matmul_w4_route(M, N, K, group, dtypes)]
    if name == "wgmma":
        matmul_w4.launches_wgmma += 1
    elif name in F32_ROUTES:
        matmul_w4.launches_f32 += 1
    return out


matmul_w4.launches = 0
matmul_w4.launches_v2 = 0
matmul_w4.launches_wgmma = 0
matmul_w4.launches_f32 = 0


@torch.library.custom_op("anakin_tpu_torch::matmul_w4", mutates_args=())
def matmul_w4_op(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                 group: int, variant: str) -> torch.Tensor:
    """The kernel as a registered op (see `matmul_int8_op`); `variant`
    picks v1 or v2."""
    return _matmul_w4(x, packed, scales, group=group, variant=variant)


@matmul_w4_op.register_fake
def _(x, packed, scales, group, variant):
    return matmul_w4_plain(x, packed, scales, group=group, variant=variant)
