"""Forward flash attention with causal and segment masks: the port of
`anakin_tpu/kernels/flash_attention.py::flash_attention`.

    s   = (q . k) * sm_scale, set to -0.7 * float32 max where masked
    out = softmax(s) @ v, in q's dtype

q [B, H, Sq, D], k and v [B, Hkv, Sk, D].  Unlike the JAX kernel, which
takes k and v already repeated to H heads, `flash_attention` also takes
grouped-query heads (H a multiple of Hkv; query head h reads kv head
h // (H // Hkv)), so the caller need not copy them.  Segment ids are
[B, Sq] and [B, Sk] int32, given together or not at all.

On a CUDA tensor it launches a hand-written Hopper kernel of
`csrc/flash_attention.cu`, on the route its dtype and head dim choose
(`route`): bf16 at D 64, 128 and 256 through `flash_wgmma` (TMA copies, a
producer warpgroup and one or two consumer warpgroups on wgmma), bf16 at D
32, 80 and 96 through `flash_bf16` (mma.sync), float32 through `flash_tf32`
(split-TF32 mma.sync, three TF32 products a float32 product).  The file's
header gives each design and the tolerance against `mha_reference`.
`flash_attention.launches` counts every launch, `flash_attention.
launches_f32` those of the float32 route and `flash_attention.
launches_wgmma` those of `flash_wgmma` beside it.
On a CPU tensor it runs `mha_reference`, the JAX package's dense golden
model in plain PyTorch.  Both mask a ragged S themselves, so no length has
to be padded.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_op", "mha_reference",
           "MASK_VALUE", "ROUTES", "head_dims", "route", "takes_head_dim"]

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# head dims the CUDA kernel is instantiated for; the float32 route's q tile
# and accumulator at 256 would not fit beside its split operands
_HEAD_DIMS = {torch.bfloat16: (32, 64, 80, 96, 128, 256),
              torch.float32: (32, 64, 80, 96, 128)}
# the kernel's routes, as `ak_flash_attention_route` numbers them
ROUTES = ("flash_wgmma", "flash_bf16", "flash_tf32")


def head_dims(dtype) -> tuple:
    """The head dims the CUDA kernel takes for q of `dtype`."""
    return _HEAD_DIMS.get(dtype, ())


def takes_head_dim(D: int, dtype) -> bool:
    return D in head_dims(dtype)


def _repeat_kv(x: torch.Tensor, heads: int) -> torch.Tensor:
    rep = heads // x.shape[1]
    return x if rep == 1 else torch.repeat_interleave(x, rep, dim=1)


def mha_reference(q, k, v, q_segment_ids=None, kv_segment_ids=None,
                  causal: bool = False,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """Dense attention in float32 (the plain version of `flash_attention`,
    on any device)."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    k, v = _repeat_kv(k, H), _repeat_kv(v, H)
    s = torch.matmul(q.to(torch.float32),
                     k.to(torch.float32).transpose(-1, -2)) * sm_scale
    mask = torch.ones((B, 1, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        rows = torch.arange(Sq, device=q.device)[:, None]
        cols = torch.arange(Sk, device=q.device)[None, :]
        mask = mask & (cols <= rows)[None, None]
    if q_segment_ids is not None:
        seg = q_segment_ids[:, :, None] == kv_segment_ids[:, None, :]
        mask = mask & seg[:, None]
    s = torch.where(mask, s, MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.to(torch.float32)).to(q.dtype)


def _check(q, k, v, q_segment_ids, kv_segment_ids):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("give both segment id arrays or neither")
    if q_segment_ids is not None and (
            tuple(q_segment_ids.shape) != (B, Sq)
            or tuple(kv_segment_ids.shape) != (B, k.shape[2])):
        raise ValueError("segment ids must be [B, Sq] and [B, Sk]")
    for t in (k, v, q_segment_ids, kv_segment_ids):
        if t is not None and t.device != q.device:
            raise ValueError("flash_attention operands on different devices")


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.ak_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for fn in (lib.ak_flash_attention_route, lib.ak_flash_attention_block_rows):
        fn.argtypes = [ctypes.c_int] * 6
        fn.restype = ctypes.c_int
    return lib


def route(dtype, B: int, H: int, Hkv: int, Sq: int, D: int):
    """(route name, query rows a block holds) of a CUDA launch at these
    shapes, as the built kernel chooses them (it needs the CUDA build).
    The route follows the dtype and D alone; the rows follow the grid."""
    lib, bf16 = _lib(), int(dtype == torch.bfloat16)
    code = lib.ak_flash_attention_route(bf16, B, H, Hkv, Sq, D)
    if code < 0:
        raise ValueError(f"no flash_attention route takes head dim {D} "
                         f"in {dtype}")
    return ROUTES[code], lib.ak_flash_attention_block_rows(bf16, B, H, Hkv,
                                                          Sq, D)


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None, *,
                    causal: bool = False,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q [B, H, Sq, D] over k, v [B, Hkv, Sk, D]; returns
    [B, H, Sq, D] in q's dtype.  Launches directly when eager; goes through
    the registered op `flash_attention_op` while a trace runs, as
    `matmul_int8` does."""
    _check(q, k, v, q_segment_ids, kv_segment_ids)
    B, H, Sq, D = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if torch.compiler.is_compiling():  # a trace records the registered op
        return flash_attention_op(q, k, v, q_segment_ids, kv_segment_ids,
                                  bool(causal), float(sm_scale))
    return _flash_attention(q, k, v, q_segment_ids, kv_segment_ids,
                            causal=causal, sm_scale=sm_scale)


def _flash_attention(q, k, v, q_segment_ids, kv_segment_ids, *, causal,
                     sm_scale):
    """The wrapper's run on checked operands: the plain version on a CPU or
    meta tensor, the kernel launch on a CUDA one."""
    if _build.runs_plain(q.device, "flash_attention"):
        return mha_reference(q, k, v, q_segment_ids, kv_segment_ids,
                             causal=causal, sm_scale=sm_scale)
    B, H, Sq, D = q.shape
    if not takes_head_dim(D, q.dtype):
        raise ValueError(f"the CUDA flash_attention takes head dims "
                         f"{head_dims(q.dtype)} for {q.dtype}, got {D}")
    # the kernel reads rows with 16-byte loads
    q, k, v = (t.contiguous() if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    segs = [None if s is None else s.to(torch.int32).contiguous()
            for s in (q_segment_ids, kv_segment_ids)]
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ak_flash_attention(
            _ptr(q), _ptr(k), _ptr(v), _ptr(segs[0]), _ptr(segs[1]), _ptr(out),
            int(q.dtype == torch.bfloat16), B, H, k.shape[1], Sq, k.shape[2],
            D, int(bool(causal)), float(sm_scale), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    if q.dtype == torch.float32:
        flash_attention.launches_f32 += 1
    elif ROUTES[lib.ak_flash_attention_route(1, B, H, k.shape[1], Sq, D)] \
            == "flash_wgmma":
        flash_attention.launches_wgmma += 1
    return out


flash_attention.launches = 0
flash_attention.launches_f32 = 0
flash_attention.launches_wgmma = 0


@torch.library.custom_op("anakin_tpu_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       q_segment_ids: Optional[torch.Tensor],
                       kv_segment_ids: Optional[torch.Tensor], causal: bool,
                       sm_scale: float) -> torch.Tensor:
    """The kernel as a registered op (see `matmul_int8_op`)."""
    return _flash_attention(q, k, v, q_segment_ids, kv_segment_ids,
                            causal=causal, sm_scale=sm_scale)


@flash_attention_op.register_fake
def _(q, k, v, q_segment_ids, kv_segment_ids, causal, sm_scale):
    return mha_reference(q, k, v, q_segment_ids, kv_segment_ids,
                         causal=causal, sm_scale=sm_scale)
