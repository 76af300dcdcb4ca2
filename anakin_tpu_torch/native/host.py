"""ctypes bindings for the native host library (native/anakin_host.cpp):
the port's copy of `anakin_tpu/native/host.py`, so that the port loads the
same library without importing the JAX package.

The C ABI here plays the role of the reference's C API layer
(`framework/c_api/anakin_runner.h:9-56`): a stable boundary between the
Python engine and native host components (JPEG decode, batch preprocessing,
arena planning).  Every entry point has a NumPy fallback so the engine
works without the .so; `native_available()` reports which path is live.

Build: `make -C native` (produces native/libanakin_host.so).  A library
that does not load (built elsewhere, or `libjpeg.so.62` absent on this
machine) counts as absent, as an unbuilt one does.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

__all__ = ["native_available", "decode_jpeg", "preprocess_batch",
           "plan_arena_native", "load_safetensors"]

_LIB: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is not None:
        return _LIB
    here = os.path.dirname(os.path.abspath(__file__))
    cand = [
        os.path.join(here, "..", "..", "native", "libanakin_host.so"),
        os.path.join(here, "libanakin_host.so"),
    ]
    for p in cand:
        if os.path.exists(p):
            try:
                lib = ctypes.CDLL(p)
            except OSError:  # a dependency such as libjpeg is missing
                continue
            lib.ak_version.restype = ctypes.c_int
            lib.ak_decode_jpeg.restype = ctypes.c_int
            lib.ak_decode_jpeg.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int)]
            lib.ak_preprocess_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
            lib.ak_plan_arena.restype = ctypes.c_int64
            lib.ak_plan_arena.argtypes = [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.ak_st_open.restype = ctypes.c_void_p
            lib.ak_st_open.argtypes = [ctypes.c_char_p]
            lib.ak_st_count.restype = ctypes.c_int
            lib.ak_st_count.argtypes = [ctypes.c_void_p]
            lib.ak_st_name.restype = ctypes.c_char_p
            lib.ak_st_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.ak_st_dtype.restype = ctypes.c_char_p
            lib.ak_st_dtype.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.ak_st_shape.restype = ctypes.c_int
            lib.ak_st_shape.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            lib.ak_st_data.restype = ctypes.POINTER(ctypes.c_uint8)
            lib.ak_st_data.argtypes = [
                ctypes.c_void_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int64)]
            lib.ak_st_close.argtypes = [ctypes.c_void_p]
            _LIB = lib
            return lib
    return None


def native_available() -> bool:
    return _load() is not None


def decode_jpeg(data: bytes, max_pixels: int = 64 * 1024 * 1024) -> np.ndarray:
    """JPEG bytes -> RGB uint8 [H, W, 3] via libjpeg (native only)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built: make -C native")
    out = np.empty(max_pixels * 3, np.uint8)
    w = ctypes.c_int(0)
    h = ctypes.c_int(0)
    rc = lib.ak_decode_jpeg(data, len(data),
                            out.ctypes.data_as(ctypes.c_void_p), out.nbytes,
                            ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"jpeg decode failed (rc={rc})")
    return out[: h.value * w.value * 3].reshape(h.value, w.value, 3).copy()


def preprocess_batch(
    images: np.ndarray,                      # [N, H, W, C] uint8
    out_hw: Tuple[int, int],
    mean=(0.485, 0.456, 0.406),
    std=(0.229, 0.224, 0.225),
    num_threads: int = 0,
) -> np.ndarray:
    """Bilinear resize + normalize into NHWC fp32 (native path w/ fallback)."""
    images = np.ascontiguousarray(images, np.uint8)
    n, in_h, in_w, c = images.shape
    oh, ow = out_hw
    mean_a = np.asarray(mean, np.float32)
    std_a = np.asarray(std, np.float32)
    lib = _load()
    if lib is not None:
        out = np.empty((n, oh, ow, c), np.float32)
        threads = num_threads or min(n, os.cpu_count() or 1)
        lib.ak_preprocess_batch(
            images.ctypes.data_as(ctypes.c_void_p), n, in_h, in_w, c,
            out.ctypes.data_as(ctypes.c_void_p), oh, ow,
            mean_a.ctypes.data_as(ctypes.c_void_p),
            std_a.ctypes.data_as(ctypes.c_void_p), threads)
        return out
    return _preprocess_numpy(images, (oh, ow), mean_a, std_a)


def _preprocess_numpy(images, out_hw, mean, std) -> np.ndarray:
    """Reference/fallback implementation (half-pixel bilinear)."""
    n, in_h, in_w, c = images.shape
    oh, ow = out_hw
    fy = np.clip((np.arange(oh) + 0.5) * in_h / oh - 0.5, 0, in_h - 1)
    fx = np.clip((np.arange(ow) + 0.5) * in_w / ow - 0.5, 0, in_w - 1)
    y0 = np.floor(fy).astype(np.int64)
    x0 = np.floor(fx).astype(np.int64)
    y1 = np.minimum(y0 + 1, in_h - 1)
    x1 = np.minimum(x0 + 1, in_w - 1)
    wy = (fy - y0)[None, :, None, None].astype(np.float32)
    wx = (fx - x0)[None, None, :, None].astype(np.float32)
    img = images.astype(np.float32)
    top = img[:, y0][:, :, x0] * (1 - wx) + img[:, y0][:, :, x1] * wx
    bot = img[:, y1][:, :, x0] * (1 - wx) + img[:, y1][:, :, x1] * wx
    out = (top * (1 - wy) + bot * wy) / 255.0
    return ((out - mean) / std).astype(np.float32)


def plan_arena_native(sizes, births, deaths) -> Tuple[np.ndarray, int]:
    """First-fit arena offsets via the C++ planner (numpy fallback mirrors
    `anakin_tpu.graph.passes.memory.plan_memory`'s inner loop)."""
    sizes = np.ascontiguousarray(sizes, np.int64)
    births = np.ascontiguousarray(births, np.int32)
    deaths = np.ascontiguousarray(deaths, np.int32)
    n = len(sizes)
    lib = _load()
    offsets = np.empty(n, np.int64)
    if lib is not None:
        total = lib.ak_plan_arena(
            n, sizes.ctypes.data_as(ctypes.c_void_p),
            births.ctypes.data_as(ctypes.c_void_p),
            deaths.ctypes.data_as(ctypes.c_void_p),
            offsets.ctypes.data_as(ctypes.c_void_p))
        return offsets, int(total)
    # python fallback: same best-fit discipline
    free: list = []
    live: list = []
    top = 0
    for i in range(n):
        now = births[i]
        for k in range(len(live) - 1, -1, -1):
            if live[k][2] < now:
                free.append((live[k][0], live[k][1]))
                live.pop(k)
        best = -1
        for k, (off, bsz) in enumerate(free):
            if bsz >= sizes[i] and (best < 0 or bsz < free[best][1]):
                best = k
        if best >= 0:
            off, bsz = free.pop(best)
            live.append((off, bsz, deaths[i]))
        else:
            off = top
            top += int(sizes[i])
            live.append((off, int(sizes[i]), deaths[i]))
        offsets[i] = off
    return offsets, top


_ST_DTYPES = {
    "F32": np.float32, "F16": np.float16, "BF16": None, "F64": np.float64,
    "I8": np.int8, "U8": np.uint8, "I16": np.int16, "I32": np.int32,
    "I64": np.int64, "BOOL": np.bool_,
}


class _Mapping:
    """The native library's mapping of one file, closed once (when the last
    array that views it is gone)."""

    def __init__(self, lib, handle):
        self._lib = lib
        self._handle = handle

    def close(self) -> None:
        if self._handle:
            self._lib.ak_st_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


class _View:
    """`nbytes` read-only bytes at `ptr` as an array interface that keeps
    the mapping alive: every array made from it holds the mapping (the JAX
    package's copy ties the mapping to the returned dict alone, so an array
    kept after the dict is gone reads unmapped memory)."""

    def __init__(self, mapping: _Mapping, ptr, nbytes: int):
        self._mapping = mapping
        self.__array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "version": 3,
            "data": (ctypes.cast(ptr, ctypes.c_void_p).value, True)}


def load_safetensors(path: str, copy: bool = False):
    """mmap-based safetensors reader (native path; the C++ twin of the
    reference's model parser, `framework/model_parser/parser/parser.cpp`).

    Returns {name: ndarray}.  With copy=False the arrays are ZERO-COPY
    read-only views into the file mapping (pages fault in on first use —
    fast serving restarts); each array keeps the mapping alive.  A BF16
    entry comes back as bfloat16 values (ml_dtypes').  Returns None when
    the native library is not built or the file cannot be parsed (callers
    fall back to `model_io.serialize.read_safetensors`).
    """
    lib = _load()
    if lib is None:
        return None
    h = lib.ak_st_open(os.fsencode(path))
    if not h:
        return None
    mapping = _Mapping(lib, h)
    out = {}
    shape_buf = (ctypes.c_int64 * 16)()
    nbytes = ctypes.c_int64(0)
    for i in range(lib.ak_st_count(h)):
        name = lib.ak_st_name(h, i).decode()
        dt_name = lib.ak_st_dtype(h, i).decode()
        dt = _ST_DTYPES.get(dt_name)
        ndim = lib.ak_st_shape(h, i, shape_buf)
        shape = tuple(shape_buf[k] for k in range(ndim))
        ptr = lib.ak_st_data(h, i, ctypes.byref(nbytes))
        raw = (np.asarray(_View(mapping, ptr, nbytes.value)) if nbytes.value
               else np.empty(0, np.uint8))
        if dt is None and dt_name == "BF16":
            # bfloat16 values, as the port's own reader gives them (the
            # JAX package's copy gives the raw bits as uint16)
            import ml_dtypes

            arr = raw.view(ml_dtypes.bfloat16).reshape(shape)
        elif dt is None:
            return None  # the mapping closes with the last reference
        else:
            arr = raw.view(dt).reshape(shape)
        arr.flags.writeable = False
        if copy:
            arr = arr.copy()
        out[name] = arr
    return out
