"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` is compiled by one `nvcc` call for Hopper
(`sm_90a`) into a shared library with a plain C interface, under
`build/anakin_tpu_torch/` beside the package.  The library's file name
carries a hash of the source and the headers, so an edited source builds
again and an unchanged one is loaded as it is.  `build_all` starts every
source's `nvcc` at once, since each call is seconds long and independent.

Nothing here runs at import: the CPU has no `nvcc`, and the tests import
every module.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

__all__ = ["SOURCES", "build", "build_all", "load", "runs_plain"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "anakin_tpu_torch")
SOURCES = ("matmul_int8", "conv3x3_int8", "flash_attention", "matmul_w4",
           "depthwise3x3_int8", "bottleneck_int8")


def runs_plain(device, kernel: str) -> bool:
    """How a kernel wrapper treats a tensor on `device`: True for the CPU
    (the plain version computes the result) and for `meta` (shape
    inference: the plain version computes shapes only, no values); False
    for CUDA, where the wrapper launches its kernel.  Any other device
    raises, so nothing falls back quietly."""
    if device.type in ("cpu", "meta"):
        return True
    if device.type != "cuda":
        raise ValueError(f"{kernel} runs on cuda or cpu, not {device}")
    return False

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the port's "
                           "kernels are built with nvcc at first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, name + ".cu")] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(name: str) -> Tuple[str, float, str]:
    """Compile `csrc/<name>.cu` unless its library exists.  Returns the
    library path, the seconds `nvcc` took (0 when nothing was built) and
    what `nvcc` printed (ptxas registers, shared memory and spills)."""
    lib = _library_path(name)
    if os.path.exists(lib):
        return lib, 0.0, ""
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, lib)  # atomic, so a concurrent load sees all or none
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib, time.perf_counter() - t0, proc.stdout + proc.stderr


def build_all() -> Dict[str, Tuple[str, float, str]]:
    """Build every kernel source, all `nvcc` calls at once."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return dict(zip(SOURCES, pool.map(build, SOURCES)))


def load(name: str) -> ctypes.CDLL:
    """The library of `csrc/<name>.cu`, built first if needed."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(build(name)[0])
        return _loaded[name]
