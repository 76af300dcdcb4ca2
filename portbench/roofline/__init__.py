"""Operations and bytes of one launch of each hand-written kernel.

One module a kernel, found by the kernel's name.  Each holds:

  * `WRAP`: (module, attribute) of the program's launch function, which
    the traced run wraps from the benchmark's side to record each launch;
  * `key(*args, **kwargs)`: the launch's shapes, read from its operands;
  * `MAIN`, `AUX`: regular expressions over the function names in the
    device trace (`AUX` kernels belong to a launch but do not count it,
    such as a split's reduction);
  * `cost(key) -> (operations, bytes, peak)`: what the launch's inputs
    need, each input byte read once and each output byte written once,
    and the name of the peak its operations run at (`peaks.PEAK_OPS`).
"""

from __future__ import annotations

import importlib
import os
import re
from typing import Dict, List

from .peaks import bound_s

__all__ = ["KERNELS", "kernel", "bound_s", "family_of"]

_HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS: List[str] = sorted(
    f[:-3] for f in os.listdir(_HERE)
    if f.endswith(".py") and f not in ("__init__.py", "peaks.py"))


def kernel(name: str):
    """The module of kernel `name` (`roofline/<name>.py`)."""
    return importlib.import_module(f"{__name__}.{name}")


_PATTERNS: Dict[str, tuple] = {}


def family_of(kernel_name: str):
    """(kernel, "main" or "aux") of a device-trace function name, or None."""
    if not _PATTERNS:
        for k in KERNELS:
            m = kernel(k)
            _PATTERNS[k] = (re.compile("|".join(m.MAIN)),
                            re.compile("|".join(m.AUX)) if m.AUX else None)
    for k, (main, aux) in _PATTERNS.items():
        if main.search(kernel_name):
            return k, "main"
        if aux is not None and aux.search(kernel_name):
            return k, "aux"
    return None
