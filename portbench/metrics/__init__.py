"""Per-layer metric readers.  The reader of metric `<name>` is
`metrics/<name>.py` where that file exists, else the family's,
`metrics/<name up to its first dot>.py`; each has `read(run, name)`: the
value, or None where the run holds nothing to read (the harness then
leaves the metric out).  `run` is the cell's runner after its window,
holding its raw records (see the runner's module); its `trace` is the
traced run's `trace.TraceData`.  The arithmetic is the reader's."""

import importlib.util
import os
from typing import Callable, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))


def reader(name: str) -> Callable:
    """The `read` function of metric `name`."""
    path = os.path.join(_HERE, name + ".py")
    if not os.path.exists(path):
        path = os.path.join(_HERE, name.split(".")[0] + ".py")
    mod_name = f"{__name__}." + os.path.basename(path)[:-3].replace(
        ".", "__").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def tag(name: str) -> str:
    """The part of a metric's name after its first dot ("" if none)."""
    return name.split(".", 1)[1] if "." in name else ""


def in_span(run, t: float) -> bool:
    """Whether host time `t` lies in the part of the window the span
    metrics read: the whole window, or in a traced run the part before
    the trace."""
    return run.t_open <= t <= run.t_mid


def admitted(run):
    """The requests whose first token (the end of their admission) came
    in the spans' part of the window."""
    return [r for r in run.sent if r.times and in_span(run, r.times[0])]


def kernel_share(run, kernel: str, scope: str) -> Optional[float]:
    """A kernel's share of its roofline over the traced window, in %."""
    td = run.trace
    if td is None:
        return None
    captures = run.ctx.launches.captures if run.ctx.launches else []
    return td.share(kernel, scope, captures)
