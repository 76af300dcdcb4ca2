"""One run of one cell: set-up, the measured window, the check against the
reference, the metrics.  `run.py` is the command line; the tests call
`run_cell` on the CPU at small sizes."""

from __future__ import annotations

import contextlib
import gc
import importlib
import os
import time
from typing import Dict, Optional

import torch

from . import spec
from .metrics import reader
from .trace import DeviceTrace, Launches

__all__ = ["run_cell", "process_seconds", "Context"]


def process_seconds() -> float:
    """Seconds since this process started (the kernel's start time, at
    clock-tick resolution), or since this module was imported where /proc
    is missing."""
    try:
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


class Context:
    """What a cell's runner is given: the cell, the seed, the window, the
    device, and the traced run's instruments."""

    def __init__(self, cell: spec.Cell, seed: int, seconds: float,
                 trace: bool, device: torch.device):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.config, self.traffic = cell.config, cell.traffic
        self.device = device
        self.launches = Launches().install() if trace else None
        self.trace_data = None
        self.trace_bytes = 0
        self._trace = None

    def traced(self):
        """A context that profiles its block in a traced run (nothing in an
        untraced one); the trace is read back by `finish_trace`."""
        if self.launches is None:
            return contextlib.nullcontext()
        self._trace = DeviceTrace(os.path.join(
            spec.OUT, f"trace-{self.cell.name}-{self.seed}.json"),
            self.launches)
        return self._trace

    def finish_trace(self) -> None:
        t = self._trace
        if t is not None:
            self.trace_data = t.finish()
            self.trace_bytes = t.bytes
            self._trace = None


def _checks(numbers: Dict[str, float], cell: spec.Cell) -> Dict:
    return {k: {"value": float(v), "limit": float(cell.limits[k]["limit"])}
            for k, v in numbers.items()}


def judge(failed: int, checks: Dict) -> bool:
    """`correct`: no request failed, something was compared, and every
    number compared is within its limit."""
    return (failed == 0 and bool(checks)
            and all(c["value"] <= c["limit"] for c in checks.values()))


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", cell: Optional[spec.Cell] = None,
             log=print, control: bool = False) -> Dict:
    """Run the cell once and return the result object (see run.py).
    `control`: also read the lower-precision control in the program's
    place on the same sample and judge it by the same limits, under
    "control": {"correct", "checks"} (the calibration's; the benchmark's
    runs do not)."""
    cell = cell if cell is not None else spec.load_cell(cell_name)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    ctx = Context(cell, seed, seconds, trace, dev)
    builder = importlib.import_module(
        f"{__package__}.models.{cell.config['builder']}")
    runner = builder.Runner(ctx)
    try:
        t_pre = process_seconds()
        runner.setup()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = process_seconds()
        log(f"setup_s {setup_s:.2f}: {t_pre:.2f} before the runner's "
            f"set-up (interpreter, imports), {setup_s - t_pre:.2f} in it")
        runner.window()
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        ctx.finish_trace()
        e2e = dict(runner.end_to_end(), setup_s=setup_s)
        per_layer = {}
        if trace:
            for m in cell.per_layer:
                v = reader(m["name"])(runner, m["name"])
                if v is not None:
                    per_layer[m["name"]] = {"value": float(v),
                                            "unit": m["unit"]}
        attempted, failed = runner.counts()
    finally:
        runner.release()
        if ctx.launches is not None:
            ctx.launches.uninstall()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    checks = _checks(runner.check(), cell)
    correct = judge(failed, checks)
    metrics = ({m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                for m in cell.end_to_end} if not trace else per_layer)
    out = {"correct": correct, "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics,
           "device": _device(dev, peak, ctx)}
    if trace and ctx.trace_data is not None:
        td = ctx.trace_data
        out["device"].update(busy_s=td.busy_s, window_s=td.window_s)
        out["breakdown"] = {"device_ops": td.device_ops,
                            "idle_gaps": td.idle_gaps}
        log(f"trace: {ctx.trace_bytes} bytes written and deleted")
    if control:
        cc = _checks(runner.check(control=True), cell)
        out["control"] = {"correct": judge(0, cc), "checks": cc}
    out["checks"] = checks
    return out


def _device(dev: torch.device, peak: int, ctx: Context) -> Dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": int(peak)}
