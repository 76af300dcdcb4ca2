"""The traced run's instruments, all from the benchmark's side.

`Launches` wraps each kernel's launch function (`roofline/<kernel>.py`'s
`WRAP`) to record the launch's shapes: a launch made while a CUDA graph is
being captured is added to that capture's list (its replays launch the
same kernels again without calling any Python); a launch made inside a
call of `Net.prediction` (a step, an admission) that began while the
profiler ran is added to that call's unit, with the call's host-clock
interval.  The profiler records annotations only on the thread that
started it, so the units are placed in the trace by the host clock,
calibrated on the traced window's own span.

`DeviceTrace` runs `torch.profiler` (CUDA activity only: recording every
CPU op would slow the host, and the idle share with it) over part of the
window, between two `torch.cuda.synchronize()` calls of the main thread
that mark the traced window in the trace and on the host clock; once the
window has closed it writes the trace under `portbench/out/` and reads it
back: every kernel, memcpy and memset, which unit each eager kernel belongs
to, which graph replay each graph kernel belongs to, the device's busy time
in the traced window, and the runtime call the host was in during each
idle gap.
"""

from __future__ import annotations

import bisect
import collections
import heapq
import contextlib
import functools
import importlib
import json
import os
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from . import roofline

__all__ = ["Launches", "DeviceTrace", "TraceData"]


class Launches:
    """The launch recorder (see the module docstring).  `captures`: one
    list of (kernel, key) a captured graph; `units`: [t0_us, t1_us,
    [(kernel, key), ...]] of each `Net.prediction` call begun while
    `active`, on the host clock (`time.perf_counter`).  `mark_us`: the
    host clock just before the traced window's first synchronize, on the
    thread `mark_tid`."""

    def __init__(self):
        self.captures: List[List[Tuple[str, tuple]]] = []
        self.units: List[list] = []
        self.active = False
        self.mark_us = None      # host clock just before the first sync
        self.mark_tid = None
        self.span_s = 0.0        # the traced window on the host clock
        self._capturing = False
        self._local = threading.local()
        self._undo = []

    def install(self) -> "Launches":
        for name in roofline.KERNELS:
            spec = roofline.kernel(name)
            mod = importlib.import_module(spec.WRAP[0])
            self._patch(mod, spec.WRAP[1],
                        self._wrap(name, spec.key, getattr(mod, spec.WRAP[1])))
        from anakin_tpu_torch.runtime.net import Net

        self._patch(Net, "prediction", self._unit(Net.prediction))
        return self

    def _patch(self, owner, attr, new):
        self._undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    def uninstall(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo = []

    def _unit(self, fn):
        @functools.wraps(fn)
        def prediction(*args, **kwargs):
            if not self.active:
                return fn(*args, **kwargs)
            unit = [time.perf_counter_ns() / 1e3, None, []]
            self._local.unit = unit
            try:
                return fn(*args, **kwargs)
            finally:
                unit[1] = time.perf_counter_ns() / 1e3
                self._local.unit = None
                self.units.append(unit)
        return prediction

    def _wrap(self, name, keyfn, fn):
        @functools.wraps(fn)
        def launch(*args, **kwargs):
            capturing = (torch.cuda.is_available()
                         and torch.cuda.is_current_stream_capturing())
            if capturing:
                if not self._capturing:
                    self.captures.append([])
                self.captures[-1].append((name, keyfn(*args, **kwargs)))
            else:
                unit = getattr(self._local, "unit", None)
                if unit is not None:
                    unit[2].append((name, keyfn(*args, **kwargs)))
            self._capturing = capturing
            return fn(*args, **kwargs)
        return launch


def short_name(name: str) -> str:
    """A device function's name without its argument list."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return ("".join(out) or name)[:120]


class TraceData:
    """What the device trace holds, read back (times in seconds)."""

    def __init__(self, events: List[dict], launches: Launches):
        syncs = [e for e in events if e.get("ph") == "X"
                 and e.get("cat") == "cuda_runtime"
                 and e.get("name", "").startswith("cudaDeviceSynchronize")]
        mine = [e for e in syncs if e.get("tid") == launches.mark_tid]
        syncs = sorted(mine or syncs, key=lambda e: float(e["ts"]))
        if len(syncs) < 2:  # no CUDA (the CPU tests): the host clock's window
            self.window_s, self.busy_s = launches.span_s, 0.0
            self.device_ops, self.idle_gaps = [], []
            self.graphs, self.units, self.unit_cost = {}, [], []
            return
        w0 = float(syncs[0]["ts"])
        w1 = float(syncs[-1]["ts"]) + float(syncs[-1]["dur"])
        self.window_s = (w1 - w0) * 1e-6
        dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in
               ("kernel", "gpu_memcpy", "gpu_memset")]
        # device busy: the union of every operation's interval in the window
        spans = sorted((max(w0, float(e["ts"])),
                        min(w1, float(e["ts"]) + float(e["dur"])))
                       for e in dev)
        busy, gaps, end = 0.0, [], w0
        for a, b in spans:
            if b <= a:
                continue
            if a > end:
                gaps.append((end, a))
            if b > end:
                busy += b - max(a, end)
                end = b
        if end < w1:
            gaps.append((end, w1))
        self.busy_s = busy * 1e-6
        inside = [e for e in dev if w0 <= float(e["ts"]) < w1]
        ops = collections.Counter()
        for e in inside:
            ops[short_name(e["name"])] += float(e["dur"]) * 1e-6
        self.device_ops = [[k, v] for k, v in ops.most_common(10)]
        self.idle_gaps = self._name_gaps(events, gaps)
        self._match(events, [e for e in inside if e.get("cat") == "kernel"],
                    launches, w0, w1)

    @staticmethod
    def _name_gaps(events, gaps):
        """The idle gaps summed by the host activity under each gap's middle:
        the innermost host span in the trace (a runtime or driver call)
        covering it, found in one sweep; "no runtime call" where the host
        was in Python.  Gaps under 20 us are summed apart."""
        host = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events if e.get("ph") == "X" and e.get("cat") in
            ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
            and not e.get("name", "").startswith("cudaDeviceSynchronize"))
        by = collections.Counter()
        heap, i = [], 0     # spans begun so far, latest start on top
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            if b - a < 20.0:  # us: a launch's own latency
                by["gaps under 20 us between device operations"] += \
                    (b - a) * 1e-6
                continue
            mid = (a + b) / 2
            while i < len(host) and host[i][0] <= mid:
                heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
                i += 1
            while heap and heap[0][1] < mid:   # ended before every later mid
                heapq.heappop(heap)
            name = ("host: " + heap[0][2]) if heap else \
                "host: no runtime call (Python)"
            by[name] += (b - a) * 1e-6
        return [[k, v] for k, v in by.most_common(10)]

    def _match(self, events, kernels, launches, w0, w1):
        """Each kernel's launch.  `graphs` = {correlation: {kernel: [main
        count, device s]}} for the kernels a graph replay launched;
        `units` = [{kernel or None: device s}] and `unit_cost` = [{kernel:
        (Σ bound s)}] for each recorded unit inside the window whose every
        kernel's count of launches in the trace equals the recorded one
        (a unit cut by the window's end, or blurred by the clock, is
        left out)."""
        runtime = {}
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and "args" in e:
                c = e["args"].get("correlation")
                if c is not None:
                    runtime[c] = e
        offset = w0 - launches.mark_us if launches.mark_us is not None else 0
        units = sorted((u[0] + offset, u[1] + offset, u[2])
                       for u in launches.units if u[1] is not None)
        starts = [u[0] for u in units]
        self.graphs: Dict[int, Dict[str, list]] = collections.defaultdict(dict)
        seen = [collections.Counter() for _ in units]     # main launches
        time_by = [collections.Counter() for _ in units]  # device s
        for k in kernels:
            fam = roofline.family_of(k["name"])
            dur = float(k["dur"]) * 1e-6
            corr = k.get("args", {}).get("correlation")
            rt = runtime.get(corr)
            if rt is None:
                continue
            if "Graph" in rt["name"]:
                if fam is not None:
                    g = self.graphs[corr].setdefault(fam[0], [0, 0.0])
                    g[0] += fam[1] == "main"
                    g[1] += dur
                continue
            t = float(rt["ts"])
            j = bisect.bisect_right(starts, t) - 1
            if j < 0 or units[j][1] < t:
                continue
            time_by[j][fam[0] if fam else None] += dur
            if fam is not None and fam[1] == "main":
                seen[j][fam[0]] += 1
        self.units, self.unit_cost = [], []
        for (a, b, recs), n_seen, secs in zip(units, seen, time_by):
            want = collections.Counter(n for n, _ in recs)
            if a < w0 or b > w1 or want != n_seen:
                continue
            cost = collections.Counter()
            for name, key in recs:
                cost[name] += roofline.bound_s(*roofline.kernel(name).cost(key))
            self.units.append(dict(secs))
            self.unit_cost.append(dict(cost))

    def share(self, kernel: str, scope: str, captures) -> Optional[float]:
        """Σ bound ÷ Σ device time, in %, over the kernel's launches in the
        trace: `scope` "eager" (launches made from Python inside the whole
        units, matched to their recorded shapes) or "graph" (graph replays whose count of the kernel's
        launches equals that of a captured graph whose launches all share
        one multiset; each replay counted whole).  None if nothing was
        found."""
        spec = roofline.kernel(kernel)
        bound = dev = 0.0
        if scope == "eager":
            for secs, cost in zip(self.units, self.unit_cost):
                if kernel in cost and secs.get(kernel, 0) > 0:
                    bound += cost[kernel]
                    dev += secs[kernel]
        else:
            per_count: Dict[int, set] = collections.defaultdict(set)
            for cap in captures:
                keys = tuple(sorted(k for n, k in cap if n == kernel))
                if keys:
                    per_count[len(keys)].add(keys)
            for g in self.graphs.values():
                if kernel not in g:
                    continue
                n, t = g[kernel]
                kinds = per_count.get(n, set())
                if len(kinds) != 1:
                    continue
                (keys,) = kinds
                bound += sum(roofline.bound_s(*spec.cost(k)) for k in keys)
                dev += t
        return 100.0 * bound / dev if dev > 0 else None


class DeviceTrace:
    """`with DeviceTrace(path, launches):` profiles the block's CUDA
    activity between two synchronizes of this thread; `finish()`, called
    once the measured window has closed, writes the trace, reads it back
    into `.data` (`TraceData`) and deletes the file (its size in
    `.bytes`)."""

    def __init__(self, path: str, launches: Launches):
        self.path, self.launches = path, launches
        self.data: Optional[TraceData] = None
        self.bytes = 0

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CUDA
                if torch.cuda.is_available()
                else torch.profiler.ProfilerActivity.CPU]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self.launches.mark_tid = threading.get_native_id()
        self.launches.mark_us = time.perf_counter_ns() / 1e3
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.launches.active = True
        return self

    def __exit__(self, *exc):
        self.launches.active = False
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.launches.span_s = (time.perf_counter_ns() / 1e3
                                - self.launches.mark_us) * 1e-6
        self._prof.__exit__(*exc)
        # the profiler has been seen to come back with no CUDA activity at
        # all; a caller can then trace again
        self.empty = torch.cuda.is_available() and not any(
            e.name().startswith("cudaDeviceSynchronize")
            for e in self._prof.profiler.kineto_results.events())
        return False

    def finish(self) -> "TraceData":
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        self.bytes = os.path.getsize(self.path)
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        with contextlib.suppress(OSError):
            os.remove(self.path)
        self._prof = None
        self.data = TraceData(events, self.launches)
        return self.data
