"""The span metrics' readers (`between_windows_ms`, `window_launch_ms`,
`queue_wait_ms_p90`, `admission_pad_pct`): finite on a small CPU run of
each LLM cell, None where the scheduler has no span recorder (an older
program).  On the card (`gpu`): the program's spans share the device
trace's clock, so every graph launch of a traced run of B falls inside a
`window.launch` span; the run's idle gaps split by the program span around
them are left in `portbench/out/span_idle-<cell>.json`, the run's spans
and the trace's gaps in `span_raw-<cell>.json`."""

import bisect
import collections
import heapq
import json
import math
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness, spec
from portbench import trace as trace_mod
from portbench.metrics import reader
from portbench.models import decoder_w4
from portbench.tests import tiny

SPAN_METRICS = {tiny.B: ("between_windows_ms.decode",
                         "window_launch_ms.decode"),
                tiny.C: ("queue_wait_ms_p90.prompt",
                         "admission_pad_pct.prompt")}
ALL = [m for ms in SPAN_METRICS.values() for m in ms]
TOP = ("window", "admission", "step", "chunk", "admit", "idle")


def _keep_runner(monkeypatch, kept):
    """Keep the runner's spans and records as `release` frees it."""
    real = decoder_w4.Runner.release

    def release(self):
        if self.sched is not None:
            kept.update(run=self, spans=self.sched.spans.snapshot(),
                        readings={m: reader(m)(self, m) for m in ALL})
        real(self)

    monkeypatch.setattr(decoder_w4.Runner, "release", release)


@pytest.mark.parametrize("name", [tiny.B, tiny.C])
def test_readers_read_a_small_cpu_run(monkeypatch, name):
    kept = {}
    _keep_runner(monkeypatch, kept)
    out = harness.run_cell(name, 2 ** 31 + 99, 10.0, True, device="cpu",
                           cell=tiny.cell(name), log=lambda *a: None)
    assert out["correct"] is True, out["checks"]
    for m in SPAN_METRICS[name]:
        assert math.isfinite(out["metrics"][m]["value"]), m
    got = kept["readings"]
    for m in ALL:
        assert got[m] is not None and math.isfinite(got[m]), (m, got)
    assert got["window_launch_ms.decode"] > 0
    assert got["queue_wait_ms_p90.prompt"] >= 0
    assert 0 < got["admission_pad_pct.prompt"] < 100


@pytest.mark.parametrize("metric", ALL)
def test_readers_give_none_without_a_recorder(metric):
    stub = SimpleNamespace(sched=SimpleNamespace(phase_seconds={}),
                           t_open=0.0, t_mid=1e12, t_close=1e12)
    assert reader(metric)(stub, metric) is None
    empty = SimpleNamespace(snapshot=lambda: [])
    stub.sched.spans = empty
    assert reader(metric)(stub, metric) is None


# ------------------------------------------------------------ on the card

def _window(events, mark_tid):
    """The traced window [w0, w1] in trace us, as `trace.TraceData` finds
    it: from the first to the last synchronize of the marking thread (of
    any thread where the trace numbers threads otherwise)."""
    syncs = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "cuda_runtime"
             and e.get("name", "").startswith("cudaDeviceSynchronize")]
    syncs = sorted([e for e in syncs if e.get("tid") == mark_tid] or syncs,
                   key=lambda e: float(e["ts"]))
    return float(syncs[0]["ts"]), float(syncs[-1]["ts"] + syncs[-1]["dur"])


def _gaps(events, w0, w1):
    spans = sorted((max(w0, float(e["ts"])),
                    min(w1, float(e["ts"]) + float(e["dur"])))
                   for e in events if e.get("ph") == "X" and e.get("cat")
                   in ("kernel", "gpu_memcpy", "gpu_memset"))
    gaps, end = [], w0
    for a, b in spans:
        if b <= a:
            continue
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if end < w1:
        gaps.append((end, w1))
    return gaps


def _trace_parts(events, launches):
    """What the analysis needs of a device trace: the traced window, its
    idle gaps and its graph launches (trace us)."""
    w0, w1 = _window(events, launches.mark_tid)
    return dict(
        w0=w0, w1=w1, gaps=_gaps(events, w0, w1),
        graph_launches=[[float(e["ts"]), float(e["dur"])] for e in events
                        if e.get("cat") == "cuda_runtime"
                        and e.get("name", "").startswith("cudaGraphLaunch")
                        and w0 <= float(e["ts"]) <= w1])


def _raw(kept, trace):
    """The run's spans and requests beside the trace's parts, with the
    benchmark's clock mark."""
    run = kept["run"]
    return dict(
        trace, mark_us=run.ctx.launches.mark_us,
        t_open=run.t_open, t_mid=run.t_mid, t_close=run.t_close,
        spans=[[s.id, s.name, s.t0, s.t1, s.parent, s.tid, s.rid, s.attrs]
               for s in kept["spans"]],
        sent=[[r.due, r.sent, r.times[0] if r.times else None]
              for r in run.sent],
        readings=kept["readings"])


def _innermost(spans, points):
    """For each host time in `points` (ns, ascending), the innermost of the
    nested `spans` around it, or None: one sweep, the latest-begun span
    still open on top of a heap."""
    spans = sorted(spans, key=lambda s: s.t0)
    heap, i, out = [], 0, []
    for t in points:
        while i < len(spans) and spans[i].t0 <= t:
            heapq.heappush(heap, (-spans[i].t0, i))
            i += 1
        while heap and spans[heap[0][1]].t1 < t:
            heapq.heappop(heap)
        out.append(spans[heap[0][1]] if heap else None)
    return out


def _readings(raw, cell):
    """What the traced run says about the program's spans (see the module
    docstring); the clock check's misses under "launch_misses"."""
    w0, w1 = raw["w0"], raw["w1"]
    off = w0 - raw["mark_us"]           # trace us = host us + off
    spans = [SimpleNamespace(id=i, name=n, t0=a, t1=b, parent=p, tid=t,
                             rid=r, attrs=at)
             for i, n, a, b, p, t, r, at in raw["spans"]]
    sched_tid = next(s.tid for s in spans if s.name == "window")
    mine = [s for s in spans if s.tid == sched_tid and s.name != "request"]
    lw = sorted((s.t0 / 1e3 + off, s.t1 / 1e3 + off)
                for s in mine if s.name == "window.launch")
    starts = [a for a, _ in lw]
    misses = []
    for a, d in raw["graph_launches"]:
        j = bisect.bisect_right(starts, a + 50.0) - 1
        if j < 0 or not (lw[j][0] - 50.0 <= a and a + d <= lw[j][1] + 50.0):
            misses.append([a - w0, d])
    idle = collections.Counter()
    long_gaps = sorted((a, b) for a, b in raw["gaps"] if b - a >= 20.0)
    idle["gaps under 20 us"] = sum(b - a for a, b in raw["gaps"]
                                   if b - a < 20.0) * 1e-6
    under = _innermost(mine, [((a + b) / 2 - off) * 1e3
                              for a, b in long_gaps])
    for (a, b), s in zip(long_gaps, under):
        idle[s.name if s else "outside any span"] += (b - a) * 1e-6
    t_open, t_mid = raw["t_open"] * 1e9, raw["t_mid"] * 1e9
    top = sorted((max(s.t0, t_open), min(s.t1, t_mid)) for s in mine
                 if s.parent is None and s.name in TOP)
    covered, end = 0, t_open
    for a, b in top:
        if b > max(a, end):
            covered += b - max(a, end)
            end = b
    emits = [s for s in mine if s.name == "window.emit"
             and t_open <= s.t0 <= t_mid]
    reqs = [s for s in spans if s.name == "request"
            and s.attrs.get("first") is not None]
    subs = sorted(s.t0 for s in reqs)
    by_submit = {s.t0: s for s in reqs}
    split = []
    for due, sent, first in raw["sent"]:
        j = bisect.bisect_left(subs, int(sent * 1e9))
        if first is None or j == len(subs):
            continue
        s = by_submit[subs[j]]
        split.append(dict(
            ttft_ms=1e3 * (first - due), late_ms=1e3 * (sent - due),
            queue_ms=1e-6 * (s.attrs["dispatch"] - s.t0),
            admission_ms=1e-6 * (s.attrs["first"] - s.attrs["dispatch"])))
    p90 = np.percentile([x["ttft_ms"] for x in split], 90) if split else 0
    tail = [x for x in split if x["ttft_ms"] >= p90]
    return {
        "cell": cell, "trace_window_s": (w1 - w0) * 1e-6,
        "graph_launches": len(raw["graph_launches"]),
        "launch_misses": misses,
        "idle_by_span_s": dict(idle.most_common()),
        "top_level_cover": covered / max(1, t_mid - t_open),
        "builds_in_window": sum(s.name.endswith(".build") for s in spans
                                if raw["t_open"] * 1e9 <= s.t0
                                <= raw["t_close"] * 1e9),
        "emit_callback_share": (sum(s.attrs["callback_ns"] for s in emits)
                                / max(1, sum(s.t1 - s.t0 for s in emits))),
        "ttft_p90_requests": {k: float(np.mean([x[k] for x in tail]))
                              for k in tail[0]} if tail else {},
        "readings": raw["readings"],
    }


@pytest.mark.gpu
@pytest.mark.parametrize("name", [tiny.B, tiny.C])
def test_program_spans_share_the_device_trace_clock(cuda_device, monkeypatch,
                                                    name):
    kept, trace = {}, {}
    _keep_runner(monkeypatch, kept)

    class Keep(trace_mod.TraceData):
        def __init__(self, evs, launches):
            trace.update(_trace_parts(evs, launches))
            super().__init__(evs, launches)

    monkeypatch.setattr(trace_mod, "TraceData", Keep)
    seconds = spec.load_benchmark()["run_seconds"]
    t0 = time.time()
    out = harness.run_cell(name, 2 ** 31 + 4242, seconds, True,
                           log=lambda *a: print(*a, file=sys.stderr,
                                                flush=True))
    print(f"run_cell {time.time() - t0:.0f} s", file=sys.stderr, flush=True)
    raw = _raw(kept, trace)
    os.makedirs(spec.OUT, exist_ok=True)
    with open(os.path.join(spec.OUT, f"span_raw-{name}.json"), "w") as f:
        json.dump(raw, f)
    got = _readings(raw, name)
    with open(os.path.join(spec.OUT, f"span_idle-{name}.json"), "w") as f:
        json.dump(dict(got, metrics=out["metrics"], device=out["device"],
                       breakdown=out.get("breakdown")), f, indent=1)
    misses = len(got["launch_misses"])
    print(name, json.dumps({k: v for k, v in got.items()
                            if k != "launch_misses"}), "misses", misses,
          got["launch_misses"][:5])
    assert out["correct"] is True, out["checks"]
    assert set(SPAN_METRICS[name]) <= set(out["metrics"]), out["metrics"]
    assert got["graph_launches"] > 0
    assert misses == 0, got["launch_misses"][:5]
    assert got["builds_in_window"] == 0
    assert got["top_level_cover"] >= 0.95, got["top_level_cover"]
