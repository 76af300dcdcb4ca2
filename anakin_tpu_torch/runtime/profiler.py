"""Profiling utilities: the port of `anakin_tpu/runtime/profiler.py`.

  * `SpanRecorder`: the program's own spans on the host clock
    (`time.perf_counter_ns`, the clock the benchmark places its units in
    the device trace by), kept in a bounded ring; `DecodeScheduler.spans`
    is one.
  * `trace(log_dir, spans=...)` records a `torch.profiler` trace of the
    block (host ops and, on a GPU, the kernels) and writes it as a Chrome
    trace (`trace.json`, viewable in Perfetto or chrome://tracing), with
    the spans the given recorders took during the block on its timeline.
  * `flops_estimate(graph)` gives the JAX package's analytic per-node
    FLOP/byte table, from `infer_shapes` on the meta device.
  * `roofline_report` sets a measured step time against those bounds.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import math
import os
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional, Union

import torch

from ..graph.ir import Graph, topological_order
from ..graph.shape_infer import infer_shapes

__all__ = ["Span", "SpanRecorder", "trace", "flops_estimate",
           "roofline_report", "H100_PEAK_INT8_OPS", "H100_HBM_BYTES_PER_S"]

# NVIDIA H100 SXM data sheet: dense int8 tensor-core rate and HBM3 bandwidth
H100_PEAK_INT8_OPS = 1979e12
H100_HBM_BYTES_PER_S = 3.35e12


class Span:
    """One recorded span: `name`, `t0` and `t1` in `time.perf_counter_ns()`,
    `id`, the enclosing span's id `parent` (None at the top level), the
    native id `tid` of the thread it ran on, a request id `rid` where it
    has one, and a few `attrs` (integers, or a short string)."""

    __slots__ = ("id", "name", "t0", "t1", "parent", "tid", "rid", "attrs")

    def __init__(self, id, name, t0, t1, parent, tid, rid, attrs):
        self.id, self.name, self.t0, self.t1 = id, name, t0, t1
        self.parent, self.tid, self.rid, self.attrs = parent, tid, rid, attrs

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"{(self.t1 - self.t0) / 1e3:.1f} us, rid={self.rid}, "
                f"{self.attrs})")


class SpanRecorder:
    """Spans in a bounded in-memory ring: the newest `capacity` records,
    with `dropped` counting the older ones pushed out.

    `with rec.span(name, rid=None, **attrs) as s:` times its block and
    records it when the block ends (also when it raises), as a child of the
    span open around it on the same thread; `s.attrs` may be filled in the
    block.  `rec.add(name, t0, t1, ...)` records an interval the caller
    timed itself, at the top level.  `snapshot()` copies the ring under
    its lock; a span is in it once it has ended, children before their
    parent."""

    CAPACITY = 1 << 16

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = int(capacity)
        self.dropped = 0
        self._ring: "collections.deque[Span]" = collections.deque(
            maxlen=self.capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
            self._local.tid = threading.get_native_id()
        return st

    def _push(self, s: Span) -> None:
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(s)

    @contextlib.contextmanager
    def span(self, name: str, rid: Optional[int] = None,
             **attrs) -> Iterator[Span]:
        st = self._stack()
        s = Span(next(self._ids), name, 0, 0, st[-1].id if st else None,
                 self._local.tid, rid, attrs)
        st.append(s)
        s.t0 = time.perf_counter_ns()
        try:
            yield s
        finally:
            s.t1 = time.perf_counter_ns()
            st.pop()
            self._push(s)

    def child(self, suffix: str, **attrs):
        """`span` named after the span open on this thread:
        "<its name>.<suffix>" (`suffix` alone at the top level)."""
        st = self._stack()
        return self.span(f"{st[-1].name}.{suffix}" if st else suffix,
                         **attrs)

    def add(self, name: str, t0: int, t1: int, rid: Optional[int] = None,
            **attrs) -> Span:
        """Record [t0, t1] (perf_counter_ns) as a top-level span of the
        calling thread."""
        self._stack()
        s = Span(next(self._ids), name, t0, t1, None, self._local.tid, rid,
                 attrs)
        self._push(s)
        return s

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self._ring)


# the marker `trace` records on the calling thread to place the program's
# spans on the profiler's timeline
_ANCHOR = "anakin_tpu_torch.span_anchor"


@contextlib.contextmanager
def trace(log_dir: str, spans: Union[SpanRecorder, Iterable[SpanRecorder]] = ()
          ) -> Iterator[torch.profiler.profile]:
    """Profile the block; the trace goes to `log_dir/trace.json`.  The spans
    that `spans` (a recorder or several, e.g. a scheduler's `.spans`) took
    during the block are written into it as events of category
    "program_span" beside the profiler's own, on its timeline: a marker
    recorded on this thread at the block's start gives the offset from the
    host clock to the trace's."""
    from torch.profiler import ProfilerActivity, profile, record_function

    recorders = [spans] if isinstance(spans, SpanRecorder) else list(spans)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        for _ in range(2):  # the first record_function is 0.1-1 ms late
            t_anchor = time.perf_counter_ns()
            with record_function(_ANCHOR):
                pass
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    if recorders:
        _write_spans(path, [s for r in recorders for s in r.snapshot()
                            if s.t1 >= t_anchor], t_anchor)


def _write_spans(path: str, spans: List[Span], t_anchor: int) -> None:
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    anchor = max((e for e in events
                  if e.get("name") == _ANCHOR and e.get("ph") == "X"),
                 key=lambda e: float(e["ts"]))
    offset_us = float(anchor["ts"]) - t_anchor / 1e3
    for s in spans:
        args = dict(s.attrs, id=s.id)
        if s.parent is not None:
            args["parent"] = s.parent
        if s.rid is not None:
            args["rid"] = s.rid
        events.append({"ph": "X", "cat": "program_span", "name": s.name,
                       "pid": anchor["pid"], "tid": s.tid,
                       "ts": s.t0 / 1e3 + offset_us,
                       "dur": (s.t1 - s.t0) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)


def _conv_flops(node, shapes) -> int:
    if node.op not in ("conv2d", "conv2d_int8", "dense", "dense_int8",
                       "matmul", "deconv2d"):
        return 0
    out = shapes[node.outputs[0]].shape
    w = shapes[node.inputs[1]].shape
    if node.op == "deconv2d":
        inp = shapes[node.inputs[0]].shape
        return 2 * math.prod(inp) * w[0] * w[1] * w[3]
    if node.op in ("conv2d", "conv2d_int8"):
        kh, kw, cin_g, cout = w
        return 2 * math.prod(out) * kh * kw * cin_g
    if node.op in ("dense", "dense_int8"):
        return 2 * math.prod(out) * w[0]
    if node.op == "matmul":
        a = shapes[node.inputs[0]].shape
        return 2 * math.prod(out) * a[-1]
    return 0


def flops_estimate(graph: Graph) -> Dict[str, Dict[str, float]]:
    """{node: {op, flops, bytes}} analytic cost table."""
    shapes = infer_shapes(graph)
    table: Dict[str, Dict[str, float]] = {}
    for node in topological_order(graph):
        byts = 0
        for e in list(node.inputs) + list(node.outputs):
            s = shapes[e]
            byts += math.prod(s.shape) * s.dtype.itemsize
        table[node.name] = {
            "op": node.op,
            "flops": float(_conv_flops(node, shapes)),
            "bytes": float(byts),
        }
    return table


def roofline_report(graph: Graph, step_seconds: float,
                    peak_flops: float = H100_PEAK_INT8_OPS,
                    hbm_bw: float = H100_HBM_BYTES_PER_S) -> str:
    """Summarize a measured step time against analytic compute/memory
    bounds.  Defaults are the H100 SXM's published peaks: 1,979 TOP/s int8
    (989 TFLOP/s bf16) and 3.35 TB/s HBM3."""
    table = flops_estimate(graph)
    flops = sum(v["flops"] for v in table.values())
    byts = sum(v["bytes"] for v in table.values())
    t_compute = flops / peak_flops
    t_memory = byts / hbm_bw
    bound = "compute" if t_compute > t_memory else "memory"
    util = (max(t_compute, t_memory) / step_seconds) if step_seconds else 0.0
    return (
        f"model: {flops/1e9:.1f} GFLOP, {byts/1e6:.1f} MB moved (analytic)\n"
        f"roofline: compute {t_compute*1e3:.3f} ms vs memory {t_memory*1e3:.3f} ms "
        f"-> {bound}-bound\n"
        f"measured: {step_seconds*1e3:.3f} ms -> {util*100:.1f}% of roofline"
    )
