"""The port's tracing: `runtime.profiler.SpanRecorder`, the spans the
`DecodeScheduler` records on the host clock, and `profiler.trace`'s export
of them beside the profiler's own events.

The scheduler runs on the CPU (`EagerStep`) at a tiny size, on a fixed
script of five requests held until all are queued (so the batches are the
same on every run), through each of its paths: bucket admissions with
fused windows or the per-step decode, chunk steps with fused windows, and
the per-step decode teacher-forcing the prompt (chunk 1)."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from anakin_tpu_torch.models.transformer import (TransformerConfig,
                                                 make_transformer_params)
from anakin_tpu_torch.runtime import DecodeScheduler
from anakin_tpu_torch.runtime.generate import prefill_bucket
from anakin_tpu_torch.runtime.profiler import SpanRecorder, trace

CFG = dict(vocab=40, embed=32, heads=2, kv_heads=1, layers=1, max_seq=64)
# (prompt length, new tokens): buckets 32 and 64, slots refilled
SCRIPT = [(3, 9), (5, 3), (2, 13), (30, 4), (40, 3)]
PATHS = {
    "bucket_window": dict(prefill_mode="bucket", fuse_window=4),
    "bucket_step": dict(prefill_mode="bucket", fuse_window=0),
    "chunk_window": dict(prefill_mode="chunked", prefill_chunk=4,
                         fuse_window=4),
    "chunk1_step": dict(prefill_mode="chunked", prefill_chunk=1,
                        fuse_window=0),
}
# the public counters on SCRIPT at b2, as the scheduler counted them
# before it recorded spans
COUNTERS = {
    "bucket_window": (20, 4, 4, 4, 32),
    "bucket_step": (18, 4, 0, 4, 32),
    "chunk_window": (31, 21, 3, 0, 32),
    "chunk1_step": (63, 0, 0, 0, 32),
}
TOP = {"window", "admission", "step", "chunk", "admit", "idle"}


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, CFG["vocab"], p).astype(np.int32)
            for p, _ in SCRIPT]


@pytest.fixture(scope="module")
def params():
    return make_transformer_params(TransformerConfig(**CFG), 5)


def _serve(params, **kw):
    """The scheduler after SCRIPT, its results and its span snapshot."""
    sched = DecodeScheduler(TransformerConfig(**CFG), batch=2, params=params,
                            device="cpu", **kw)
    go, admit = threading.Event(), sched._admit

    def gated():
        go.wait(timeout=60)
        admit()

    sched._admit = gated
    try:
        futs = [sched.submit(p, n) for p, (_, n) in zip(_prompts(), SCRIPT)]
        go.set()
        results = [f.result(timeout=120) for f in futs]
    finally:
        sched.close()
    assert not sched._thread.is_alive()
    return sched, results, sched.spans.snapshot()


@pytest.fixture(scope="module", params=sorted(PATHS))
def served(request, params):
    return (request.param,) + _serve(params, **PATHS[request.param])


def _children(spans):
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    return kids


def test_children_lie_inside_their_parent_on_one_thread(served):
    _, sched, _, spans = served
    by_id = {s.id: s for s in spans}
    assert sched.spans.dropped == 0
    for s in spans:
        assert s.t0 <= s.t1
        if s.parent is None:
            assert s.name in TOP | {"request"}, s
            continue
        p = by_id[s.parent]
        assert s.tid == p.tid
        assert p.t0 <= s.t0 <= s.t1 <= p.t1
        assert s.name.startswith(p.name + "."), (s, p)
    # the scheduler thread's top-level spans follow one another
    top = sorted((s for s in spans if s.name in TOP), key=lambda s: s.t0)
    assert len({s.tid for s in top}) == 1
    for a, b in zip(top, top[1:]):
        assert a.t1 <= b.t0, (a, b)


def test_requests_record_submit_dispatch_first_token_and_finish(served):
    _, _, results, spans = served
    reqs = sorted((s for s in spans if s.name == "request"),
                  key=lambda s: s.rid)
    assert [s.rid for s in reqs] == list(range(len(SCRIPT)))
    for s, (P, n), out in zip(reqs, SCRIPT, results):
        a = s.attrs
        assert (a["prompt"], a["tokens"], a["reason"]) == (P, n, "length")
        assert len(out) == P + n
        assert s.t0 <= a["dispatch"] <= a["first"] <= s.t1


def test_phase_seconds_read_the_spans_and_counters_hold(served):
    name, sched, _, spans = served
    kids = _children(spans)

    def upto_emit(s):
        (em,) = [c for c in kids.get(s.id, []) if c.name.endswith(".emit")]
        return (em.t0 - s.t0) * 1e-9

    want = {"window": sum(upto_emit(s) for s in spans if s.name == "window"),
            "prefill": sum(upto_emit(s) for s in spans
                           if s.name == "admission")
            + sum(s.seconds for s in spans if s.name == "chunk"),
            "step": sum(s.seconds for s in spans if s.name == "step")}
    assert sched.phase_seconds == pytest.approx(want, rel=1e-9, abs=1e-12)
    assert (sched.steps_run, sched.prefill_steps_run,
            sched.fused_windows_run, sched.bucket_prefills_run,
            sched.tokens_served) == COUNTERS[name]
    count = {k: sum(s.name == k for s in spans)
             for k in ("window", "admission")}
    assert count == {"window": sched.fused_windows_run,
                     "admission": sched.bucket_prefills_run}


def test_admission_rows_count_the_padding(served):
    name, sched, _, spans = served
    adms = [s for s in spans if s.name == "admission"]
    assert bool(adms) == name.startswith("bucket")
    reqs = [s for s in spans if s.name == "request"]
    for s in adms:
        mine = [r.attrs["prompt"] for r in reqs
                if r.attrs["dispatch"] == s.t0]
        a = s.attrs
        assert a["slots"] == len(mine) > 0
        assert all(prefill_bucket(P, CFG["max_seq"]) == a["L"] for P in mine)
        assert a["rows_launched"] == sched.B * a["L"]
        assert a["rows_launched"] - a["rows_real"] == \
            sched.B * a["L"] - sum(mine)


def test_fused_window_records_launch_readback_and_emit(served):
    name, sched, _, spans = served
    kids = _children(spans)
    wins = [s for s in spans if s.name == "window"]
    assert bool(wins) == name.endswith("window")
    for i, w in enumerate(sorted(wins, key=lambda s: s.t0)):
        got = [c.name for c in sorted(kids[w.id], key=lambda c: c.t0)]
        assert got == (["window.build"] if i == 0 else []) + [
            "window.launch", "window.readback", "window.emit"]
        (launch,) = [c for c in kids[w.id] if c.name == "window.launch"]
        assert [c.name for c in sorted(kids[launch.id],
                                       key=lambda c: c.t0)] == [
            "window.launch.fill", "window.launch.replay"]
        assert w.attrs["K"] == sched.fuse_window
        assert 1 <= w.attrs["k_done"] <= w.attrs["K"]
        assert 1 <= w.attrs["active"] <= sched.B
    emits = [c for c in spans if c.name == "window.emit"]
    assert all(c.attrs["callback_ns"] >= 0 for c in emits)


@pytest.mark.parametrize("kw", [PATHS["bucket_window"],
                                PATHS["chunk_window"]],
                         ids=["bucket", "chunked"])
def test_second_request_at_a_built_bucket_builds_nothing(params, kw):
    sched = DecodeScheduler(TransformerConfig(**CFG), batch=2, params=params,
                            device="cpu", **kw)
    try:
        p1, p2 = _prompts()[:2]
        sched.submit(p1, 6).result(timeout=120)
        mark = max(s.t1 for s in sched.spans.snapshot())
        built = dict(sched.builds)
        sched.submit(p2, 6).result(timeout=120)
    finally:
        sched.close()
    later = [s for s in sched.spans.snapshot() if s.t0 > mark]
    assert any(s.name == "request" for s in later)
    assert not [s for s in later if s.name.endswith(".build")]
    assert sched.builds == built
    assert built["window"] == 1 and built["bucket" if kw["prefill_mode"]
                                          == "bucket" else "chunk"] == 1


def test_on_token_time_is_counted_as_callback_time(params):
    sched = DecodeScheduler(TransformerConfig(**CFG), batch=2, params=params,
                            device="cpu", fuse_window=4)
    try:
        sched.submit(_prompts()[0], 9,
                     on_token=lambda t: time.sleep(0.002)).result(timeout=120)
    finally:
        sched.close()
    spans = sched.spans.snapshot()
    cb = sum(s.attrs["callback_ns"] for s in spans if s.name.endswith(".emit"))
    assert cb >= 9 * 2_000_000
    for s in spans:
        if s.name.endswith(".emit"):
            assert s.attrs["callback_ns"] <= s.t1 - s.t0


@pytest.mark.parametrize("capacity,n", [(1, 5), (8, 8), (8, 20)])
def test_ring_is_bounded_and_counts_what_it_drops(capacity, n):
    rec = SpanRecorder(capacity)
    for i in range(n):
        with rec.span("s", rid=i):
            pass
    snap = rec.snapshot()
    assert len(snap) == min(n, capacity)
    assert rec.dropped == max(0, n - capacity)
    assert [s.rid for s in snap] == list(range(n - len(snap), n))


def test_ring_keeps_each_threads_nesting_under_contention():
    threads, per = 16, 300
    rec = SpanRecorder(threads * per * 2 - 100)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for i in range(per):
                with rec.span("outer", rid=i):
                    with rec.span("inner"):
                        pass

        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    snap = rec.snapshot()
    assert len(snap) + rec.dropped == threads * per * 2
    assert rec.dropped == 100
    assert len({s.id for s in snap}) == len(snap)
    by_id = {s.id: s for s in snap}
    for s in snap:
        if s.name == "inner" and s.parent in by_id:
            p = by_id[s.parent]
            assert p.name == "outer" and p.tid == s.tid
            assert p.t0 <= s.t0 <= s.t1 <= p.t1


def test_trace_writes_the_spans_on_the_profilers_timeline(tmp_path):
    rec = SpanRecorder()
    with rec.span("before"):
        pass
    with trace(str(tmp_path), spans=rec):
        for i in range(3):
            with rec.span(f"probe{i}", rid=i, n=2):
                with torch.profiler.record_function(f"probe_rf{i}"):
                    time.sleep(0.002)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    mine = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert sorted(mine) == ["probe0", "probe1", "probe2"]
    rf = {e["name"]: e for e in events if e.get("ph") == "X"
          and e.get("name", "").startswith("probe_rf")}
    starts = []
    for i in range(3):
        s, r = mine[f"probe{i}"], rf[f"probe_rf{i}"]
        assert s["args"]["rid"] == i and s["args"]["n"] == 2
        # the span holds the block's event, within 100 us either side
        assert r["ts"] >= s["ts"] - 100
        assert r["ts"] + r["dur"] <= s["ts"] + s["dur"] + 100
        starts.append(abs(r["ts"] - s["ts"]))
    assert min(starts) < 100, starts
