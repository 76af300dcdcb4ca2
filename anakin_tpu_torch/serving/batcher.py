"""Continuous request batcher, the port of `anakin_tpu/serving/batcher.py`.

The serving-side evolution of the reference's Worker queue (SURVEY.md
section 2.10: "Worker thread-pool over Net replicas -> continuous-batching
request scheduler"): single-sample requests are coalesced into batches of
a few fixed sizes within a latency window, run through one `Net` per size,
and each request's slice comes back through its future, on the host (bf16
outputs as ml_dtypes' bfloat16).

Three differences from the JAX batcher, each a fault of the reference
that is not copied:

  * a net factory or a forward that raises fails only that batch's
    futures, with the error, and the dispatcher goes on to the next batch
    (the JAX `_loop` builds the bucket's net outside its `try`, so a
    raising factory ends its dispatcher thread and every queued future
    waits forever);
  * once a batch's window has passed, the requests already queued still
    join it, up to the largest bucket (the JAX `_take_batch` stops at the
    window's end, so a backlog older than the window is served one request
    a batch);
  * a batch's size is recorded before any of its futures is resolved, for
    a batch that fails as for one that succeeds (the JAX `_loop` appends it
    after `_run` has set the results, so a caller that waits on every
    future and then reads `batch_sizes_served()` can miss the last batch).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

from ..convert import to_numpy
from ..runtime.net import Net

__all__ = ["ContinuousBatcher"]


@dataclass
class _Request:
    feed: Dict[str, np.ndarray]  # sample WITHOUT batch dim
    future: Future = field(default_factory=Future)
    enqueued_at: float = field(default_factory=time.perf_counter)


class ContinuousBatcher:
    """Collects single-sample requests into padded batches.

    net_factory(batch) must return a Net for that batch size; `buckets` are
    the allowed batch sizes.  A dispatcher thread drains the queue: it
    waits until `max_delay_ms` after a batch's first request for a fuller
    bucket, takes what is queued, pads the batch up to the smallest bucket
    that holds it with zeros, runs, and splits.
    """

    def __init__(
        self,
        net_factory,
        input_names: Sequence[str],
        buckets: Sequence[int] = (1, 2, 4, 8),
        max_delay_ms: float = 2.0,
    ) -> None:
        self.buckets = sorted(buckets)
        self.input_names = list(input_names)
        self._nets: Dict[int, Net] = {}
        self._net_factory = net_factory
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self.max_delay_ms = max_delay_ms
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._batch_sizes_served: List[int] = []
        self._sizes_lock = threading.Lock()
        self._thread.start()

    def _net(self, bucket: int) -> Net:
        if bucket not in self._nets:
            self._nets[bucket] = self._net_factory(bucket)
        return self._nets[bucket]

    # ------------------------------------------------------------- client
    def submit(self, feed: Dict[str, np.ndarray]) -> Future:
        req = _Request({k: np.asarray(v) for k, v in feed.items()})
        self._q.put(req)
        return req.future

    # ---------------------------------------------------------- dispatcher
    def _take_batch(self) -> List[_Request]:
        first = self._q.get()
        if first is None:  # poison pill
            return []
        batch = [first]
        deadline = first.enqueued_at + self.max_delay_ms / 1e3
        max_bucket = self.buckets[-1]
        while len(batch) < max_bucket:
            rest = deadline - time.perf_counter()
            try:  # past the window, only what is queued already
                nxt = (self._q.get(timeout=rest) if rest > 0
                       else self._q.get_nowait())
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)
                break
            batch.append(nxt)
        return batch

    def _run(self, batch: List[_Request]) -> List[Dict[str, np.ndarray]]:
        """Each request's outputs, in batch order."""
        n = len(batch)
        bucket = next(b for b in self.buckets if b >= n)
        feed = {}
        for name in self.input_names:
            stacked = np.stack([r.feed[name] for r in batch])
            if bucket > n:
                pad = [(0, bucket - n)] + [(0, 0)] * (stacked.ndim - 1)
                stacked = np.pad(stacked, pad)
            feed[name] = stacked
        out = self._net(bucket).prediction(feed)
        host = {k: to_numpy(v) for k, v in out.items()}
        return [{k: v[i] for k, v in host.items()} for i in range(n)]

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._take_batch()
            if not batch:
                return
            try:
                results, exc = self._run(batch), None
            except Exception as e:  # the batch fails; the next is served
                results, exc = None, e
            with self._sizes_lock:  # recorded before any future resolves
                self._batch_sizes_served.append(len(batch))
            for i, r in enumerate(batch):
                if r.future.cancelled():
                    continue
                if exc is None:
                    r.future.set_result(results[i])
                else:
                    r.future.set_exception(exc)

    # ----------------------------------------------------------- lifecycle
    def batch_sizes_served(self) -> List[int]:
        with self._sizes_lock:
            return list(self._batch_sizes_served)

    def shutdown(self, timeout: float = 5.0) -> None:
        """Stop the dispatcher; wait for it at most `timeout` seconds."""
        self._stop.set()
        self._q.put(None)
        self._thread.join(timeout=timeout)
