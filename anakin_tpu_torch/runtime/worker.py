"""Worker: request-level execution over one `Net` from a thread pool, the
port of `anakin_tpu/runtime/worker.py`.

Re-design of the reference's thread-pool inference server
(`framework/core/net/worker.h:69-182`, `worker.cpp:56-212`): there, N host
threads each owned a full Net replica keyed by thread id.  Here ONE `Net`
serves every thread: its weights and prepared int8 copies are read-only
in a step, and the pool overlaps the host's feed preparation, launches and
copies.  The API is the reference's:

  sync_prediction(feed)   -> Future of host outputs   (worker.cpp:96)
  sync_prediction_device  -> Future of the net's tensors (on its device)
  async_prediction(feed)  + async_get_result(): FIFO order preserved
  register_aux_function   : per-request hooks

Each pool thread launches on its own current stream (the default stream
unless a caller sets another), and a request counts as done when that
stream has run its work: its outputs' copy to the host waits for it, and
`sync_prediction_device` synchronizes it, not the whole device.  A `Net` with `enable_op_timer` keeps each
thread's node in flight apart, so its summary counts every request's
nodes.  The kernels' launch counters are plain integers: counts taken
while several threads launch are not exact.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

import torch

from ..convert import to_numpy
from .net import Net

__all__ = ["Worker"]


class Worker:
    def __init__(self, net: Net, num_threads: int = 2) -> None:
        self.net = net
        self._pool = ThreadPoolExecutor(max_workers=num_threads,
                                        thread_name_prefix="anakin-worker")
        self._async_q: "queue.Queue[Future]" = queue.Queue()
        self._aux: List[Callable[[], None]] = []
        self._latencies_ms: List[float] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------ hooks
    def register_aux_function(self, fn: Callable[[], None]) -> None:
        """Per-request hook (reference `register_aux_function`)."""
        self._aux.append(fn)

    # ------------------------------------------------------------- sync
    def _run(self, feed: Dict[str, Any], to_host: bool) -> Dict[str, Any]:
        t0 = time.perf_counter()
        for fn in self._aux:
            fn()
        out = self.net.prediction(feed)
        if to_host:  # the copy to the host waits for this thread's stream
            out = {k: to_numpy(v) for k, v in out.items()}
        elif self.net.device.type == "cuda":
            torch.cuda.current_stream(self.net.device).synchronize()
        with self._lock:
            self._latencies_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def sync_prediction(self, feed: Dict[str, Any]) -> Future:
        """Returns a Future of HOST arrays (the device-to-host copy
        included; bf16 outputs as ml_dtypes' bfloat16)."""
        return self._pool.submit(self._run, feed, True)

    def sync_prediction_device(self, feed: Dict[str, Any]) -> Future:
        """Returns a Future of the net's tensors, on its device."""
        return self._pool.submit(self._run, feed, False)

    # ------------------------------------------------------------ async
    def async_prediction(self, feed: Dict[str, Any]) -> None:
        """Enqueue; results come back in submission order via
        async_get_result (reference FIFO queue semantics)."""
        self._async_q.put(self._pool.submit(self._run, feed, True))

    def async_get_result(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        fut = self._async_q.get(timeout=timeout)
        return fut.result(timeout=timeout)

    # ---------------------------------------------------------- metrics
    def prediction_times_ms(self) -> List[float]:
        """Per-request latencies (reference
        `_thead_id_to_prediction_times_vec_in_ms`, worker.h:162)."""
        with self._lock:
            return list(self._latencies_ms)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True)
