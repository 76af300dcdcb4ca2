"""The general traffic generators.  A traffic mix is a JSON file of
parameters (`traffic/<mix>.json`) that names one of them in `"generator"`:

  * "offline": back-to-back batches of `batch` items from a ring of `ring`
    batches held on the device (the builder steps its model on them);
  * "closed_loop": `clients` clients, each sending its next request when
    its last one finishes;
  * "open_loop": requests due at `rate_per_s` (Poisson arrivals, or with
    `burst_cv` gamma-distributed gaps of that coefficient of variation,
    bursty above 1), sent when due whatever is in flight.

The request generators are found by name in `GENERATORS` and started by
`start`; a runner drives any of them the same way.

A request mix draws its sizes (`prompt`, `new_tokens`; each a
distribution: {"dist": "lognormal", "median", "sigma", "min", "max"} or
{"dist": "uniform", "min", "max"}) and its arrivals from the fixed
`sizes_seed`, so every run seed serves the same sizes at the same
arrivals in the same order (the order moves an open loop's tails more
than the seed's other work does); the run seed draws the prompts' tokens
(`plan_requests`).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from .inputs import seed_rng

__all__ = ["Request", "plan_requests", "draw", "GENERATORS", "start",
           "ClosedLoop", "OpenLoop"]


def draw(spec: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    """`n` whole numbers from a size distribution."""
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "uniform":
        return rng.integers(lo, hi + 1, n)
    if spec["dist"] == "lognormal":
        x = float(spec["median"]) * np.exp(float(spec["sigma"])
                                           * rng.standard_normal(n))
        return np.clip(np.round(x), lo, hi).astype(np.int64)
    raise ValueError(f"unknown distribution {spec['dist']!r}")


@dataclass
class Request:
    """One request and what happened to it (host-clock seconds)."""
    idx: int
    prompt: np.ndarray
    max_new: int
    due: float = 0.0           # open loop: when it was due to be sent
    sent: float = 0.0
    times: List[float] = field(default_factory=list)  # each token's arrival
    streamed: List[int] = field(default_factory=list)  # each token, as sent
    future: object = None
    tokens: Optional[np.ndarray] = None  # the served tokens
    error: Optional[BaseException] = None
    at_open: bool = False      # sent when the window opened


def plan_requests(traffic: dict, seed: int, vocab: int) -> List[Request]:
    """The mix's pool of requests, with arrival offsets (`due`, seconds
    from the window's start) for an open loop.  Every seed serves the same
    work in the same order: the sizes and the arrivals come from
    `sizes_seed` (in a closed loop request i is client i % clients's (i //
    clients)-th); the run seed draws the prompts' tokens."""
    n = int(traffic["pool"])
    base = np.random.default_rng(int(traffic["sizes_seed"]))
    P = draw(traffic["prompt"], base, n)
    T = draw(traffic["new_tokens"], base, n)
    if "rate_per_s" in traffic:
        mean = 1.0 / float(traffic["rate_per_s"])
        if "burst_cv" in traffic:
            shape = float(traffic["burst_cv"]) ** -2
            gaps = base.gamma(shape, mean / shape, n)
        else:
            gaps = base.exponential(mean, n)
        due = np.cumsum(gaps) - gaps[0]
    else:
        due = np.zeros(n)
    rng = seed_rng(seed, 3)
    return [Request(i, rng.integers(0, vocab, int(P[i])).astype(np.int32),
                    int(T[i]), due=float(due[i])) for i in range(n)]


def _track(req: Request, submit: Callable, on_done: Callable = None) -> None:
    """Send `req` through `submit(prompt, max_new, on_token) -> future`,
    stamping each token's arrival."""
    times, streamed = req.times, req.streamed

    def on_token(tok):
        times.append(time.perf_counter())
        streamed.append(int(tok))

    req.sent = time.perf_counter()
    req.future = submit(req.prompt, req.max_new, on_token)
    if on_done is not None:
        req.future.add_done_callback(lambda f: on_done(req))


class ClosedLoop:
    """Client c sends pool[c] when the window opens, then, each time one of
    its requests is done and the window is still open, its next one
    (pool[c + clients], ...).  A request is due when its client sends it.
    `sent` grows as clients send.  Requests still in flight at the close
    are cancelled: the window owes them nothing (`owes_all` False)."""

    owes_all = False

    def __init__(self, submit: Callable, pool: List[Request], traffic: dict,
                 t_open: float, t_stop: float):
        self.sent: List[Request] = []
        self.lateness: List[float] = []
        self._lock = threading.Lock()
        self._args = (submit, pool, int(traffic["clients"]), t_stop)
        for c in range(min(self._args[2], len(pool))):
            self._send(c, at_open=True)

    def _send(self, i: int, at_open: bool = False) -> None:
        submit, pool, clients, t_stop = self._args
        if i >= len(pool) or time.perf_counter() >= t_stop:
            return
        req = pool[i]
        req.at_open = at_open
        req.due = time.perf_counter()
        with self._lock:
            self.sent.append(req)
        _track(req, submit, lambda r, i=i: self._send(i + clients))

    def settle(self, deadline: float) -> None:
        for r in list(self.sent):
            r.future.cancel()


class OpenLoop:
    """Sends pool[i] at t_open + pool[i].due from a thread of its own until
    t_stop.  `lateness` holds each request's send time minus its due time
    (how late the generator ran).  Every request sent has to come back
    (`owes_all`): `settle` waits for each until the deadline."""

    owes_all = True

    def __init__(self, submit: Callable, pool: List[Request], traffic: dict,
                 t_open: float, t_stop: float):
        self.sent: List[Request] = []
        self.lateness: List[float] = []
        for r in pool:
            r.due += t_open
        if pool:
            pool[0].at_open = True
        self._args = (submit, pool, t_stop)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        submit, pool, t_stop = self._args
        for req in pool:
            if req.due >= t_stop:
                break
            wait = req.due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            _track(req, submit)
            self.lateness.append(req.sent - req.due)
            self.sent.append(req)

    def join(self, timeout: float = None) -> None:
        self._thread.join(timeout)

    def settle(self, deadline: float) -> None:
        self.join()
        for r in self.sent:
            try:
                r.future.result(timeout=max(0.0, deadline
                                            - time.perf_counter()))
            except Exception:   # judged by the runner: it never came
                pass


GENERATORS = {"closed_loop": ClosedLoop, "open_loop": OpenLoop}


def start(traffic: dict, submit: Callable, pool: List[Request],
          t_open: float, t_stop: float):
    """Start the mix's generator (`traffic["generator"]`) on `pool`: it
    sends through `submit(prompt, max_new, on_token) -> future` from
    t_open until t_stop.  The object it returns has `sent`, `lateness`,
    `owes_all` and `settle(deadline)`, called once the window has closed."""
    return GENERATORS[traffic["generator"]](submit, pool, traffic, t_open,
                                            t_stop)
