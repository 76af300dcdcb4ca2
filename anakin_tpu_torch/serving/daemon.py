"""Serving daemon: supervises model-server processes, the port of
`anakin_tpu/serving/daemon.py`.

Parity with the reference's service daemon
(`framework/service/service_daemon.cpp:15-60`): the reference daemonizes
and forks one server process per device, restarting dead children.  Here
the daemon supervises one `python -m anakin_tpu_torch.serving.server`
process per (model, port) spec, restarts a crashed child after a backoff
of 2^n seconds (at most 30) up to `max_restarts` times, and exposes
liveness.  `stop` during a backoff spawns nothing more.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["ServerSpec", "ServingDaemon", "TERM_WAIT_S"]

# how long `stop` waits for a terminated child before it kills it
TERM_WAIT_S = 10.0

# the directory that holds the package, so that a child started from any
# working directory imports this copy of it
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclass
class ServerSpec:
    model_dir: str
    name: str = "model"
    port: int = 50051
    precision: str = "bf16"
    extra_args: List[str] = field(default_factory=list)


class ServingDaemon:
    def __init__(self, specs: List[ServerSpec], max_restarts: int = 5):
        self.specs = specs
        self.max_restarts = max_restarts
        self._procs: Dict[int, subprocess.Popen] = {}
        self._restarts: Dict[int, int] = {}
        self._stop = threading.Event()
        self._lock = threading.Lock()  # spawning against stopping
        self._thread: Optional[threading.Thread] = None

    def _spawn(self, idx: int) -> subprocess.Popen:
        spec = self.specs[idx]
        cmd = [sys.executable, "-m", "anakin_tpu_torch.serving.server",
               "--model-dir", spec.model_dir, "--name", spec.name,
               "--port", str(spec.port), "--precision", spec.precision,
               *spec.extra_args]
        path = os.environ.get("PYTHONPATH")
        env = dict(os.environ, PYTHONPATH=_PACKAGE_ROOT + (
            os.pathsep + path if path else ""))
        return subprocess.Popen(cmd, cwd=os.getcwd(), env=env)

    def start(self) -> "ServingDaemon":
        for i in range(len(self.specs)):
            self._procs[i] = self._spawn(i)
            self._restarts[i] = 0
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()
        return self

    def _watch(self) -> None:
        while not self._stop.wait(1.0):
            for i, proc in list(self._procs.items()):
                if proc.poll() is None:
                    continue
                if self._restarts[i] >= self.max_restarts:
                    continue
                self._restarts[i] += 1
                if self._stop.wait(min(2 ** self._restarts[i], 30)):
                    return
                with self._lock:
                    if self._stop.is_set():
                        return
                    self._procs[i] = self._spawn(i)

    def alive(self) -> Dict[int, bool]:
        return {i: p.poll() is None for i, p in self._procs.items()}

    def restarts(self) -> Dict[int, int]:
        return dict(self._restarts)

    def stop(self) -> None:
        with self._lock:
            self._stop.set()
        for p in self._procs.values():
            if p.poll() is None:
                p.terminate()
        for p in self._procs.values():
            try:
                p.wait(timeout=TERM_WAIT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if self._thread:
            self._thread.join(timeout=2)
