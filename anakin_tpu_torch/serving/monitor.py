"""Device monitor: background sampling of device health, the port of
`anakin_tpu/serving/monitor.py`.

Parity with the reference's service Monitor
(`framework/service/monitor.h:25-78`, `device_info.h:99-180`): a background
thread polls the device's name and memory every N seconds, and the latest
snapshot is attached to every RPC response (`service.proto` DeviceStatus).
On CUDA the counts are the caching allocator's: `memory_allocated` is
`bytes_in_use`, `max_memory_allocated` is `peak_bytes_in_use`, and the
card's total memory, read once when the monitor is made, is `bytes_limit`.
Reading them is a host-side read of the allocator's counters, with no CUDA
call, so a poll is safe while another thread captures a CUDA graph.  On
the CPU the byte counts are -1, as the JAX package's CPU gives.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch

__all__ = ["DeviceMonitor", "DeviceStatus"]


@dataclass
class DeviceStatus:
    device: str = "unknown"
    platform: str = "unknown"
    bytes_in_use: int = -1
    bytes_limit: int = -1
    peak_bytes_in_use: int = -1
    sampled_at: float = 0.0

    def to_dict(self) -> Dict:
        return self.__dict__.copy()


class DeviceMonitor:
    """`device=None` means CUDA, and raises where there is none; the CPU is
    sampled only when asked for (`device="cpu"`)."""

    def __init__(self, interval_s: float = 5.0, device=None):
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("DeviceMonitor samples CUDA by default and "
                                   "no CUDA device is present; pass "
                                   "device='cpu' to sample the CPU")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            self._name = torch.cuda.get_device_name(dev)
            self._limit = int(torch.cuda.get_device_properties(dev).total_memory)
        else:
            self._name, self._limit = str(dev), -1
        self.device = dev
        self.interval_s = interval_s
        self._status = self._sample()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _sample(self) -> DeviceStatus:
        st = DeviceStatus(device=self._name, sampled_at=time.time(),
                          platform="gpu" if self.device.type == "cuda"
                          else self.device.type)
        if self.device.type == "cuda":
            st.bytes_in_use = int(torch.cuda.memory_allocated(self.device))
            st.peak_bytes_in_use = int(
                torch.cuda.max_memory_allocated(self.device))
            st.bytes_limit = self._limit
        return st

    def start(self) -> "DeviceMonitor":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._status = self._sample()

    def status(self) -> DeviceStatus:
        return self._status

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=timeout)
