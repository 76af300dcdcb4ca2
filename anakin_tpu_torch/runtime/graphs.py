"""CUDA-graph capture of a static-shape step: the port's counterpart of
`jax.jit`.

The JAX `Net` traces its graph into one compiled program, so a decode step
is one dispatch.  The port's executor is eager: a 1B-class w4 decode step
issues about 2,100 launches from Python, and the card waits on the host
(PERF.md section 5).  `compile_step` records such a step once into a CUDA
graph and then replays it, one launch from the host a step:

  * the step runs once on a side stream first (warm-up: kernel libraries
    load, cuBLAS makes its handles), then once under capture, into a
    memory pool of the graph's own; what the step allocates (its outputs,
    `matmul_w4`'s output and workspace) comes from that pool, at the same
    addresses on every replay;
  * inputs named in `static` are bound as they are: the graph reads and
    writes those tensors themselves, so a cache that the step updates in
    place (`mha_decode`) is never copied.  Every other input gets a buffer
    of the step's own, and a call copies the new values into it;
  * a call returns the graph's own output tensors, which the next replay
    overwrites: read them (or copy them) before the next call.

The launch counters of the kernel wrappers move when the wrappers run, at
warm-up and at capture; a replay launches the recorded kernels without
running any Python, so it counts nothing.

On the CPU, `compile_step` returns the eager step behind the same call
interface.  On CUDA a failed capture raises; nothing falls back to eager.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable

import numpy as np
import torch

__all__ = ["CapturedStep", "EagerStep", "compile_step"]

Step = Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]


def _as_tensor(v: Any, device: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.from_numpy(np.array(v)).to(device)


class _Bound:
    """The inputs of a step: the `static` ones kept as given, the others
    in buffers of the step's own, each refilled by a call."""

    def __init__(self, inputs: Dict[str, Any], static: Iterable[str],
                 device: torch.device):
        static = set(static)
        unknown = static - set(inputs)
        if unknown:
            raise KeyError(f"static inputs {sorted(unknown)} are not inputs")
        self.device = device
        self.static = {}
        for k in static:
            t = inputs[k]
            if not isinstance(t, torch.Tensor) or t.device != device:
                raise ValueError(f"static input {k!r} must be a tensor on "
                                 f"{device}: the step binds it as it is")
            self.static[k] = t
        with torch.inference_mode(False):  # buffers refilled outside it too
            self.buffers = {k: _as_tensor(v, device).clone()
                            for k, v in inputs.items() if k not in static}
        self.args = dict(self.buffers, **self.static)

    def fill(self, inputs: Dict[str, Any]) -> None:
        for k, v in inputs.items():
            if k in self.static:
                if v is not self.static[k]:
                    raise ValueError(f"static input {k!r} is bound to the "
                                     f"tensor the step was made with")
            elif k in self.buffers:
                buf = self.buffers[k]
                if not isinstance(v, torch.Tensor):
                    v = torch.from_numpy(np.asarray(v))
                buf.copy_(v.reshape(buf.shape))
            else:
                raise KeyError(f"{k!r} is not an input of this step")


class EagerStep:
    """`fn` called eagerly behind `CapturedStep`'s interface (the CPU)."""

    def __init__(self, fn: Step, inputs: Dict[str, Any],
                 static: Iterable[str], device: torch.device):
        self.fn = fn
        self._in = _Bound(inputs, static, device)

    def __call__(self, inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        self._in.fill(inputs)
        with torch.inference_mode():
            return self.fn(self._in.args)


class CapturedStep:
    """`fn` captured in a CUDA graph for the shapes and dtypes of `inputs`
    (see the module's docstring); `step(inputs)` replays it."""

    def __init__(self, fn: Step, inputs: Dict[str, Any],
                 static: Iterable[str], device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"CapturedStep captures on CUDA, not {device}")
        self.fn = fn
        self._in = _Bound(inputs, static, device)
        with torch.cuda.device(device), torch.inference_mode():
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(self._in.args)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            # thread_local: another thread's CUDA calls (a caller waiting on
            # a scheduler's futures) do not invalidate this capture
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self.outputs = fn(self._in.args)
        self.device = device

    def __call__(self, inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        with torch.cuda.device(self.device):
            self._in.fill(inputs)
            self.graph.replay()
        return self.outputs


def compile_step(fn: Step, inputs: Dict[str, Any], static: Iterable[str],
                 device: torch.device):
    """`fn(inputs) -> {name: tensor}` made replayable on `device` for the
    shapes and dtypes of `inputs`: a `CapturedStep` on CUDA, an
    `EagerStep` on the CPU.  `device` names its index on CUDA (`cuda:0`),
    as `Net` resolves it; static inputs lie on that device."""
    if device.type == "cuda":
        return CapturedStep(fn, inputs, static, device)
    return EagerStep(fn, inputs, static, device)
