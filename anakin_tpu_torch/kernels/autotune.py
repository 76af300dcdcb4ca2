"""Autotuner: per-(op, shape, device) implementation choice, the port of
`anakin_tpu/kernels/autotune.py`.

`autotune_graph` times each eligible node's candidate implementations on
random operands of the node's real shapes, writes the winner into the
node's `impl` attribute and keeps it in a JSON cache, so that a later run
times nothing.  A candidate other than the baseline must beat it by
`margin` (1.3, as in the JAX package) to be chosen.

The port's only real choice is prefill attention: `multi_head_attention`
and `mha_prefill` at S >= 512 choose between "dense" and "flash".  The
JAX tuner also times its int8 and w4 nodes (XLA against Pallas); the port
has no XLA lowering for them and runs every int8 and w4 node on its
kernels whatever `impl` says (ROADMAP, port ground rules), so the tuner
leaves their `impl` as it is.  Writing "pallas" there would change what
`dense_w4` runs: `variant="v2"` takes effect only on an `impl="pallas"`
node.

Timing runs on the tuner's device, CUDA unless the caller asks for the CPU
(`AutoTuner(device="cpu")`), and raises where there is no GPU, as `Net`
does.  Each candidate is called once first (the kernel's build and first
launch, not timed), then timed with CUDA events over windows of chained
calls.  Operands are float32 / int8 as shape inference gives them, as the
JAX tuner times them, whatever precision the net later runs in.  On the
CPU the baseline is the only candidate and nothing is timed: a kernel's
plain version there is not a candidate, so CPU tuning is deterministic.

The cache file is versioned: `{"__schema__": N, "entries": {key: impl}}`.
A file of another schema is dropped whole, since its keys would never
match.  The key names the card (`torch.cuda.get_device_name`) where the
JAX key has `jax.default_backend()`, so the port's schema is the JAX
package's 3 plus one.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import statistics
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .flash_attention import takes_head_dim

__all__ = ["AutoTuner", "autotune_graph"]

_CACHE_SCHEMA = 4  # bump when _node_key fields change; older entries drop
_WINDOWS = 3       # timed windows per candidate (median)
_CALLS = 5         # chained calls per window
_ATTENTION_FROM = 512  # below it the dense path is kept untimed, as in JAX
_TIMED_DTYPE = torch.float32  # the float operands `_operands` makes

_log = logging.getLogger("anakin_tpu_torch")


def device_name(device: torch.device) -> str:
    """The cache key's device: the card's name, or the device type."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


class AutoTuner:
    """Times candidates on `device` (None: CUDA) and caches the winners in
    `cache_path` (a JSON file; None keeps them in memory).  `timings`
    holds the milliseconds of every candidate timed, by key."""

    def __init__(self, cache_path: Optional[str] = None, device=None):
        from ..runtime.net import _resolve_device

        self.cache_path = cache_path
        self.device = _resolve_device(device)
        self.cache: Dict[str, str] = {}
        self.timings: Dict[str, Dict[str, float]] = {}
        if cache_path and os.path.exists(cache_path):
            with open(cache_path) as f:
                raw = json.load(f)
            if isinstance(raw, dict) and raw.get("__schema__") == _CACHE_SCHEMA:
                self.cache = raw.get("entries", {})

    def _save(self) -> None:
        if self.cache_path:
            with open(self.cache_path, "w") as f:
                json.dump({"__schema__": _CACHE_SCHEMA,
                           "entries": self.cache}, f, indent=1)

    def _time_ms(self, thunk: Callable[[], Any]) -> float:
        """Median over windows of the mean ms of chained calls, after one
        untimed call."""
        thunk()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(_WINDOWS):
            torch.cuda.synchronize(self.device)
            start.record()
            for _ in range(_CALLS):
                thunk()
            end.record()
            torch.cuda.synchronize(self.device)
            times.append(start.elapsed_time(end) / _CALLS)
        return statistics.median(times)

    def pick(self, key: str, candidates: Dict[str, Callable[[], Any]],
             baseline: str = "xla", margin: float = 1.3) -> str:
        """The cached choice for `key` if it is a candidate; else time each
        candidate (one call each untimed first) and cache the fastest,
        which must beat `baseline` by `margin` to replace it.  With the
        baseline alone, nothing is timed.  A candidate that raises is a
        fault, not a loss: the error propagates and nothing is cached (the
        JAX tuner skips it, which on the card would hide a broken kernel
        behind the plain path and keep that choice in the cache)."""
        if key in self.cache and self.cache[key] in candidates:
            return self.cache[key]
        if list(candidates) == [baseline]:
            best = baseline
        else:
            times: Dict[str, float] = {}
            with torch.cuda.device(self.device), torch.inference_mode():
                for name, thunk in candidates.items():
                    times[name] = self._time_ms(thunk)
            self.timings[key] = times
            best = min(times, key=times.get)
            if best != baseline and times[baseline] <= times[best] * margin:
                best = baseline
            _log.info("autotune %s: %s -> %s", key, times, best)
        self.cache[key] = best
        self._save()
        return best


def _node_key(node, shapes, device: torch.device) -> str:
    return json.dumps({
        "op": node.op,
        "in": [list(shapes[e].shape) for e in node.inputs],
        "strides": node.attr("strides"),
        "groups": node.attr("groups", 1),
        "heads": node.attr("num_heads"),
        "device": device_name(device),
    }, sort_keys=True)


def _attention_candidates(node, shapes):
    """(baseline, candidates) of an attention node at S >= 512, else None:
    below it the dense path is kept (the JAX package's measured
    crossover).  Flash is a candidate only where the CUDA kernel takes the
    node's head dim in the dtype the tuner times (`_TIMED_DTYPE`); else
    dense is kept untimed."""
    if node.op not in ("multi_head_attention", "mha_prefill"):
        return None
    if shapes[node.inputs[0]].shape[1] < _ATTENTION_FROM:
        return None
    D = shapes[node.inputs[1]].shape[1] // int(node.attr("num_heads"))
    if not takes_head_dim(D, _TIMED_DTYPE):
        return "dense", ["dense"]
    return "dense", ["dense", "flash"]


def _operands(g, node, shapes, rng, device):
    """The node's inputs: its params as the graph holds them, and random
    int8 or float32 tensors of its other inputs' shapes."""
    from ..convert import params_from_numpy

    args = []
    for e in node.inputs:
        if e in g.params:
            args.append(params_from_numpy({e: g.params[e]}, device)[e])
            continue
        s = shapes[e]
        if s.dtype.is_floating_point:
            v = rng.normal(size=tuple(s.shape)).astype(np.float32)
        else:
            v = rng.integers(-127, 128, size=tuple(s.shape)).astype(
                str(s.dtype).replace("torch.", ""))
        args.append(torch.from_numpy(v).to(device))
    return args


def autotune_graph(graph, tuner: Optional[AutoTuner] = None):
    """A copy of `graph` with `impl` set on every attention node at S >=
    512 to the tuner's choice ("dense" or "flash"; only "dense" on the
    CPU); every other node as it was.  `tuner` defaults to an
    `AutoTuner()` on CUDA with no cache file."""
    from ..graph.shape_infer import infer_shapes
    from ..ops import get_op

    tuner = tuner or AutoTuner()
    g = graph.clone()
    shapes = infer_shapes(g)
    rng = np.random.default_rng(0)
    for node in g.nodes.values():
        attn = _attention_candidates(node, shapes)
        if attn is None:
            continue
        baseline, impls = attn
        if tuner.device.type != "cuda":
            impls = [baseline]
        args = (_operands(g, node, shapes, rng, tuner.device)
                if len(impls) > 1 else [])

        def thunk(impl, node=node, args=args):
            n2 = copy.deepcopy(node)
            n2.attrs["impl"] = impl
            return lambda: get_op(n2.op)(n2, list(args))

        node.attrs["impl"] = tuner.pick(
            _node_key(node, shapes, tuner.device),
            {im: thunk(im) for im in impls}, baseline=baseline)
    g.applied_passes.append("autotune")
    return g
