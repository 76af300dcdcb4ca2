"""Whole-program export and the kernel build cache: the port of
`anakin_tpu/model_io/export.py`.

The JAX package serializes the jitted forward as StableHLO and points XLA's
persistent compilation cache at a directory.  Here:

  * `export_program` wraps a `Net`'s forward in an `nn.Module` whose
    buffers are the net's weights and the [N][K] copies it prepared for the
    int8 kernels, traces it with `torch.export.export(..., strict=False)` on
    the example inputs, and saves the program with `torch.export.save`.
    The kernels enter the program as the registered ops
    `torch.ops.anakin_tpu_torch.*` (`kernels.OPS`), so the loaded
    program launches the same hand-written kernels on the card;
  * `load_program` loads it (`torch.export.load`) and returns a callable
    from an input dict to an output dict, running no graph or op code of
    the port's own;
  * `enable_compilation_cache` points the kernel build directory
    (`kernels._build.BUILD_DIR`) at a directory: a later process with the
    same directory loads the built libraries (named by a hash of their
    sources) and runs no `nvcc`.
"""

import os
from typing import Any, Dict

import torch

from ..kernels import _build
from ..kernels.matmul_int8 import PreparedB
from ..ops.nn import full_fp32
from ..ops.quantized import PreparedGroups
from ..runtime.net import Net, _to_device

__all__ = ["export_program", "load_program", "enable_compilation_cache"]


class _Program(torch.nn.Module):
    """A `Net`'s forward over buffers: `param_<i>` for the weights and
    `prepared_<j>` for each distinct prepared int8 weight (a grouped conv's
    groups each have their own)."""

    def __init__(self, net: Net):
        super().__init__()
        self._forward = net.forward
        self._edges = list(net.params)
        for i, e in enumerate(self._edges):
            self.register_buffer(f"param_{i}", net.params[e])
        weight_of = {n.name: n.inputs[1] for n in net.order
                     if n.name in net.prepared}
        ids: Dict[int, int] = {}

        def buffer(p: PreparedB):
            if id(p.t) not in ids:
                ids[id(p.t)] = len(ids)
                self.register_buffer(f"prepared_{ids[id(p.t)]}", p.t)
            return f"prepared_{ids[id(p.t)]}", p.shape

        self._prepared = {}  # node -> (weight edge, [(buffer, shape)], grouped)
        for node, p in net.prepared.items():
            parts = p.parts if isinstance(p, PreparedGroups) else (p,)
            self._prepared[node] = (weight_of[node], [buffer(q) for q in parts],
                                    isinstance(p, PreparedGroups))

    def forward(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        params = {e: getattr(self, f"param_{i}")
                  for i, e in enumerate(self._edges)}
        prepared = {}
        for node, (edge, parts, grouped) in self._prepared.items():
            w = params[edge]
            bs = tuple(PreparedB(getattr(self, b), shape, w, None)
                       for b, shape in parts)
            prepared[node] = PreparedGroups(bs, w) if grouped else bs[0]
        return self._forward(params, inputs, prepared)


def export_program(net: Net, example_inputs: Dict[str, Any], path: str) -> None:
    """Save the whole forward, weights included, as a `torch.export`
    program at `path`, traced on `example_inputs` (their shapes and dtypes
    are the program's)."""
    feed = {k: _to_device(v, net.device) for k, v in example_inputs.items()}
    exported = torch.export.export(_Program(net), (feed,), strict=False)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(exported, path)


def load_program(path: str):
    """Load a program saved by `export_program`; returns
    `call(inputs_dict) -> outputs_dict`, which feeds numpy arrays or
    tensors to the device the program was exported on.

    The program's kernels are the ops that `kernels` registers, so
    `anakin_tpu_torch` must be imported in the process (importing this
    module does that).  The program runs with TF32 off (`ops.nn.
    full_fp32`), as the eager ops run their float32 products: a trace
    records the ops, not the backend flags they set."""
    program = torch.export.load(path)
    module = program.module()
    device = next((b.device for b in program.state_dict.values()),
                  torch.device("cpu"))

    def call(inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        with torch.inference_mode(), full_fp32():
            return module({k: _to_device(v, device)
                           for k, v in inputs.items()})

    return call


def enable_compilation_cache(cache_dir: str) -> None:
    """Build and load the port's kernels under `cache_dir`: each library is
    named by a hash of its sources, so a later process with the same
    directory loads it and runs no `nvcc` (the port's counterpart of XLA's
    persistent compilation cache)."""
    os.makedirs(cache_dir, exist_ok=True)
    _build.BUILD_DIR = os.path.abspath(cache_dir)
