"""The default pass pipeline.

`optimize(graph)` runs the same default pipeline as the JAX package
(`anakin_tpu/graph/passes/__init__.py:42-66`):

  1. remove_identity_nodes    (split/dropout aliases)
  2. fold_batch_norms         (weight folding, parameter_fusion.h math)
  3. fuse_activations         (conv/dense/eltwise + act epilogues)
  4. fuse_conv_eltwise        (ResNet residual into conv epilogue)
  5. stem_space_to_depth      (7x7s2 RGB stem -> s2d + 4x4s1, fp32-pinned)
  6. eliminate_dead_nodes

The passes are numpy-only graph rewrites, so the port's optimized graph is
node-for-node and byte-for-byte the JAX package's.  `horizontal_combine`
and `stride_up` are exported and left out of the default pipeline, as in
the JAX package.  `optimize(autotune=True)` ends with the autotuner
(`kernels/autotune.py`), which picks flash or dense attention for long
prompts by timing both on the tuner's device.
"""

from __future__ import annotations

from ..ir import Graph
from .cleanup import eliminate_dead_nodes, remove_identity_nodes
from .combine import horizontal_combine
from .fold import fold_batch_norms
from .fusion import fuse_activations, fuse_conv_eltwise
from .stem import stem_space_to_depth
from .strideup import stride_up

__all__ = [
    "optimize",
    "horizontal_combine",
    "remove_identity_nodes",
    "fold_batch_norms",
    "fuse_activations",
    "fuse_conv_eltwise",
    "stem_space_to_depth",
    "stride_up",
    "eliminate_dead_nodes",
]

_DEFAULT_PIPELINE = (
    remove_identity_nodes,
    fold_batch_norms,
    fuse_activations,
    fuse_conv_eltwise,
    stem_space_to_depth,
    eliminate_dead_nodes,
)


def optimize(graph: Graph, pipeline=None, autotune: bool = False,
             tuner_cache: str = None, tuner_device=None) -> Graph:
    """Run the optimization pipeline; `autotune=True` then times the
    implementation candidates of each eligible node on `tuner_device`
    (None: CUDA, raising where there is none) and keeps the winners in
    `tuner_cache`, a JSON file, so that a later run times nothing."""
    g = graph
    for p in pipeline or _DEFAULT_PIPELINE:
        g = p(g)
    if autotune:
        from ...kernels.autotune import AutoTuner, autotune_graph

        g = autotune_graph(g, AutoTuner(tuner_cache, device=tuner_device))
    g.validate()
    return g
