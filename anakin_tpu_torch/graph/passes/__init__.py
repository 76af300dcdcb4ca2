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
node-for-node and byte-for-byte the JAX package's.
"""

from __future__ import annotations

from ..ir import Graph
from .cleanup import eliminate_dead_nodes, remove_identity_nodes
from .fold import fold_batch_norms
from .fusion import fuse_activations, fuse_conv_eltwise
from .stem import stem_space_to_depth

__all__ = [
    "optimize",
    "remove_identity_nodes",
    "fold_batch_norms",
    "fuse_activations",
    "fuse_conv_eltwise",
    "stem_space_to_depth",
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
             tuner_cache: str = None) -> Graph:
    """Run the optimization pipeline.  `autotune` is not ported yet: the
    port has one implementation per op, so there is nothing to choose."""
    if autotune or tuner_cache is not None:
        raise NotImplementedError("the autotuner is not ported yet")
    g = graph
    for p in pipeline or _DEFAULT_PIPELINE:
        g = p(g)
    g.validate()
    return g
