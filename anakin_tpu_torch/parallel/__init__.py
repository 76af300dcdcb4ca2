"""Parallelism: the port of `anakin_tpu/parallel/` over `torch.distributed`
(one process per rank; see `mesh`).  Importing it initializes nothing."""

from .mesh import (DATA_AXIS, DCN_AXIS, MODEL_AXIS, batch_axes,  # noqa: F401
                   batch_size_of, make_hybrid_mesh, make_mesh, replicated)
from .sharding import input_sharding, output_sharding, shard_graph_params  # noqa: F401
from .distributed import initialize, is_distributed, local_device_count  # noqa: F401
from .scaling import analyze_step, collective_stats, weak_scaling_report  # noqa: F401
from .pipeline import PipelinedNet, split_graph  # noqa: F401
from .ring_attention import ring_attention  # noqa: F401
