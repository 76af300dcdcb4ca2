"""anakin_tpu_torch — the anakin_tpu inference engine on PyTorch and CUDA.

A port of `anakin_tpu` (JAX on a TPU) to an NVIDIA H100: the same graph IR,
passes, model definitions and int8 quantization, an eager executor over
PyTorch tensors, and hand-written Hopper kernels in place of the Pallas
ones.  It imports neither JAX nor `anakin_tpu`.
"""

from .graph import Graph, GraphBuilder  # noqa: F401
from .graph.passes import optimize  # noqa: F401
from .runtime.net import Net  # noqa: F401
