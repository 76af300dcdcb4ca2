"""Hand-written Hopper kernels, each beside its plain PyTorch version."""

from .bottleneck_int8 import (bottleneck_int8,  # noqa: F401
                              bottleneck_int8_plain)
from .conv_int8 import conv3x3_int8, conv3x3_int8_plain  # noqa: F401
from .depthwise_int8 import (depthwise3x3_int8,  # noqa: F401
                             depthwise3x3_int8_plain)
from .flash_attention import flash_attention, mha_reference  # noqa: F401
from .matmul_int8 import matmul_int8, matmul_int8_plain  # noqa: F401
from .matmul_w4 import matmul_w4, matmul_w4_plain  # noqa: F401
