"""Hand-written Hopper kernels, each beside its plain PyTorch version."""

from .bottleneck_int8 import (bottleneck_int8,  # noqa: F401
                              bottleneck_int8_op, bottleneck_int8_plain)
from .conv_int8 import (conv3x3_int8, conv3x3_int8_op,  # noqa: F401
                        conv3x3_int8_plain)
from .depthwise_int8 import (depthwise3x3_int8,  # noqa: F401
                             depthwise3x3_int8_op, depthwise3x3_int8_plain)
from .flash_attention import (flash_attention,  # noqa: F401
                              flash_attention_op, mha_reference)
from .matmul_int8 import (matmul_int8, matmul_int8_op,  # noqa: F401
                          matmul_int8_plain)
from .matmul_w4 import matmul_w4, matmul_w4_op, matmul_w4_plain  # noqa: F401

# each kernel entry as its registered op, `torch.ops.anakin_tpu_torch.<name>`
OPS = {"matmul_int8": matmul_int8_op, "conv3x3_int8": conv3x3_int8_op,
       "depthwise3x3_int8": depthwise3x3_int8_op,
       "bottleneck_int8": bottleneck_int8_op,
       "flash_attention": flash_attention_op, "matmul_w4": matmul_w4_op}
