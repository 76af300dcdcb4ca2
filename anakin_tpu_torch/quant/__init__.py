from .calibrator import read_scale_table, write_scale_table  # noqa: F401
from .quantize import (per_channel_weight_scale, quantize_graph,  # noqa: F401
                       weight_only_quantize)
