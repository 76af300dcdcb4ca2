from .calibrator import (EntropyCalibrator, calibrate,  # noqa: F401
                         calibrate_kv_scales, read_scale_table,
                         write_scale_table)
from .policy import (apply_precision_policy, choose_precision,  # noqa: F401
                     is_depthwise_dominated, is_detection_graph)
from .quantize import (per_channel_weight_scale, quantize_graph,  # noqa: F401
                       weight_only_quantize)
