from .detection import (build_faster_rcnn, build_faster_rcnn_lite,  # noqa: F401
                        build_ssd_vgg16, build_yolo_v3_tiny)
from .googlenet import build_googlenet, build_shufflenet_v1  # noqa: F401
from .lstm_lm import (build_lstm_lm, build_ner_tagger,  # noqa: F401
                      build_text_classifier)
from .mobilenet import build_mobilenet_v1, build_mobilenet_v2  # noqa: F401
from .resnet import (build_resnet, build_resnet50,  # noqa: F401
                     build_resnet101, identity_bottlenecks)
from .segmentation import build_fcn8s_lite, build_icnet_lite  # noqa: F401
from .transformer import (  # noqa: F401
    TransformerConfig,
    build_transformer_decode_step,
    build_transformer_lm,
    build_transformer_prefill,
    build_transformer_verify_step,
    make_transformer_params,
)
from .vgg import build_vgg16  # noqa: F401
