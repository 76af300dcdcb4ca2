from .resnet import build_resnet, build_resnet50, build_resnet101  # noqa: F401
from .transformer import (  # noqa: F401
    TransformerConfig,
    build_transformer_decode_step,
    build_transformer_lm,
    build_transformer_prefill,
    build_transformer_verify_step,
    make_transformer_params,
)
