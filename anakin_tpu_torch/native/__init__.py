from .host import (  # noqa: F401
    decode_jpeg,
    native_available,
    plan_arena_native,
    preprocess_batch,
)
