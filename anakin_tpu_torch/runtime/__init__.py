from .decode_scheduler import DecodeScheduler  # noqa: F401
from .generate import GenerationSession  # noqa: F401
from .net import Net, build_forward  # noqa: F401
from .speculative import SpeculativeSession  # noqa: F401
