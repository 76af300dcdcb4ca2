"""Op library: importing this package registers all ops into the registry."""

from .registry import ALIASES, OPS, get_op, register, resolve_op_name  # noqa: F401
from . import nn  # noqa: F401
from . import tensor  # noqa: F401
from . import quantized  # noqa: F401
from . import sequence  # noqa: F401
from . import attention  # noqa: F401
from . import moe  # noqa: F401
from . import detection  # noqa: F401
from . import extended  # noqa: F401
