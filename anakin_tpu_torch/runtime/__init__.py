from .net import Net, build_forward  # noqa: F401
