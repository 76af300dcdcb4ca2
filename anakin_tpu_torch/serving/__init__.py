"""Serving: the continuous batcher, the device monitor and the gRPC
service (`server` and `daemon` are imported by name).  Needs the `grpc`
and `msgpack` packages, which `import anakin_tpu_torch` does not."""

from .batcher import ContinuousBatcher  # noqa: F401
from .monitor import DeviceMonitor, DeviceStatus  # noqa: F401
from .rpc import AnakinService, RpcClient, serve  # noqa: F401
