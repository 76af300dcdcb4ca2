"""Self-contained PaddlePaddle Fluid protobuf bindings.

`framework.proto` is a hand-transcribed subset of Paddle's stable
`paddle/fluid/framework/framework.proto` (field numbers are fixed by the
wire format, so `__model__` ProgramDesc files written by any Paddle
release parse correctly; unknown fields are skipped).  `framework_pb2.py`
is generated and checked in; regenerate with:

    protoc --python_out=. framework.proto   # from this directory

Parity: replaces the reference Fluid frontend's dependency on a full
paddle install (`tools/external_converter_v2/parser/fluid/parser_fluid.py`
imports `paddle.fluid` and runs an Executor just to read weights).
"""

from . import framework_pb2

__all__ = ["framework_pb2"]
