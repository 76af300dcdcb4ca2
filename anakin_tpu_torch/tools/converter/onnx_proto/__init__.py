"""Self-contained ONNX protobuf bindings.

`onnx.proto` is a hand-transcribed subset of the public ONNX schema (field
numbers are fixed by the wire format, so files written by any exporter
parse correctly; unknown fields are skipped).  `onnx_pb2.py` is generated
and checked in; regenerate with:

    protoc --python_out=. onnx.proto       # from this directory

Parity: replaces the reference ONNX frontend's dependency on the onnx pip
package (`tools/external_converter_v2/parser/onnx/`).
"""

from . import onnx_pb2

__all__ = ["onnx_pb2"]
