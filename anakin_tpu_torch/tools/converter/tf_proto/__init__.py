"""Self-contained TensorFlow GraphDef protobuf bindings.

`graph.proto` is a hand-transcribed subset of the public TF schema (field
numbers are fixed by the wire format, so frozen .pb files written by any
TF release parse correctly; unknown fields are skipped).  `graph_pb2.py`
is generated and checked in; regenerate with:

    protoc --python_out=. graph.proto    # from this directory

Parity: replaces the reference TF frontend's dependency on a tensorflow
install (`tools/external_converter_v2/parser/tensorflow/`).
"""

from . import graph_pb2

__all__ = ["graph_pb2"]
