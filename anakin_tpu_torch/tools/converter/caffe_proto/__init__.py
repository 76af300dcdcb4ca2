"""Self-contained Caffe protobuf bindings.

`caffe.proto` is a hand-transcribed subset of the public BVLC schema plus
the SSD fork's detection layers (see the header comment there for how
text-format vs wire-format compatibility is maintained).  `caffe_pb2.py`
is generated and checked in; regenerate with:

    protoc --python_out=. caffe.proto    # from this directory
"""

from . import caffe_pb2

__all__ = ["caffe_pb2"]
