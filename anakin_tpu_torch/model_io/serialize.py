"""Model file format: graph JSON + safetensors weights in one directory,
the port of `anakin_tpu/model_io/serialize.py` (the same files: a model
saved by either package loads in the other).

  <path>/graph.json     — nodes/edges/attrs/inputs/outputs + per-edge
                          quantization scales + per-node precisions +
                          applied_passes, so a model saved after
                          `optimize()` + `quantize_graph()` loads straight
                          into `Net` with no re-optimization
  <path>/weights.safetensors — all params (fp32/int8/scales)

The port writes and reads the safetensors format itself (the `safetensors`
package is not needed): an 8-byte little-endian header length, the JSON
header ({name: {"dtype", "shape", "data_offsets"}}, padded with spaces to a
multiple of 8), then the raw bytes, laid out as the package lays them out
(widest dtype first, then by name), so that the two write the same file.
Loading tries the native mmap loader (`native.host.load_safetensors`), then
the reader here (`np.memmap` over the header's offsets).

A BF16 entry loads as bfloat16 values (ml_dtypes' `bfloat16`, the form the
port's `Graph` and `convert._to_tensor` take) from both readers; the JAX
package's native loader gives its raw bits as uint16 instead (ROADMAP §3).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict

import numpy as np

from ..graph.ir import Graph

__all__ = ["save_model", "load_model", "FORMAT_VERSION", "read_safetensors",
           "write_safetensors"]

FORMAT_VERSION = 1

# safetensors dtype names, in the order the package lays entries out
# (widest first; ties as its enum orders them)
_ST_ORDER = ("U64", "I64", "F64", "F32", "U32", "I32", "BF16", "F16", "U16",
             "I16", "I8", "U8", "BOOL")
_ST_NAMES = {"float64": "F64", "float32": "F32", "float16": "F16",
             "bfloat16": "BF16", "int64": "I64", "int32": "I32",
             "int16": "I16", "int8": "I8", "uint64": "U64", "uint32": "U32",
             "uint16": "U16", "uint8": "U8", "bool": "BOOL"}


def _np_dtype(st_name: str) -> np.dtype:
    """The numpy dtype of a safetensors dtype name; BF16 is ml_dtypes'
    bfloat16, imported only for a BF16 entry."""
    if st_name == "BF16":
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    names = {v: k for k, v in _ST_NAMES.items() if k != "bfloat16"}
    if st_name not in names:
        raise ValueError(f"safetensors dtype {st_name!r} is not supported")
    return np.dtype(names[st_name])


def write_safetensors(tensors: Dict[str, np.ndarray], path: str) -> None:
    """Write {name: array} as a safetensors file."""
    # np.asarray keeps a 0-d array 0-d (np.ascontiguousarray, which the
    # JAX package's writer uses, makes it [1])
    arrays = {k: np.asarray(v, order="C") for k, v in tensors.items()}
    for k, v in arrays.items():
        if v.dtype.name not in _ST_NAMES:
            raise TypeError(f"param {k!r}: dtype {v.dtype} has no safetensors "
                            f"name")
    order = sorted(arrays, key=lambda k: (
        _ST_ORDER.index(_ST_NAMES[arrays[k].dtype.name]), k))
    header, offset = {}, 0
    for k in order:
        v = arrays[k]
        header[k] = {"dtype": _ST_NAMES[v.dtype.name], "shape": list(v.shape),
                     "data_offsets": [offset, offset + v.nbytes]}
        offset += v.nbytes
    text = json.dumps(header, separators=(",", ":"), ensure_ascii=False)
    raw = text.encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for k in order:
            f.write(arrays[k].tobytes())


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """{name: array} of a safetensors file: read-only views of one
    `np.memmap` of it, by the header's offsets."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    size = os.path.getsize(path)
    data = (np.memmap(path, np.uint8, mode="r", offset=8 + n)
            if size > 8 + n else np.empty(0, np.uint8))
    out = {}
    for k, info in header.items():
        begin, end = info["data_offsets"]
        arr = data[begin:end].view(_np_dtype(info["dtype"]))
        out[k] = arr.reshape(tuple(info["shape"]))
    return out


def _attrs_to_json(attrs: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, tuple):
            v = list(v)
        if isinstance(v, np.generic):
            v = v.item()
        out[k] = v
    return out


def save_model(graph: Graph, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    doc = {
        "format_version": FORMAT_VERSION,
        "name": graph.name,
        "inputs": graph.inputs,
        "outputs": graph.outputs,
        "input_specs": {k: [list(s), d] for k, (s, d) in graph.input_specs.items()},
        "scales": graph.scales,
        "precisions": graph.precisions,
        "applied_passes": graph.applied_passes,
        "nodes": [
            {
                "name": n.name,
                "op": n.op,
                "inputs": n.inputs,
                "outputs": n.outputs,
                "attrs": _attrs_to_json(n.attrs),
            }
            for n in graph.nodes.values()
        ],
    }
    with open(os.path.join(path, "graph.json"), "w") as f:
        json.dump(doc, f, indent=1)
    write_safetensors(graph.params, os.path.join(path, "weights.safetensors"))


def load_model(path: str) -> Graph:
    with open(os.path.join(path, "graph.json")) as f:
        doc = json.load(f)
    if doc.get("format_version", 0) > FORMAT_VERSION:
        raise ValueError(f"model format {doc['format_version']} is newer than "
                         f"supported {FORMAT_VERSION}")
    g = Graph(doc.get("name", "net"))
    g.inputs = list(doc["inputs"])
    g.outputs = list(doc["outputs"])
    g.input_specs = {k: (tuple(s), d) for k, (s, d) in doc["input_specs"].items()}
    g.scales = {k: float(v) for k, v in doc.get("scales", {}).items()}
    g.precisions = dict(doc.get("precisions", {}))
    g.applied_passes = list(doc.get("applied_passes", []))
    for nd in doc["nodes"]:
        attrs = {
            k: tuple(v) if isinstance(v, list) and k in _TUPLE_ATTRS else v
            for k, v in nd["attrs"].items()
        }
        g.add_node(nd["name"], nd["op"], nd["inputs"], nd["outputs"], **attrs)
    weights_path = os.path.join(path, "weights.safetensors")
    # native mmap loader first (zero-copy; pages fault in on demand), then
    # the reader here
    from ..native.host import load_safetensors

    params = load_safetensors(weights_path)
    if params is None:
        params = read_safetensors(weights_path)
    g.params = params
    g.validate()
    return g


# attrs whose list values are semantically tuples (kept as lists works too —
# ops accept both — but round-tripping to tuple keeps attr equality stable)
_TUPLE_ATTRS = {"strides", "padding", "dilation", "window", "out_hw",
                "pad_h", "pad_w", "pad_c", "pooled_hw", "order", "img_hw"}
