"""Converter CLI: the port of `anakin_tpu/tools/converter/converter.py`.

Parity with the reference converter entry point
(`tools/external_converter_v2/converter.py` + `config.yaml:1-40`): a yaml
config selects the source framework and paths; the output is an engine
model directory (graph.json + weights.safetensors) optionally optimized
and quantized at conversion time — the reference likewise round-trips the
optimized graph through its model file.

config.yaml:

    TargetFramework: TORCH          # TORCH | ONNX | CAFFE | FLUID
    ModelPath: /path/to/model.pt    # torch.save()'d module OR "pkg.mod:fn"
    ExampleInputShape: [1, 3, 224, 224]
    Output: /path/to/out_model_dir
    Optimize: true
    # optional INT8:
    ScaleTable: /path/to/scales.txt

Usage: python -m anakin_tpu_torch.tools.converter.converter config.yaml

`yaml` is imported by `convert` itself, so the module imports without it.
"""

from __future__ import annotations

import importlib
import sys


def _load_torch_module(spec: str):
    import torch

    if ":" in spec and not spec.endswith((".pt", ".pth")):
        mod_name, fn_name = spec.split(":")
        factory = getattr(importlib.import_module(mod_name), fn_name)
        return factory()
    return torch.load(spec, weights_only=False)


def convert(config_path: str) -> str:
    import yaml

    with open(config_path) as f:
        cfg = yaml.safe_load(f)
    framework = cfg.get("TargetFramework", "TORCH").upper()
    out_dir = cfg["Output"]

    if framework == "TORCH":
        import torch

        from .torch_frontend import from_torch

        module = _load_torch_module(cfg["ModelPath"])
        shape = tuple(cfg["ExampleInputShape"])
        example = torch.zeros(shape)
        graph = from_torch(module, example)
    elif framework == "ONNX":
        from .onnx_frontend import from_onnx

        graph = from_onnx(cfg["ModelPath"])
    elif framework == "CAFFE":
        from .caffe_frontend import from_caffe

        graph = from_caffe(cfg["PrototxtPath"], cfg.get("ModelPath"))
    elif framework in ("TF", "TENSORFLOW"):
        from .tf_frontend import from_tf

        graph = from_tf(cfg["ModelPath"],
                        batch_size=int(cfg.get("BatchSize", 1)),
                        outputs=cfg.get("Outputs"))
    elif framework == "FLUID":
        from .fluid_frontend import from_fluid

        graph = from_fluid(cfg["ModelPath"], cfg.get("ParamsPath"),
                           batch_size=int(cfg.get("BatchSize", 1)))
    else:
        raise ValueError(f"unknown TargetFramework {framework!r}")

    if cfg.get("Optimize", True):
        from ... import optimize

        graph = optimize(graph)
    if cfg.get("ScaleTable"):
        from ...quant import quantize_graph, read_scale_table

        graph = quantize_graph(graph, read_scale_table(cfg["ScaleTable"]))
    from ...model_io import save_model

    save_model(graph, out_dir)
    return out_dir


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print(__doc__)
        return 2
    out = convert(argv[0])
    print(f"model written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
