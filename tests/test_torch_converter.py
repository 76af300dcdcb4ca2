"""The port's converters (`anakin_tpu_torch.tools`) against the JAX package's,
on the CPU.

Every frontend test of the JAX package (its ONNX, Caffe, Fluid, TF and
torch tests, the real-artifact tests and the torch CLI round trip) runs
here again with each JAX frontend replaced by a twin that converts the same
source with both packages: the two graphs must be equal node for node, and
their params byte for byte (nothing is computed on the way, so nothing may
differ); where the JAX frontend raises, the port's must raise the same
error.  The JAX test then goes on with the JAX graph, as it always does.

Tolerances of the rest:
  * one source per frontend through both `Net`s on the CPU: float32
    outputs within 1e-5 of the output's largest magnitude (the same graph,
    run by XLA and by PyTorch);
  * the converter CLI: the same output directory, file for file and byte
    for byte, and the same `ValueError` for a framework it does not know;
  * `compare_accuracy`: the JAX harness's numbers exactly (counts over the
    same int8 and float graphs on the same batches).
"""

import importlib
import inspect

import numpy as np
import pytest
import torch
import yaml

import anakin_tpu as ak
import anakin_tpu.tools.converter as jax_converter
import anakin_tpu_torch as pt
from anakin_tpu_torch.convert import graph_from_jax
from anakin_tpu_torch.tools import converter as port_converter
from test_torch_model_io import assert_same_graph

FRONTENDS = ("onnx", "caffe", "fluid", "tf", "torch")
JAX_TESTS = ("test_onnx_frontend", "test_caffe_frontend",
             "test_fluid_frontend", "test_tf_frontend", "test_torch_frontend",
             "test_real_artifacts")
# one float source per frontend for the Net against Net check
NET_CASES = {"onnx": ("test_onnx_frontend", "test_cnn_end_to_end"),
             "caffe": ("test_caffe_frontend", "test_classic_cnn"),
             "fluid": ("test_fluid_frontend", "test_cnn_conv_bn_pool_fc"),
             "tf": ("test_tf_frontend", "test_tf_cnn_same_padding"),
             "torch": ("test_torch_frontend", "test_small_cnn")}


def _frontend_modules(pkg):
    return {fe: importlib.import_module(f"{pkg}.tools.converter.{fe}_frontend")
            for fe in FRONTENDS}


def _cases():
    """(module, test name, its parameters) of every JAX frontend test."""
    cases = []
    for mod_name in JAX_TESTS:
        mod = importlib.import_module(mod_name)
        for name, fn in vars(mod).items():
            if not (name.startswith("test_") and inspect.isfunction(fn)):
                continue
            marks = [m for m in getattr(fn, "pytestmark", [])
                     if m.name == "parametrize"]
            if marks:
                argname, values = marks[0].args[:2]
                cases += [(mod_name, name, {argname: v}) for v in values]
            else:
                cases.append((mod_name, name, {}))
    cases.append(("test_tools", "test_converter_cli_roundtrip", {}))
    return cases


CASES = _cases()


def _run_twinned(monkeypatch, tmp_path, mod_name, name, params):
    """Run one JAX test with every JAX frontend twinned; returns the
    [(JAX graph, port graph)] of its conversions."""
    jax_fe, port_fe = (_frontend_modules("anakin_tpu"),
                       _frontend_modules("anakin_tpu_torch"))
    mod = importlib.import_module(mod_name)
    pairs = []

    def twin(fe):
        jax_from, port_from = (getattr(jax_fe[fe], f"from_{fe}"),
                               getattr(port_fe[fe], f"from_{fe}"))

        def convert(*args, **kw):
            try:
                gj = jax_from(*args, **kw)
            except Exception as exc:
                with pytest.raises(type(exc)):
                    port_from(*args, **kw)
                pairs.append((exc, None))
                raise
            gp = port_from(*args, **kw)
            assert_same_graph(gj, gp)
            pairs.append((gj, gp))
            return gj

        return convert

    for fe in FRONTENDS:
        f = twin(fe)
        monkeypatch.setattr(jax_fe[fe], f"from_{fe}", f)
        for holder in (mod, jax_converter):
            if hasattr(holder, f"from_{fe}"):
                monkeypatch.setattr(holder, f"from_{fe}", f)
    fn = getattr(mod, name)
    fixtures = {"rng": np.random.default_rng(1234), "tmp_path": tmp_path}
    args = {a: params[a] if a in params else fixtures[a]
            for a in inspect.signature(fn).parameters}
    fn(**args)
    assert pairs, f"{mod_name}::{name} converted nothing"
    return pairs


@pytest.mark.parametrize("mod_name,name,params", CASES,
                         ids=[f"{m}::{n}{''.join(f'[{v.__name__}]' for v in p.values())}"
                              for m, n, p in CASES])
def test_frontend_gives_jax_graph(monkeypatch, tmp_path, mod_name, name,
                                  params):
    """The port's frontend gives the JAX frontend's graph on each source of
    the JAX package's frontend tests."""
    _run_twinned(monkeypatch, tmp_path, mod_name, name, params)


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_frontend_net_matches_jax_net(monkeypatch, tmp_path, frontend):
    """One converted float graph per frontend through the port's `Net` and
    the JAX `Net` on the CPU, on a seeded input: within 1e-5 of the
    output's largest magnitude."""
    mod_name, name = NET_CASES[frontend]
    gj, gp = _run_twinned(monkeypatch, tmp_path, mod_name, name, {})[0]
    rng = np.random.default_rng(0)
    feed = {e: rng.normal(size=s).astype(np.float32)
            for e, (s, d) in gj.input_specs.items()}
    want = ak.Net(gj).prediction(feed)
    got = pt.Net(gp, device="cpu").prediction(feed)
    for e in gj.outputs:
        w = np.asarray(want[e], np.float32)
        np.testing.assert_allclose(got[e].numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))


# -------------------------------------------------------------------- CLI

def _write_config(tmp_path, name, **cfg):
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_cli_writes_the_jax_cli_directory(tmp_path):
    """The same config.yaml (the JAX CLI test's TinyNet, optimized) gives
    the JAX CLI's output directory, file for file."""
    from anakin_tpu.tools.converter.converter import main as jax_main
    from test_tools import TinyNet

    from anakin_tpu_torch.tools.converter.converter import main

    torch.manual_seed(0)
    torch.save(TinyNet().eval(), str(tmp_path / "model.pt"))
    cfg = dict(TargetFramework="TORCH", ModelPath=str(tmp_path / "model.pt"),
               ExampleInputShape=[1, 3, 16, 16], Optimize=True)
    assert jax_main([_write_config(tmp_path, "jax", Output=str(tmp_path / "jax"),
                                   **cfg)]) == 0
    assert main([_write_config(tmp_path, "port", Output=str(tmp_path / "port"),
                               **cfg)]) == 0
    for f in ("graph.json", "weights.safetensors"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f
    g = pt.model_io.load_model(str(tmp_path / "port"))
    assert "batch_norm" not in [n.op for n in g.nodes.values()]


def test_cli_refuses_an_unknown_framework(tmp_path):
    from anakin_tpu.tools.converter.converter import convert as jax_convert

    from anakin_tpu_torch.tools.converter.converter import convert

    path = _write_config(tmp_path, "c", TargetFramework="CNTK", Output="x")
    with pytest.raises(ValueError) as want:
        jax_convert(path)
    with pytest.raises(ValueError) as got:
        convert(path)
    assert str(got.value) == str(want.value)


def test_converter_package_keeps_lazy_frontends():
    """The package names the five frontends; the four protobuf ones are
    functions that import their module when called."""
    for fe in FRONTENDS:
        assert callable(getattr(port_converter, f"from_{fe}"))
    assert port_converter.from_onnx.__module__ == port_converter.__name__


# --------------------------------------------------------------- accuracy

def test_compare_accuracy_matches_jax():
    """The port's harness over the JAX package's float and int8 graphs of a
    small CNN (10 classes), on two seeded batches with labels, gives the
    JAX harness's dict."""
    from anakin_tpu.quant import calibrate as jax_calibrate
    from anakin_tpu.quant import quantize_graph as jax_quantize_graph
    from anakin_tpu.tools.accuracy import compare_accuracy as jax_compare
    from anakin_tpu.tools.converter import from_torch as jax_from_torch

    from anakin_tpu_torch.tools.accuracy import compare_accuracy

    torch.manual_seed(0)
    m = torch.nn.Sequential(
        torch.nn.Conv2d(3, 16, 3, padding=1), torch.nn.ReLU(),
        torch.nn.Conv2d(16, 16, 3, padding=1), torch.nn.ReLU(),
        torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(),
        torch.nn.Linear(16, 10)).eval()
    g = ak.optimize(jax_from_torch(m, torch.zeros(4, 3, 16, 16)))
    rng = np.random.default_rng(3)
    batches = [{g.inputs[0]: rng.normal(size=(4, 16, 16, 3)).astype(np.float32)}
               for _ in range(2)]
    labels = [rng.integers(0, 10, size=4) for _ in range(2)]
    gq = jax_quantize_graph(g, jax_calibrate(g, batches[:1], method="max"))
    assert any(n.op.endswith("_int8") for n in gq.nodes.values())
    want = jax_compare(g, gq, batches, labels)
    got = compare_accuracy(graph_from_jax(g), graph_from_jax(gq), batches,
                           labels, device="cpu")
    assert got == want and got["samples"] == 8
