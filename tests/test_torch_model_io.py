"""Model IO of the port (`anakin_tpu_torch.model_io`, `native`, the
registered kernel ops) against the JAX package, on the CPU.

Tolerances, and why:
  * a graph written by one package and read by the other: equal node for
    node (names, ops, edges, attrs with their tuple/list types), equal
    inputs, outputs, input specs, scales, precisions and applied passes,
    and params of equal dtype, shape and bytes; nothing is computed, so
    nothing may differ;
  * a saved and reloaded int8 net: bit-equal outputs (the same weights run
    through the same code);
  * an exported program: rtol 1e-5 / atol 1e-6 against `Net`, the JAX
    package's own bar for its exported program (`tests/test_runtime.py`);
    it comes out bit-equal here, since the program runs the same ops;
  * `torch.library.opcheck` on each registered kernel op: its own checks
    (schema, fake against real on CPU inputs).
"""

import gc
import json
import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import anakin_tpu as ak
from anakin_tpu.model_io import load_model as jax_load_model
from anakin_tpu.model_io import save_model as jax_save_model
from anakin_tpu.models import build_resnet50 as jax_build_resnet50
from anakin_tpu.quant import calibrate as jax_calibrate
from anakin_tpu.quant import quantize_graph as jax_quantize_graph
import anakin_tpu_torch as pt
from anakin_tpu_torch.convert import graph_from_jax
from anakin_tpu_torch.kernels import OPS, _build
from anakin_tpu_torch.kernels.matmul_int8 import prepare_b
from anakin_tpu_torch.model_io import (enable_compilation_cache,
                                       export_program, load_model,
                                       load_program, save_model)
from anakin_tpu_torch.model_io.serialize import (FORMAT_VERSION,
                                                 read_safetensors,
                                                 write_safetensors)
from anakin_tpu_torch.models import build_resnet50
from anakin_tpu_torch.native import host
from anakin_tpu_torch.quant import calibrate, quantize_graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ----------------------------------------------------------------- helpers

def _same_value(a, b, where):
    """Equal values of equal types, recursively (a tuple is not a list)."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same_value(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same_value(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray):
        _same_array(a, b, where)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), where
    else:
        assert a == b, (where, a, b)


def _same_array(a, b, where):
    a, b = np.asarray(a), np.asarray(b)
    assert (a.dtype, a.shape) == (b.dtype, b.shape), (where, a.dtype,
                                                      b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), where


def assert_same_graph(want, got):
    """`got` is `want` node for node, with byte-equal params."""
    assert list(got.nodes) == list(want.nodes)
    for name, n in want.nodes.items():
        m = got.nodes[name]
        assert (m.op, m.inputs, m.outputs) == (n.op, n.inputs, n.outputs), name
        _same_value(n.attrs, m.attrs, f"{name}.attrs")
    assert (got.name, got.inputs, got.outputs) == (want.name, want.inputs,
                                                   want.outputs)
    _same_value(dict(want.input_specs), dict(got.input_specs), "input_specs")
    _same_value(dict(want.scales), dict(got.scales), "scales")
    _same_value(dict(want.precisions), dict(got.precisions), "precisions")
    _same_value(list(want.applied_passes), list(got.applied_passes),
                "applied_passes")
    assert sorted(got.params) == sorted(want.params)
    for k in want.params:
        _same_array(want.params[k], got.params[k], k)


@pytest.fixture(scope="module")
def jax_int8_graph():
    """The JAX package's int8 ResNet-50 at 32 px, b2 (calibrated on one
    seeded batch), with one node pinned to bf16 so that precisions are not
    empty, and the input."""
    g = ak.optimize(jax_build_resnet50(batch=2, image_size=32))
    x = np.random.default_rng(7).normal(size=(2, 32, 32, 3)).astype(np.float32)
    gq = jax_quantize_graph(g, jax_calibrate(g, [{"input": x}], method="max"))
    gq.precisions = dict(gq.precisions)
    gq.precisions[next(n for n in gq.nodes if gq.nodes[n].op == "softmax")] = "bf16"
    return gq, x


@pytest.fixture(scope="module")
def port_int8_graph():
    """The port's own int8 ResNet-50 at 32 px, b2, calibrated on the CPU."""
    g = pt.optimize(build_resnet50(batch=2, image_size=32))
    x = np.random.default_rng(7).normal(size=(2, 32, 32, 3)).astype(np.float32)
    return quantize_graph(g, calibrate(g, [{"input": x}], method="max",
                                       device="cpu")), x


# ------------------------------------------------------- between packages

def test_jax_saved_model_loads_in_port(tmp_path, jax_int8_graph):
    """A model directory written by the JAX package loads in the port as
    the graph the JAX package loads from it (JSON keeps a tuple inside a
    tuple as a list: both packages read it back so)."""
    gq, _ = jax_int8_graph
    jax_save_model(gq, str(tmp_path))
    assert_same_graph(jax_load_model(str(tmp_path)), load_model(str(tmp_path)))


def test_port_saved_model_loads_in_jax(tmp_path, jax_int8_graph):
    """A model directory written by the port loads in the JAX package as
    the one the JAX package writes, and its two files equal the JAX
    package's byte for byte."""
    gq, _ = jax_int8_graph
    save_model(graph_from_jax(gq), str(tmp_path / "port"))
    jax_save_model(gq, str(tmp_path / "jax"))
    assert_same_graph(jax_load_model(str(tmp_path / "jax")),
                      jax_load_model(str(tmp_path / "port")))
    for name in ("graph.json", "weights.safetensors"):
        with open(tmp_path / "port" / name, "rb") as a, \
                open(tmp_path / "jax" / name, "rb") as b:
            assert a.read() == b.read(), name


# ------------------------------------------------------------ the weights

def _weights(rng):
    return {"w": rng.normal(size=(3, 3, 4, 8)).astype(np.float32),
            "q": rng.integers(-127, 128, size=(16, 5)).astype(np.int8),
            "s": np.array(0.5, np.float32), "i": np.arange(7, dtype=np.int32),
            "d": rng.normal(size=5), "e": np.zeros((0, 3), np.float32),
            "b": rng.normal(size=(6,)).astype(ml_dtypes.bfloat16),
            "m": np.array([True, False]), "u": np.arange(3, dtype=np.uint8)}


def test_safetensors_writer_matches_the_package(tmp_path, rng):
    """The port's writer gives the bytes `safetensors.numpy.save_file`
    gives; the package, the native loader and the port's reader read them
    back equal."""
    from safetensors.numpy import load_file, save_file

    w = _weights(rng)
    write_safetensors(w, str(tmp_path / "port.safetensors"))
    save_file(w, str(tmp_path / "pkg.safetensors"))
    assert (tmp_path / "port.safetensors").read_bytes() == \
        (tmp_path / "pkg.safetensors").read_bytes()
    readers = {"package": load_file, "port": read_safetensors}
    if host.native_available():
        readers["native"] = host.load_safetensors
    for name, read in readers.items():
        got = read(str(tmp_path / "port.safetensors"))
        assert sorted(got) == sorted(w), name
        for k in w:
            _same_array(w[k], got[k], f"{name}:{k}")


def test_load_without_native_loader(tmp_path, monkeypatch, port_int8_graph):
    """With the native loader gone, `load_model` reads the weights with its
    own reader, equal to what the native loader gives."""
    g, _ = port_int8_graph
    save_model(g, str(tmp_path))
    native = load_model(str(tmp_path))
    monkeypatch.setattr(host, "load_safetensors", lambda path: None)
    assert_same_graph(native, load_model(str(tmp_path)))
    for k in g.params:
        _same_array(g.params[k], native.params[k], k)


def test_bf16_param_round_trips_as_bf16(tmp_path, monkeypatch):
    """A bf16 param loads as bfloat16 values from both of the port's
    readers (the JAX package's native loader gives uint16 bits)."""
    g = pt.Graph("bf16")
    g.add_input("x", (2, 6), "float32")
    g.add_param("b", np.linspace(-3, 3, 6).astype(ml_dtypes.bfloat16))
    g.add_node("add", "eltwise", ["x", "b"], ["y"], mode="sum")
    g.mark_output("y")
    save_model(g, str(tmp_path))
    for native in (True, False):
        if not native:
            monkeypatch.setattr(host, "load_safetensors", lambda path: None)
        got = load_model(str(tmp_path)).params["b"]
        _same_array(g.params["b"], got, f"native={native}")
        y = pt.Net(load_model(str(tmp_path)), device="cpu").prediction(
            {"x": np.zeros((2, 6), np.float32)})["y"]
        np.testing.assert_array_equal(
            y.numpy(), np.broadcast_to(g.params["b"].astype(np.float32), (2, 6)))


def test_native_arrays_outlive_their_dict(tmp_path, rng):
    """An array of the native loader stays readable after the dict it came
    in is gone (each array keeps the file mapping alive; the JAX package's
    copy ties the mapping to the dict alone)."""
    if not host.native_available():
        pytest.skip("native library not built (make -C native)")
    w = _weights(rng)
    write_safetensors(w, str(tmp_path / "w.safetensors"))
    arrays = [host.load_safetensors(str(tmp_path / "w.safetensors"))[k]
              for k in ("w", "q", "b")]
    gc.collect()
    for k, a in zip(("w", "q", "b"), arrays):
        _same_array(w[k], a.copy(), k)


def test_newer_format_version_raises(tmp_path, port_int8_graph):
    g, _ = port_int8_graph
    save_model(g, str(tmp_path))
    doc = json.loads((tmp_path / "graph.json").read_text())
    doc["format_version"] = FORMAT_VERSION + 1
    (tmp_path / "graph.json").write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="newer"):
        load_model(str(tmp_path))


def test_native_loader_absent_when_it_does_not_load(monkeypatch):
    """A library that fails to load (libjpeg missing, say) counts as no
    library: `native_available()` is False and the loader gives None."""
    def refuse(path, *a, **kw):
        raise OSError("libjpeg.so.62: cannot open shared object file")

    monkeypatch.setattr(host, "_LIB", None)
    monkeypatch.setattr(host.ctypes, "CDLL", refuse)
    assert not host.native_available()
    assert host.load_safetensors("nothing.safetensors") is None


# --------------------------------------------------------- the saved net

@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_saved_int8_net_is_bit_equal(tmp_path, port_int8_graph, precision):
    """save -> load -> Net on the CPU gives the net's outputs bit for bit."""
    g, x = port_int8_graph
    save_model(g, str(tmp_path))
    want = pt.Net(g, precision=precision, device="cpu").prediction({"input": x})
    got = pt.Net(load_model(str(tmp_path)), precision=precision,
                 device="cpu").prediction({"input": x})
    for k in want:
        assert torch.equal(got[k], want[k]), k


# -------------------------------------------------------- the exported net

def _kernel_ops(path):
    program = torch.export.load(path)
    return sorted(str(n.target) for n in program.graph.nodes
                  if str(n.target).startswith("anakin_tpu_torch."))


@pytest.mark.parametrize("which", ["fp32", "int8"])
def test_exported_program_matches_net(tmp_path, port_int8_graph, which):
    """export_program -> load_program on the CPU against the Net (the JAX
    package's bar, rtol 1e-5 / atol 1e-6); the int8 program records the
    two kernels as registered ops, 40 + 13 calls."""
    g, x = port_int8_graph
    if which == "fp32":
        g = pt.optimize(build_resnet50(batch=2, image_size=32))
    net = pt.Net(g, device="cpu")
    path = str(tmp_path / "prog.pt2")
    export_program(net, {"input": x}, path)
    got = load_program(path)({"input": x})
    want = net.prediction({"input": x})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-6)
    ops = _kernel_ops(path)
    if which == "int8":
        assert ops.count("anakin_tpu_torch.matmul_int8.default") == 40
        assert ops.count("anakin_tpu_torch.conv3x3_int8.default") == 13
    else:
        assert ops == []


def test_enable_compilation_cache_moves_the_build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    enable_compilation_cache(str(tmp_path / "cache"))
    assert _build.BUILD_DIR == str(tmp_path / "cache")
    assert os.path.isdir(_build.BUILD_DIR)
    lib = _build._library_path("matmul_int8")
    assert os.path.dirname(lib) == str(tmp_path / "cache")


# ---------------------------------------------------- the registered ops

def _i8(g, *shape):
    return torch.randint(-127, 128, shape, dtype=torch.int8, generator=g)


def _op_cases():
    g = torch.Generator().manual_seed(0)
    f = lambda *s: torch.rand(*s, generator=g) + 0.5  # noqa: E731
    a, b = _i8(g, 6, 40), _i8(g, 40, 24)
    pb = prepare_b(b)
    x, w = _i8(g, 2, 5, 6, 16), _i8(g, 3, 3, 16, 8)
    pw = prepare_b(w)
    dx, dw = _i8(g, 1, 7, 9, 8), _i8(g, 3, 3, 1, 8)
    bx = _i8(g, 1, 4, 5, 16)
    wa, wb, wc = _i8(g, 16, 8), _i8(g, 3, 3, 8, 8), _i8(g, 8, 16)
    q = torch.randn(2, 4, 9, 32, generator=g)
    k = torch.randn(2, 2, 9, 32, generator=g)
    v = torch.randn(2, 2, 9, 32, generator=g)
    seg = torch.tensor([[0] * 5 + [1] * 4, [0] * 9], dtype=torch.int32)
    xw = torch.randn(3, 64, generator=g)
    packed = _i8(g, 32, 12)
    scales = f(2, 12)
    return {
        "matmul_int8": (a, b, None, f(24), f(24), None, 0.02, "relu", 0.0,
                        None, torch.float32, None),
        "matmul_int8_prepared": (a, pb.t, list(pb.shape), f(24), None,
                                 _i8(g, 6, 24), 0.02, None, 0.0, 0.5,
                                 torch.float32, 0.1),
        "conv3x3_int8": (x, w, None, f(8), f(8), None, 0.02, "relu6", 0.0,
                         None, torch.bfloat16, None),
        "conv3x3_int8_prepared": (x, pw.t, list(pw.shape), f(8), None,
                                  f(2, 5, 6, 8), 0.02, "leaky_relu", 0.1,
                                  0.3, torch.float32, None),
        "depthwise3x3_int8": (dx, dw, f(8), f(8), 1, 0.02, "relu", 0.0, 0.2,
                              torch.float32),
        "depthwise3x3_int8_s2": (dx, dw, f(8), None, 2, 0.02, None, 0.0,
                                 None, torch.float32),
        "bottleneck_int8": (bx, wa, None, f(8), wb, None, f(8), wc, None,
                            f(16), f(8), None, f(16), 0.02, 0.1, 0.1, 0.05,
                            None, torch.float32),
        "flash_attention": (q, k, v, None, None, True, 0.2),
        "flash_attention_segments": (q, k, v, seg, seg, False, 0.2),
        "matmul_w4": (xw, packed, scales, 32, "v1"),
        "matmul_w4_v2": (xw, packed, scales, 32, "v2"),
    }


@pytest.mark.parametrize("case", sorted(_op_cases()))
def test_registered_op_passes_opcheck(case):
    """Each kernel op on CPU inputs at one small shape: schema, fake
    implementation against the real one (here the plain version)."""
    args = _op_cases()[case]
    name = next(n for n in sorted(OPS, key=len, reverse=True)
                if case.startswith(n))
    torch.library.opcheck(OPS[name], args)


def test_registered_ops_are_the_kernel_entries():
    assert sorted(OPS) == sorted(
        ["matmul_int8", "conv3x3_int8", "depthwise3x3_int8",
         "bottleneck_int8", "flash_attention", "matmul_w4"])
    for name in OPS:
        assert hasattr(torch.ops.anakin_tpu_torch, name)


def test_model_io_and_converters_import_without_optional_packages():
    """`anakin_tpu_torch.model_io` and `anakin_tpu_torch.tools.converter`
    import with protobuf, yaml and safetensors refused, and a model saves
    and loads."""
    code = (
        "import sys, tempfile, numpy as np\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('yaml', 'safetensors') or "
        "name.startswith('google.protobuf'):\n"
        "            raise ImportError('refused: ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "import anakin_tpu_torch as pt\n"
        "import anakin_tpu_torch.tools.converter\n"
        "import anakin_tpu_torch.tools.converter.converter\n"
        "import anakin_tpu_torch.tools.accuracy\n"
        "from anakin_tpu_torch.model_io import save_model, load_model\n"
        "g = pt.Graph('t'); g.add_input('x', (1, 3), 'float32')\n"
        "g.add_param('w', np.ones((3, 2), np.float32))\n"
        "g.add_node('d', 'dense', ['x', 'w'], ['y']); g.mark_output('y')\n"
        "d = tempfile.mkdtemp(); save_model(g, d)\n"
        "assert load_model(d).params['w'].tobytes() == g.params['w'].tobytes()\n"
        "bad = [m for m in sys.modules if m.startswith('google.protobuf') "
        "or m.split('.')[0] in ('yaml', 'safetensors', 'jax', 'anakin_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
