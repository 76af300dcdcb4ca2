"""The port's slice end to end: ResNet-50 int8 at 32 px, batch 2, through the
port's `Net` on the CPU, against the JAX package's `Net` on the same graph
with every eligible int8 node on its Pallas route (interpret mode).

Tolerances, and why:
  * int8 edges: within 1 LSB.  The only int8 nodes that are not the same
    arithmetic on both sides are the strided convs, which the JAX package
    runs through XLA (divide by out_scale; in a bf16 net also
    in_scale * w_scale formed in bf16) and the port through its im2col GEMM.
  * In bf16 such a one-LSB difference feeds the next layers, so there each
    node is held to the JAX node on the JAX node's own inputs.  In fp32 the
    whole net is compared edge by edge.
  * the softmax: rtol 5e-3, atol 1e-4 (the JAX package's own precedent for
    Pallas against XLA), and equal top-1.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import torch

import anakin_tpu as ak
from anakin_tpu.models import build_resnet50 as jax_build_resnet50
from anakin_tpu.ops.quantized import _pallas_eligible
from anakin_tpu.quant import calibrate
from anakin_tpu.quant import quantize_graph as jax_quantize_graph
from anakin_tpu.quant import read_scale_table as jax_read_scale_table
import anakin_tpu_torch as pt
from anakin_tpu_torch.convert import graph_from_jax, params_from_numpy
from anakin_tpu_torch.graph.ir import topological_order
from anakin_tpu_torch.models import build_resnet50
from anakin_tpu_torch.ops.quantized import conv_kind
from anakin_tpu_torch.quant import (quantize_graph, read_scale_table,
                                    write_scale_table)
from anakin_tpu_torch.runtime.net import build_forward

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def slice_case():
    """The JAX quantized graph (Pallas route forced where eligible), the
    input, and the scales it was quantized with."""
    g = ak.optimize(jax_build_resnet50(batch=2, image_size=32))
    x = np.random.default_rng(7).normal(size=(2, 32, 32, 3)).astype(np.float32)
    scales = calibrate(g, [{"input": x}], method="max")
    gq = jax_quantize_graph(g, scales)
    for node in gq.nodes.values():
        if node.op.endswith("_int8") and _pallas_eligible(node):
            node.attrs["impl"] = "pallas"
    return gq, x, scales


@pytest.fixture(scope="module")
def jax_taps(slice_case):
    """Every edge of the JAX net, per precision."""
    gq, x, _ = slice_case
    edges = [e for n in ak.topological_order(gq) for e in n.outputs]
    old = os.environ.get("ANAKIN_PALLAS_INTERPRET")
    os.environ["ANAKIN_PALLAS_INTERPRET"] = "1"
    try:
        return {prec: {k: np.asarray(v) for k, v in
                       ak.Net(gq, precision=prec, tap_edges=edges)
                       .prediction({"input": x}).items()}
                for prec in ("fp32", "bf16")}
    finally:
        if old is None:
            del os.environ["ANAKIN_PALLAS_INTERPRET"]
        else:
            os.environ["ANAKIN_PALLAS_INTERPRET"] = old


def _f32(a):
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _check_edge(got: torch.Tensor, want: np.ndarray, what: str):
    assert str(got.dtype).endswith(want.dtype.name), (what, got.dtype, want.dtype)
    if want.dtype == np.int8:
        d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1, (what, d.max())
    else:
        g, w = got.float().numpy(), _f32(want)
        if want.dtype.name == "bfloat16":
            np.testing.assert_allclose(g, w, rtol=8e-3, atol=1e-4, err_msg=what)
        else:  # float32: an FMA on the JAX side moves the last ulp
            np.testing.assert_allclose(g, w, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(w).max()),
                                       err_msg=what)


def test_graph_matches_jax_package(slice_case):
    """build_resnet50 + optimize + quantize_graph give the JAX package's
    graph: node names, ops, edges, attrs, precisions, scales, and
    byte-equal params."""
    want, _, scales = slice_case
    got = quantize_graph(pt.optimize(build_resnet50(batch=2, image_size=32)),
                         scales)
    assert list(got.nodes) == list(want.nodes)
    for name, n in got.nodes.items():
        w = want.nodes[name]
        attrs = {k: v for k, v in w.attrs.items() if k != "impl"}
        assert (n.op, n.inputs, n.outputs, n.attrs) == (w.op, w.inputs,
                                                        w.outputs, attrs), name
    assert (got.inputs, got.outputs, got.input_specs, got.precisions,
            got.scales) == (want.inputs, want.outputs, want.input_specs,
                            want.precisions, want.scales)
    assert sorted(got.params) == sorted(want.params)
    for k, v in got.params.items():
        assert v.dtype == want.params[k].dtype and v.shape == want.params[k].shape
        assert v.tobytes() == want.params[k].tobytes(), k


def test_resnet50_routes_to_the_two_kernels():
    """At the bench configuration the int8 nodes split 33 + 6 + 1 onto
    matmul_int8 (1x1 s1, strided via im2col, the classifier) and 13 onto
    conv3x3_int8: 40 and 13 launches per forward."""
    scales = read_scale_table(os.path.join(ROOT, "artifacts",
                                           "resnet50_seed0_scales.txt"))
    g = quantize_graph(pt.optimize(build_resnet50(batch=1, image_size=64)),
                       scales)
    kinds = [conv_kind(n) if n.op == "conv2d_int8" else n.op
             for n in g.nodes.values() if n.op.endswith("_int8")]
    assert kinds.count("gemm") == 33 and kinds.count("other") == 6
    assert kinds.count("dense_int8") == 1 and kinds.count("conv3x3") == 13


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_slice_matches_jax_net(slice_case, jax_taps, precision):
    """The whole net on the port: softmax and top-1 against the JAX net;
    in fp32 every int8 edge as well."""
    gq, x, _ = slice_case
    want = jax_taps[precision]
    edges = [e for n in topological_order(gq) for e in n.outputs]
    got = pt.Net(graph_from_jax(gq), precision=precision, device="cpu",
                 tap_edges=edges).prediction({"input": x})
    out = gq.outputs[0]
    g, w = got[out].float().numpy(), _f32(want[out])
    assert g.shape == (2, 1000) and np.isfinite(g).all()
    np.testing.assert_allclose(g, w, rtol=5e-3, atol=1e-4)
    np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
    if precision == "fp32":
        n_int8 = 0
        for e in edges:
            if want[e].dtype == np.int8:
                _check_edge(got[e], want[e], e)
                n_int8 += 1
        assert n_int8 == 53  # stem requant, pool, 51 convs (the last is float)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_each_node_matches_jax_node(slice_case, jax_taps, precision):
    """Every node of the port, run on the JAX net's values of its inputs,
    against the JAX net's value of its output."""
    gq, x, _ = slice_case
    taps = dict(jax_taps[precision], input=x)
    g = graph_from_jax(gq)
    net = pt.Net(g, precision=precision, device="cpu")
    for node in topological_order(g):
        fwd, _ = build_forward(g, precision, start_from=node.name,
                               stop_at=node.name)
        feed = params_from_numpy(
            {e: taps[e] for e in node.inputs if e not in g.params}, "cpu")
        with torch.inference_mode():
            y = fwd(net.params, feed)[node.outputs[0]]
        _check_edge(y, taps[node.outputs[0]], node.name)


def test_net_defaults_to_cuda():
    """With no device, Net runs on CUDA, and without a GPU it raises
    instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is usable")
    g = build_resnet50(batch=1, image_size=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.Net(g)


def test_optimize_refuses_autotune():
    """`optimize(autotune=True)` times on CUDA unless asked for the CPU, so
    without a GPU it refuses as `Net` does (it raised NotImplementedError
    until the autotuner was ported); ResNet-50 has no node to tune, so on a
    GPU it returns the optimized graph, marked as tuned."""
    g = build_resnet50(batch=1, image_size=32)
    if torch.cuda.is_available():
        assert "autotune" in pt.optimize(g, autotune=True).applied_passes
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            pt.optimize(g, autotune=True)


def test_scale_table_io_matches_jax_package(tmp_path):
    path = os.path.join(ROOT, "artifacts", "resnet50_seed0_scales.txt")
    scales = read_scale_table(path)
    assert scales == jax_read_scale_table(path) and len(scales) > 50
    out = str(tmp_path / "scales.txt")
    write_scale_table(scales, out)
    assert jax_read_scale_table(out) == read_scale_table(out)


def test_port_imports_no_jax():
    """Every module of the port, found by walking the package (so a new
    module is covered without naming it here), imports in a fresh
    interpreter without pulling in JAX or the JAX package."""
    code = ("import importlib, pkgutil, sys, anakin_tpu_torch as p; "
            "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
            "'anakin_tpu_torch.')]; "
            "[importlib.import_module(m) for m in mods]; "
            "assert len(mods) >= 30, mods; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'anakin_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
