"""The port's MobileNet v1/v2 int8 slice end to end: 32 px, batch 2, full
widths, through the port's `Net` on the CPU, against the JAX package's `Net`
on the same graph with every eligible int8 node on its Pallas route
(interpret mode), the depthwise convs included.

Tolerances (`_check_edge`, shared with the ResNet slice), and why:
  * int8 edges: within 1 LSB.  Every int8 node of these nets is the same
    arithmetic on both sides (no strided dense conv takes the XLA route),
    so they are expected equal; 1 LSB is the bound the slices share.
  * bf16 edges: rtol 8e-3, atol 1e-4; each node is also held to the JAX
    node on the JAX node's own inputs, so that a difference cannot feed on
    itself.
  * float32 edges: rtol 1e-6 plus an atol of 1e-6 of the largest value (an
    FMA on the JAX side moves the last ulp).
  * the softmax: rtol 5e-3, atol 1e-4, and equal top-1.
"""

import os

import numpy as np
import pytest

import torch

import anakin_tpu as ak
from anakin_tpu.models import build_mobilenet_v1 as jax_build_mobilenet_v1
from anakin_tpu.models import build_mobilenet_v2 as jax_build_mobilenet_v2
from anakin_tpu.ops.quantized import _pallas_eligible
from anakin_tpu.quant import calibrate as jax_calibrate
from anakin_tpu.quant import quantize_graph as jax_quantize_graph
import anakin_tpu_torch as pt
from anakin_tpu_torch.convert import graph_from_jax, params_from_numpy
from anakin_tpu_torch.graph.ir import GraphBuilder, topological_order
from anakin_tpu_torch.models import build_mobilenet_v1, build_mobilenet_v2
from anakin_tpu_torch.ops import quantized as port_quantized
from anakin_tpu_torch.ops.quantized import conv_kind
from anakin_tpu_torch.quant import quantize_graph
from anakin_tpu_torch.runtime.net import build_forward

from test_torch_resnet import _check_edge, _f32

BUILDERS = {"v1": (jax_build_mobilenet_v1, build_mobilenet_v1),
            "v2": (jax_build_mobilenet_v2, build_mobilenet_v2)}
# routed int8 nodes per forward: (depthwise3x3_int8, matmul_int8)
ROUTES = {"v1": (13, 14), "v2": (17, 35)}


@pytest.fixture(scope="module", params=sorted(BUILDERS))
def case(request):
    """The JAX optimized graph, its quantized graph with the Pallas route
    forced where eligible, the input, the scales, and every edge of the
    JAX net per precision."""
    jax_build, _ = BUILDERS[request.param]
    g = ak.optimize(jax_build(batch=2, image_size=32))
    x = np.random.default_rng(11).normal(size=(2, 32, 32, 3)).astype(np.float32)
    scales = jax_calibrate(g, [{"input": x}], method="max")
    gq = jax_quantize_graph(g, scales)
    for node in gq.nodes.values():
        if node.op.endswith("_int8") and _pallas_eligible(node):
            node.attrs["impl"] = "pallas"
    edges = [e for n in ak.topological_order(gq) for e in n.outputs]
    old = os.environ.get("ANAKIN_PALLAS_INTERPRET")
    os.environ["ANAKIN_PALLAS_INTERPRET"] = "1"
    try:
        taps = {prec: {k: np.asarray(v) for k, v in
                       ak.Net(gq, precision=prec, tap_edges=edges)
                       .prediction({"input": x}).items()}
                for prec in ("fp32", "bf16")}
    finally:
        if old is None:
            del os.environ["ANAKIN_PALLAS_INTERPRET"]
        else:
            os.environ["ANAKIN_PALLAS_INTERPRET"] = old
    return dict(name=request.param, g=g, gq=gq, x=x, scales=scales,
                taps=taps)


def _assert_same_graph(got, want):
    """Node names, ops, edges, attrs (but the JAX route choice `impl`),
    precisions, scales, and byte-equal params."""
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


@pytest.mark.parametrize("skip_depthwise", [False, True])
def test_graph_matches_jax_package(case, skip_depthwise):
    """build_mobilenet_v{1,2} + optimize, then quantize_graph (with and
    without `skip_depthwise`), give the JAX package's graphs."""
    _, build = BUILDERS[case["name"]]
    got = pt.optimize(build(batch=2, image_size=32))
    _assert_same_graph(got, case["g"])
    assert got.precisions == {"conv2d_2": "fp32"}  # the s2d stem
    _assert_same_graph(
        quantize_graph(got, case["scales"], skip_depthwise=skip_depthwise),
        jax_quantize_graph(case["g"], case["scales"],
                           skip_depthwise=skip_depthwise))


def test_mobilenet_routes_to_the_kernels(case, monkeypatch):
    """One forward of the quantized net calls depthwise3x3_int8 13 (v1) /
    17 (v2) times and matmul_int8 14 / 35 times (the 1x1 convs and the
    classifier), conv3x3_int8 never; every grouped int8 node is "dw3x3"."""
    calls = {"depthwise3x3_int8": 0, "matmul_int8": 0, "conv3x3_int8": 0}
    for name in calls:
        real = getattr(port_quantized, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(port_quantized, name, counted)
    g = graph_from_jax(case["gq"])
    pt.Net(g, precision="bf16", device="cpu").prediction({"input": case["x"]})
    n_dw, n_mm = ROUTES[case["name"]]
    assert calls == {"depthwise3x3_int8": n_dw, "matmul_int8": n_mm,
                     "conv3x3_int8": 0}
    grouped = [conv_kind(n) for n in g.nodes.values()
               if n.op == "conv2d_int8" and int(n.attr("groups", 1)) > 1]
    assert grouped == ["dw3x3"] * n_dw


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_slice_matches_jax_net(case, precision):
    """The whole net on the port: softmax and top-1 against the JAX net;
    in fp32 every edge as well."""
    gq, x = case["gq"], case["x"]
    want = case["taps"][precision]
    edges = [e for n in topological_order(gq) for e in n.outputs]
    got = pt.Net(graph_from_jax(gq), precision=precision, device="cpu",
                 tap_edges=edges).prediction({"input": x})
    out = gq.outputs[0]
    g, w = got[out].float().numpy(), _f32(want[out])
    assert g.shape == (2, 1000) and np.isfinite(g).all()
    np.testing.assert_allclose(g, w, rtol=5e-3, atol=1e-4)
    np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
    if precision == "fp32":
        for e in edges:
            _check_edge(got[e], want[e], e)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_each_node_matches_jax_node(case, precision):
    """Every node of the port, run on the JAX net's values of its inputs,
    against the JAX net's value of its output."""
    gq, x = case["gq"], case["x"]
    taps = dict(case["taps"][precision], input=x)
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


@pytest.mark.parametrize("groups,cin", [(2, 8), (8, 8)])
def test_other_grouped_int8_conv_raises(groups, cin):
    """A grouped int8 conv outside the depthwise kernel's conditions (a
    grouped conv that is not depthwise, and a depthwise conv with a
    residual) raised NotImplementedError until the grouped route was
    ported; it now computes what the JAX package computes through XLA:
    int8 im2col of each group's channels, then matmul_int8 once per group,
    the output within 1e-6 of the largest value of the JAX net's."""
    import anakin_tpu as ak
    from anakin_tpu.graph.ir import GraphBuilder as JaxGraphBuilder

    rng = np.random.default_rng(3)
    w_val = rng.normal(size=(3, 3, cin // groups, cin)).astype(np.float32)

    def graph(builder):
        b = builder("grouped")
        x = b.input((1, 8, 8, cin))
        w = b.param(w_val)
        res = x if groups == cin else None
        y = b.op("conv2d", [x, w] + ([res] if res else []), strides=(1, 1),
                 padding=(1, 1), groups=groups, has_residual=res is not None)
        b.output(y)
        return b.finish(), x, y

    g, x, y = graph(GraphBuilder)
    gq = quantize_graph(g, {x: 0.02, y: 0.05})
    node = next(n for n in gq.nodes.values() if n.op == "conv2d_int8")
    assert conv_kind(node) == "dw3x3"
    jg, jx, jy = graph(JaxGraphBuilder)
    inp = rng.normal(size=(1, 8, 8, cin)).astype(np.float32)
    want = np.asarray(ak.Net(jax_quantize_graph(jg, {jx: 0.02, jy: 0.05}))
                      .prediction({"input": inp})[jy])
    got = pt.Net(gq, device="cpu").prediction({"input": inp})[y].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())