"""CNN breadth on the port: VGG16, GoogLeNet and ShuffleNet v1 (groups 3),
their ops (`lrn`, `dropout`, `concat`, `slice`, `shuffle_channel`,
`concat_int8`), the optional passes `horizontal_combine` and `stride_up`,
the grouped int8 conv route, `conv2d_w8` and `moe_ffn`, each against the
JAX package on the same graph and the same seeded inputs, on the CPU.

The nets run at batch 2 (VGG16 at 32 px, the other two at 64 px, where
their 32x downsampling still leaves 2 x 2), with every eligible int8 node of
the JAX graph on its Pallas route (interpret mode), as the other slices'
tests run them.

Tolerances, and why:
  * int8 edges of a float32 net: equal.  Every int8 node is the same
    arithmetic on both sides, the nodes the JAX package leaves to XLA
    (GoogLeNet's 7x7 stem and 5x5 convs, ShuffleNet's grouped 1x1 convs and
    stem) included, at these inputs; the bound the slices share is 1 LSB
    (the XLA route divides by out_scale where the kernels multiply by its
    reciprocal), and these nets do not use it.
  * bf16 nets: each node is held to the JAX node on the JAX node's own
    inputs (int8 within 1 LSB: the XLA route forms in_scale * w_scale in
    bf16, the kernels in float32, so a float output of such a node is
    within 2^-8 relative plus 2^-8 of the edge's largest value; bf16 within
    rtol 8e-3 / atol 1e-4).
  * float32 edges of the int8 nets: rtol 1e-6 plus an atol of 1e-6 of the
    largest value, as the other slices (an FMA on the JAX side).
  * the float32 nets: within 1e-5 of each edge's largest value: PyTorch's
    and XLA's float convolutions sum in other orders, and the difference
    carries through the layers.
  * the softmax: rtol 5e-3, atol 1e-4, and equal top-1; in bf16 nets with
    XLA-route nodes, the logits (the softmax's input) within 8e-2 of their
    largest value, and top-1 equal.
  * the grouped int8 convs alone: equal, with a power-of-two out_scale so
    that the XLA route's divide and the kernels' reciprocal multiply agree.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import anakin_tpu as ak
from anakin_tpu import models as jax_models
from anakin_tpu.graph.ir import GraphBuilder as JaxGraphBuilder
from anakin_tpu.graph.passes import horizontal_combine as jax_horizontal_combine
from anakin_tpu.graph.passes import stride_up as jax_stride_up
from anakin_tpu.ops.quantized import _pallas_eligible
from anakin_tpu.quant import calibrate as jax_calibrate
from anakin_tpu.quant import quantize_graph as jax_quantize_graph
from anakin_tpu.quant import weight_only_quantize as jax_weight_only_quantize
import anakin_tpu_torch as pt
from anakin_tpu_torch import models
from anakin_tpu_torch.convert import graph_from_jax, params_from_numpy
from anakin_tpu_torch.graph.ir import GraphBuilder, topological_order
from anakin_tpu_torch.graph.passes import horizontal_combine, stride_up
from anakin_tpu_torch.ops import quantized as port_quantized
from anakin_tpu_torch.ops.tensor import top_k_lower_index
from anakin_tpu_torch.ops.quantized import PreparedGroups
from anakin_tpu_torch.quant import quantize_graph, weight_only_quantize
from anakin_tpu_torch.runtime.net import build_forward

from test_torch_mobilenet import _assert_same_graph
from test_torch_ops import assert_close, run_both
from test_torch_resnet import _check_edge, _f32

# name -> (builder name, image size)
NETS = {"vgg16": ("build_vgg16", 32), "googlenet": ("build_googlenet", 64),
        "shufflenet_v1": ("build_shufflenet_v1", 64)}
# kernel launches of one int8 forward at these sizes
ROUTES = {
    "vgg16": dict(conv3x3_int8=13, matmul_int8=3),
    # 36 inception 1x1 + 1 + the 7x7 stem + 9 5x5 (im2col) + the classifier
    "googlenet": dict(conv3x3_int8=10, matmul_int8=47),
    # 1 + 3 in the first unit, 6 in each of the 15 others, the classifier
    "shufflenet_v1": dict(depthwise3x3_int8=16, matmul_int8=95),
}
SOFT_RTOL, SOFT_ATOL = 5e-3, 1e-4
# float nets: PyTorch's and XLA's float32 convolutions sum in other orders
# (a 5 x 5 x 48 or 7 x 7 x 3 reduction moves the last bits) and the
# difference carries through up to 22 layers
FLOAT_NET_RTOL = 1e-5
# the logits of bf16 int8 nets with XLA-route nodes on the JAX side (see
# test_int8_net_matches_jax_net), relative to their largest value: measured
# 0.029-0.032 (GoogLeNet) and 0.051-0.054 (ShuffleNet) over input seeds
# 11-13; a softmax held in absolute terms says nothing here, since
# GoogLeNet's random-weight entries are about 1e-3 and ShuffleNet's
# logits (about 2e5) make it one-hot
BF16_XLA_LOGIT_RTOL = 8e-2
# a float output of such a node in a bf16 net: the bf16 rounding of the
# scale, 2^-9 relative to acc * scale, which the bias can cancel down to an
# output near 0 (so also an atol of that much of the edge's largest value)
BF16_XLA_SCALE_RTOL = 2.0 ** -8


def _interpret(fn):
    old = os.environ.get("ANAKIN_PALLAS_INTERPRET")
    os.environ["ANAKIN_PALLAS_INTERPRET"] = "1"
    try:
        return fn()
    finally:
        if old is None:
            del os.environ["ANAKIN_PALLAS_INTERPRET"]
        else:
            os.environ["ANAKIN_PALLAS_INTERPRET"] = old


def _taps(graph, x, precision):
    edges = [e for n in ak.topological_order(graph) for e in n.outputs]
    return _interpret(lambda: {
        k: np.asarray(v) for k, v in
        ak.Net(graph, precision=precision, tap_edges=edges)
        .prediction({"input": x}).items()})


@pytest.fixture(scope="module", params=sorted(NETS))
def case(request):
    """The JAX optimized float graph, its quantized graph with the Pallas
    route forced where eligible, the input, the scales, and every edge of
    the JAX int8 net per precision and of the float net."""
    fn, size = NETS[request.param]
    g = ak.optimize(getattr(jax_models, fn)(batch=2, image_size=size))
    x = np.random.default_rng(11).normal(size=(2, size, size, 3)).astype(
        np.float32)
    scales = jax_calibrate(g, [{"input": x}], method="max")
    gq = jax_quantize_graph(g, scales)
    for node in gq.nodes.values():
        if node.op.endswith("_int8") and _pallas_eligible(node):
            node.attrs["impl"] = "pallas"
    return dict(name=request.param, size=size, g=g, gq=gq, x=x,
                scales=scales, float_taps=_taps(g, x, "fp32"),
                taps={p: _taps(gq, x, p) for p in ("fp32", "bf16")})


def test_graph_matches_jax_package(case):
    """The builder alone, then `optimize`, then `quantize_graph` give the
    JAX package's graphs node for node and byte for byte."""
    fn, size = NETS[case["name"]]
    raw = getattr(models, fn)(batch=2, image_size=size)
    _assert_same_graph(raw, getattr(jax_models, fn)(batch=2, image_size=size))
    got = pt.optimize(raw)
    _assert_same_graph(got, case["g"])
    _assert_same_graph(quantize_graph(got, case["scales"]),
                       jax_quantize_graph(case["g"], case["scales"]))


def _check_float_net_edge(got, want, what):
    np.testing.assert_allclose(got.float().numpy(), _f32(want), rtol=0,
                               atol=FLOAT_NET_RTOL * np.abs(_f32(want)).max(),
                               err_msg=what)


def test_float_net_matches_jax_net(case):
    """The float32 net, every edge within FLOAT_NET_RTOL of the edge's
    largest value, and the softmax within its tolerance."""
    g = graph_from_jax(case["g"])
    edges = [e for n in topological_order(g) for e in n.outputs]
    got = pt.Net(g, device="cpu", tap_edges=edges).prediction(
        {"input": case["x"]})
    for e in edges:
        _check_float_net_edge(got[e], case["float_taps"][e], e)
    out = g.outputs[0]
    np.testing.assert_allclose(got[out].numpy(), case["float_taps"][out],
                               rtol=SOFT_RTOL, atol=SOFT_ATOL)


def test_int8_net_routes_to_the_kernels(case, monkeypatch):
    """One int8 forward launches each kernel the counted number of times
    (the grouped 1x1 convs once per group), and the `Net` prepared one
    weight copy per group of every grouped conv when it was built."""
    calls = {}
    for name in ("matmul_int8", "conv3x3_int8", "depthwise3x3_int8"):
        real = getattr(port_quantized, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(port_quantized, name, counted)
    g = graph_from_jax(case["gq"])
    net = pt.Net(g, precision="bf16", device="cpu")
    net.prediction({"input": case["x"]})
    assert calls == ROUTES[case["name"]]
    for node in g.nodes.values():
        groups = int(node.attr("groups", 1))
        if node.op == "conv2d_int8" and groups > 1 and node.name in net.prepared:
            p = net.prepared[node.name]
            assert isinstance(p, PreparedGroups) and len(p.parts) == groups


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_int8_net_matches_jax_net(case, precision):
    """The whole int8 net: softmax and top-1; in fp32 every edge, the int8
    ones equal.  In bf16, VGG16's int8 nodes all take the Pallas route on
    the JAX side and its softmax is held to the usual tolerance; GoogLeNet's
    and ShuffleNet's XLA-route nodes form in_scale * w_scale in bf16 (the
    port in float32), a difference the layers after them grow, so there the
    logits are held within BF16_XLA_LOGIT_RTOL of their largest value, and
    top-1 equal (each node is held to the JAX node in
    `test_each_bf16_node_matches_jax_node`)."""
    gq = case["gq"]
    want = case["taps"][precision]
    edges = [e for n in topological_order(gq) for e in n.outputs]
    got = pt.Net(graph_from_jax(gq), precision=precision, device="cpu",
                 tap_edges=edges).prediction({"input": case["x"]})
    out = gq.outputs[0]
    g, w = got[out].float().numpy(), _f32(want[out])
    assert g.shape == (2, 1000) and np.isfinite(g).all()
    if precision == "bf16" and case["name"] != "vgg16":
        softmax = next(n for n in gq.nodes.values() if out in n.outputs)
        assert softmax.op == "softmax"
        gl = got[softmax.inputs[0]].float().numpy()
        wl = _f32(want[softmax.inputs[0]])
        np.testing.assert_allclose(
            gl, wl, rtol=0, atol=BF16_XLA_LOGIT_RTOL * np.abs(wl).max())
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
        np.testing.assert_array_equal(gl.argmax(-1), wl.argmax(-1))
        return
    np.testing.assert_allclose(g, w, rtol=SOFT_RTOL, atol=SOFT_ATOL)
    np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
    if precision == "fp32":
        for e in edges:
            if want[e].dtype == np.int8:
                np.testing.assert_array_equal(got[e].numpy(), want[e],
                                              err_msg=e)
            else:
                _check_edge(got[e], want[e], e)


def test_each_bf16_node_matches_jax_node(case):
    """Every node of the bf16 int8 net, run on the JAX net's values of its
    inputs, against the JAX net's value of its output; the float output of
    an int8 conv that the JAX package runs through XLA within one bf16 ulp
    of the scale (BF16_XLA_SCALE_RTOL)."""
    gq, x = case["gq"], case["x"]
    taps = dict(case["taps"]["bf16"], input=x)
    g = graph_from_jax(gq)
    net = pt.Net(g, precision="bf16", device="cpu")
    for node in topological_order(g):
        fwd, _ = build_forward(g, "bf16", start_from=node.name,
                               stop_at=node.name)
        feed = params_from_numpy(
            {e: taps[e] for e in node.inputs if e not in g.params}, "cpu")
        with torch.inference_mode():
            y = fwd(net.params, feed, net.prepared)[node.outputs[0]]
        want = taps[node.outputs[0]]
        if (node.op == "conv2d_int8" and node.attr("impl") != "pallas"
                and want.dtype == np.float32):
            np.testing.assert_allclose(
                y.numpy(), want, rtol=BF16_XLA_SCALE_RTOL,
                atol=BF16_XLA_SCALE_RTOL * np.abs(want).max(),
                err_msg=node.name)
        else:
            _check_edge(y, want, node.name)


# ------------------------------------------------------------ the passes


def test_horizontal_combine_matches_jax_package():
    """GoogLeNet's sibling 1x1 convs merged into one wide conv and a
    `slice`: the JAX pass's graph, and the combined float net equal to the
    uncombined one."""
    g = ak.optimize(jax_models.build_googlenet(batch=2, image_size=64))
    want = jax_horizontal_combine(g)
    got = horizontal_combine(graph_from_jax(g))
    _assert_same_graph(got, want)
    assert "horizontal_combine" in got.applied_passes
    n_slice = sum(n.op == "slice" for n in got.nodes.values())
    assert n_slice == 9  # one per inception block
    x = np.random.default_rng(5).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    edges = [e for n in topological_order(got) for e in n.outputs]
    y = pt.Net(got, device="cpu", tap_edges=edges).prediction({"input": x})
    y0 = pt.Net(graph_from_jax(g), device="cpu").prediction({"input": x})
    jy = ak.Net(want, tap_edges=edges).prediction({"input": x})
    out = got.outputs[0]
    _check_float_net_edge(y[out], np.asarray(y0[out]), "combined vs uncombined")
    for e in edges:
        _check_float_net_edge(y[e], np.asarray(jy[e]), e)


def _stride_up_graph(builder):
    """conv 3x3 s1 -> relu -> dropout -> conv 1x1 s2: the chain the pass
    rewrites, with a second branch the pass must leave alone."""
    rng = np.random.default_rng(4)
    b = builder("su")
    x = b.input((2, 16, 16, 8))
    w1 = b.param(rng.normal(size=(3, 3, 8, 16)).astype(np.float32) * 0.2)
    y = b.op("conv2d", [x, w1], strides=(1, 1), padding=(1, 1))
    y = b.op("activation", [y], activation="relu")
    y = b.op("dropout", [y], ratio=0.5, scale=1.0)
    w2 = b.param(rng.normal(size=(1, 1, 16, 12)).astype(np.float32) * 0.2)
    y = b.op("conv2d", [y, w2], strides=(2, 2), padding=(0, 0))
    w3 = b.param(rng.normal(size=(1, 1, 8, 4)).astype(np.float32) * 0.2)
    z = b.op("conv2d", [x, w3], strides=(2, 2), padding=(0, 0))
    b.output(y, z)
    return b.finish()


def test_stride_up_matches_jax_package():
    """The stride moves up the pointwise chain to the 3x3 conv, as the JAX
    pass moves it; the output equals the unrewritten graph's."""
    want = jax_stride_up(_stride_up_graph(JaxGraphBuilder))
    g0 = _stride_up_graph(GraphBuilder)
    got = stride_up(g0)
    _assert_same_graph(got, want)
    assert "stride_up" in got.applied_passes
    assert [tuple(n.attr("strides")) for n in got.nodes.values()
            if n.op == "conv2d"] == [(2, 2), (1, 1), (2, 2)]
    x = np.random.default_rng(6).normal(size=(2, 16, 16, 8)).astype(
        np.float32)
    y = pt.Net(got, device="cpu").prediction({"input": x})
    y0 = pt.Net(g0, device="cpu").prediction({"input": x})
    jy = ak.Net(want).prediction({"input": x})
    for e in got.outputs:
        _check_float_net_edge(y[e], np.asarray(y0[e]), e)
        _check_float_net_edge(y[e], np.asarray(jy[e]), e)


# ------------------------------------------------------------------ ops


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("size,alpha,beta,k", [(5, 1e-4, 0.75, 1.0),
                                               (3, 2e-2, 0.5, 2.0),
                                               (4, 1e-1, 0.75, 1.0)])
def test_lrn(dtype, size, alpha, beta, k):
    x = np.random.default_rng(1).normal(size=(2, 5, 6, 16)).astype(
        np.float32) * 4
    assert_close(run_both("lrn", [x], dtype, local_size=size, alpha=alpha,
                          beta=beta, k=k)[0], dtype)


@pytest.mark.parametrize("scale", [1.0, 0.5])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_dropout(scale, dtype):
    x = np.random.default_rng(2).normal(size=(3, 17)).astype(np.float32)
    assert_close(run_both("dropout", [x], dtype, ratio=0.5, scale=scale)[0],
                 dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_concat_slice_shuffle(dtype):
    """concat, slice (at points and into equal sections) and
    shuffle_channel, on float and int8 tensors: they move values, so
    equal."""
    rng = np.random.default_rng(3)

    def arr(*shape):
        if dtype == "int8":
            return rng.integers(-127, 128, size=shape).astype(np.int8)
        return rng.normal(size=shape).astype(np.float32)

    a, b, c = arr(2, 4, 4, 6), arr(2, 4, 4, 9), arr(2, 4, 4, 3)
    d = "fp32" if dtype == "int8" else dtype
    for got, want in run_both("concat", [a, b, c], d, axis=3):
        np.testing.assert_array_equal(got, want)
    x = arr(2, 4, 4, 18)
    pairs = run_both("slice", [x], d, axis=3, slice_points=[6, 15])
    assert [p[0].shape[-1] for p in pairs] == [6, 9, 3]
    from anakin_tpu.graph.ir import Node as JaxNode
    from anakin_tpu.ops import get_op as jax_get_op
    from anakin_tpu_torch.graph.ir import Node
    from anakin_tpu_torch.ops import get_op
    for got, want in pairs:
        np.testing.assert_array_equal(got, want)
    # equal sections: the outputs' count decides them
    jn = JaxNode("n", "slice", ["i0"], ["o0", "o1", "o2"], dict(axis=-1))
    pn = Node("n", "slice", ["i0"], ["o0", "o1", "o2"], dict(axis=-1))
    want = jax_get_op("slice")(jn, [jnp.asarray(x)])
    got = get_op("slice")(pn, [torch.from_numpy(x)])
    for gt, w in zip(got, want):
        np.testing.assert_array_equal(gt.numpy(), np.asarray(w))
    for got, want in run_both("shuffle_channel", [x], d, group=3):
        np.testing.assert_array_equal(got, want)


def test_concat_int8_requantizes_to_the_out_scale():
    """Operands at the out scale pass as they are; the others are
    requantized through the op path's divide, as in the JAX op."""
    rng = np.random.default_rng(4)
    xs = [rng.integers(-127, 128, size=(2, 3, 3, c)).astype(np.int8)
          for c in (4, 5, 6)]
    (pair,) = run_both("concat_int8", xs, axis=3, out_scale=0.05,
                       in_scales=[0.05, 0.031, 0.077])
    np.testing.assert_array_equal(*pair)
    assert pair[0].dtype == np.int8


# ------------------------------------------------------ grouped int8 route


def _grouped_graph(builder, cin, cout, groups, k, stride, pad, residual):
    """x -> the grouped conv (bias, relu) -> y -> a 1x1 conv -> z: the 1x1
    conv takes y as int8 when y has a scale, so y is then requantized."""
    rng = np.random.default_rng(groups * 10 + k)
    b = builder("grouped")
    x = b.input((2, 9, 10, cin))
    w = b.param(rng.normal(size=(k, k, cin // groups, cout)).astype(
        np.float32) * 0.3)
    bias = b.param(rng.normal(size=(cout,)).astype(np.float32) * 0.1)
    res = [x] if residual else []
    y = b.op("conv2d", [x, w, bias] + res, strides=(stride, stride),
             padding=(pad, pad), groups=groups, has_bias=True,
             has_residual=residual, activation="relu")
    w2 = b.param(rng.normal(size=(1, 1, cout, 4)).astype(np.float32) * 0.3)
    z = b.op("conv2d", [y, w2], strides=(1, 1), padding=(0, 0))
    b.output(z)
    return b.finish(), x, y


GROUPED = {
    "1x1_groups3": dict(cin=12, cout=24, groups=3, k=1, stride=1, pad=0,
                        residual=False),
    "1x1_groups3_residual": dict(cin=12, cout=12, groups=3, k=1, stride=1,
                                 pad=0, residual=True),
    "3x3_groups2": dict(cin=8, cout=12, groups=2, k=3, stride=1, pad=1,
                        residual=False),
    "3x3_groups2_stride2": dict(cin=8, cout=8, groups=2, k=3, stride=2,
                                pad=1, residual=False),
    "depthwise3x3_residual": dict(cin=8, cout=8, groups=8, k=3, stride=1,
                                  pad=1, residual=True),
    "depthwise5x5": dict(cin=8, cout=8, groups=8, k=5, stride=1, pad=2,
                         residual=False),
    "depthwise3x3_pad0": dict(cin=8, cout=8, groups=8, k=3, stride=1, pad=0,
                              residual=False),
}


@pytest.mark.parametrize("out", ["int8", "float32"])
@pytest.mark.parametrize("name", sorted(GROUPED))
def test_grouped_int8_conv_matches_jax_xla_route(name, out, monkeypatch):
    """Every grouped int8 conv that is not the depthwise kernel's goes to
    `matmul_int8` once per group (a 1x1 s1 p0 conv on the group's channel
    slice, any other through int8 im2col of the group's channels) and
    equals the JAX package's XLA route: int8 outputs equal (out_scale a
    power of two), float32 outputs within 1e-6 of the largest."""
    cfg = GROUPED[name]
    jg, x_e, y_e = _grouped_graph(JaxGraphBuilder, **cfg)
    scales = {x_e: 0.03} if out == "float32" else {x_e: 0.03, y_e: 0.0625}
    jq = jax_quantize_graph(jg, scales)
    node = next(n for n in jq.nodes.values() if n.op == "conv2d_int8")
    assert (node.attr("out_scale") is not None) == (out == "int8")
    assert node.attr("has_residual") == cfg["residual"]
    x = np.random.default_rng(8).normal(size=(2, 9, 10, cfg["cin"])).astype(
        np.float32)
    want = ak.Net(jq, tap_edges=[y_e]).prediction({"input": x})  # XLA route
    calls = []
    real = port_quantized.matmul_int8
    monkeypatch.setattr(port_quantized, "matmul_int8",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    g = graph_from_jax(jq)
    _assert_same_graph(quantize_graph(_grouped_graph(GraphBuilder, **cfg)[0],
                                      scales), jq)
    for prepared in (True, False):
        net = pt.Net(g, device="cpu", tap_edges=[y_e])
        if not prepared:
            net.prepared = {}
        got = net.prediction({"input": x})
        o = y_e
        w = np.asarray(want[o])
        if out == "int8":
            np.testing.assert_array_equal(got[o].numpy(), w)
        else:
            np.testing.assert_allclose(got[o].numpy(), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max())
    # the grouped conv once per group, the 1x1 conv once when it is int8
    assert len(calls) == 2 * (cfg["groups"] + (out == "int8"))


# ------------------------------------------------------------- conv2d_w8


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_conv2d_w8_net_matches_jax_net(precision):
    """`weight_only_quantize(bits=8)` of a ResNet-50 at 32 px writes
    conv2d_w8 and dense_w8 nodes, and the port's `Net` runs it: the JAX
    rewrite's graph, and the output within rtol 1e-5 (fp32; the float
    convolutions sum in other orders) or 2e-2 of the largest (bf16, as the
    LLM slice's bf16 net)."""
    jg = ak.optimize(jax_models.build_resnet50(batch=2, image_size=32))
    jw = jax_weight_only_quantize(jg, bits=8)
    g = weight_only_quantize(pt.optimize(models.build_resnet50(
        batch=2, image_size=32)), bits=8)
    _assert_same_graph(g, jw)
    ops = {n.op for n in g.nodes.values()}
    assert {"conv2d_w8", "dense_w8"} <= ops
    x = np.random.default_rng(9).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(ak.Net(jw, precision=precision).prediction(
        {"input": x})[jw.outputs[0]]).astype(np.float32)
    got = pt.Net(g, precision=precision, device="cpu").prediction(
        {"input": x})[g.outputs[0]].float().numpy()
    if precision == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("groups,stride,pad,bias,residual,act", [
    (1, 1, 1, True, False, "relu"),
    (1, 2, 3, False, False, None),
    (4, 1, 1, True, True, "relu6"),
    (1, 1, "SAME", True, False, None),
])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_conv2d_w8_op(groups, stride, pad, bias, residual, act, dtype):
    rng = np.random.default_rng(10)
    cin, cout = 8, 8
    x = rng.normal(size=(2, 7, 9, cin)).astype(np.float32)
    w_q = rng.integers(-127, 128, size=(3, 3, cin // groups, cout)).astype(
        np.int8)
    ws = (rng.random(cout) * 0.01 + 0.001).astype(np.float32)
    ins = [x, w_q, ws]
    if bias:
        ins.append(rng.normal(size=(cout,)).astype(np.float32))
    if residual:
        ins.append(rng.normal(size=(2, 7, 9, cout)).astype(np.float32))
    pad = pad if isinstance(pad, str) else (pad, pad)
    (pair,) = run_both("conv2d_w8", ins, dtype, strides=(stride, stride),
                       padding=pad, groups=groups, has_bias=bias,
                       has_residual=residual, activation=act)
    assert_close(pair, dtype)


# --------------------------------------------------------------- moe_ffn


@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("top_k", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_moe_ffn(act, top_k, dtype):
    """The port's moe_ffn against the JAX op: the tanh GELU
    (`jax.nn.gelu`'s default), float32 inside, rtol 1e-5 (bf16: one ulp)."""
    rng = np.random.default_rng(12)
    B, S, E, F, n = 2, 5, 16, 24, 4
    ins = [rng.normal(size=(B, S, E)).astype(np.float32),
           rng.normal(size=(E, n)).astype(np.float32),
           rng.normal(size=(n, E, F)).astype(np.float32) * 0.3,
           rng.normal(size=(n, F, E)).astype(np.float32) * 0.3]
    (pair,) = run_both("moe_ffn", ins, dtype, top_k=top_k, activation=act)
    assert_close(pair, dtype)


def test_moe_ffn_breaks_ties_toward_the_lower_expert():
    """Tied router logits (duplicate gate columns) pick the lower expert
    index, as `lax.top_k` does; the gelu is the tanh approximation, not the
    erf one."""
    rng = np.random.default_rng(13)
    E, F = 8, 6
    wg = rng.normal(size=(E, 2)).astype(np.float32)
    w_gate = np.concatenate([wg, wg, wg], axis=1)  # j ties j + 2 and j + 4
    ins = [rng.normal(size=(1, 3, E)).astype(np.float32), w_gate,
           rng.normal(size=(6, E, F)).astype(np.float32),
           rng.normal(size=(6, F, E)).astype(np.float32)]
    (pair,) = run_both("moe_ffn", ins, top_k=2, activation="gelu")
    assert_close(pair)
    logits = torch.tensor([[3.0, 1.0, 3.0, 3.0, 0.0]])
    vals, idx = top_k_lower_index(logits, 3)
    assert idx.tolist() == [[0, 2, 3]] and vals.tolist() == [[3.0, 3.0, 3.0]]
    x = torch.linspace(-3, 3, 13)
    from anakin_tpu_torch.ops.nn import apply_activation
    gelu = apply_activation(x, "gelu")
    assert torch.equal(gelu, torch.nn.functional.gelu(x, approximate="tanh"))
    assert not torch.equal(gelu, torch.nn.functional.gelu(x))
