"""The port's sequence ops (`ops/sequence.py`) and RNN nets
(`models/lstm_lm.py`: the LSTM language model, the BiLSTM text classifier
and the BiGRU-CRF tagger) against the JAX package, on the same `Node` or
`Graph` and the same seeded inputs, on the CPU.

The nets run at batch 2, T 8, vocab 50, embed 16, hidden 16 (two LSTM layers
in the language model), with lengths 8 and 3.  Their int8 graphs hold one
int8 dense each, the output projection; on the JAX side it is forced onto
its Pallas route in interpret mode, as the other slices' tests run it.

Tolerances, and why:
  * the RNN ops in float32: rtol 1e-5, atol 1e-5 — the port hoists the
    input product out of the time loop (one [B T, D] x [D, G H] product,
    where the reference multiplies step by step), so only the order of sums
    changes, and the two libraries' sigmoid and tanh may part in the last
    ulp; the difference carries through T steps;
  * bf16 outputs: rtol 8e-3, atol 1e-2 — one bf16 ulp (2**-8) after such
    sums (`tests/test_torch_ops.py`);
  * label paths (`crf_decoding`), selections, masks, reversals: equal;
  * the nets: float32 edges within 1e-5 of each edge's largest value (the
    RNN differences above, carried through two layers and the softmax);
    bf16 edges within rtol 8e-3 / atol 1e-4 of a value that is itself in
    bf16, as the other slices' bf16 nets; int8 edges equal; the NER tags
    equal.  An int8 net's projection quantizes its float input itself, so
    a last-bit difference of the RNN output can move one element by 1 LSB
    (seen at the LM's float32 int8 net): there each node is held on the JAX
    node's own inputs, and the whole net's softmax within rtol 5e-3 / atol
    1e-4 with top-1 equal, the CNN slices' tolerance.
"""

import os

import numpy as np
import pytest

import torch

import anakin_tpu as ak
from anakin_tpu import models as jax_models
from anakin_tpu.graph.shape_infer import infer_shapes as jax_infer_shapes
from anakin_tpu.ops.quantized import _pallas_eligible
from anakin_tpu.quant import calibrate as jax_calibrate
from anakin_tpu.quant import quantize_graph as jax_quantize_graph
import anakin_tpu_torch as pt
from anakin_tpu_torch import models
from anakin_tpu_torch.convert import graph_from_jax, params_from_numpy
from anakin_tpu_torch.graph.ir import topological_order
from anakin_tpu_torch.graph.shape_infer import infer_shapes
from anakin_tpu_torch.ops import quantized as port_quantized
from anakin_tpu_torch.quant import calibrate, quantize_graph
from anakin_tpu_torch.runtime.net import build_forward

from test_torch_detection import _NoHostSync
from test_torch_mobilenet import _assert_same_graph
from test_torch_ops import assert_close, run_both
from test_torch_resnet import _f32

DTYPES = ["fp32", "bf16"]
B, T, D, H = 3, 6, 5, 4
# lengths with a full row and a 0, or none
LENGTHS = {"full_zero_mid": np.array([T, 0, 3], np.int32), "none": None}


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _equal(pair):
    np.testing.assert_array_equal(*pair)


# ------------------------------------------------------------- the RNNs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lengths", sorted(LENGTHS))
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("op,gates", [("lstm", 4), ("gru", 3),
                                      ("standard_rnn", 3)])
@pytest.mark.parametrize("bias", [True, False])
def test_lstm_and_gru(rng, op, gates, dtype, lengths, reverse, bias):
    """Masked steps carry the state forward, outputs past the length are
    zero; `reverse` flips x, scans it with the unflipped mask and flips the
    outputs back, as the reference does."""
    lens = LENGTHS[lengths]
    ins = [_normal(rng, B, T, D), _normal(rng, D, gates * H, scale=0.5),
           _normal(rng, H, gates * H, scale=0.5)]
    if bias:
        ins.append(_normal(rng, gates * H, scale=0.1))
    if lens is not None:
        ins.append(lens)
    (pair,) = run_both(op, ins, dtype, has_bias=bias,
                       has_lengths=lens is not None, reverse=reverse)
    assert_close(pair, dtype)
    if lens is not None:
        assert not pair[0][1].any() and not pair[0][2, 3:].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lengths", sorted(LENGTHS))
@pytest.mark.parametrize("reverse", [False, True])
def test_lstmp(rng, dtype, lengths, reverse):
    """`reverse` is not read, as in the reference."""
    lens, P = LENGTHS[lengths], 3
    ins = [_normal(rng, B, T, D), _normal(rng, D, 4 * H, scale=0.5),
           _normal(rng, P, 4 * H, scale=0.5), _normal(rng, H, P),
           _normal(rng, 4 * H, scale=0.1)]
    if lens is not None:
        ins.append(lens)
    (pair,) = run_both("lstmp", ins, dtype, has_lengths=lens is not None,
                       reverse=reverse)
    assert_close(pair, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lengths", sorted(LENGTHS))
def test_attention_lstm(rng, dtype, lengths):
    """No zeroing past the length; the row of length 0 softmaxes over all
    -inf and is NaN on both sides, as in the reference."""
    lens = LENGTHS[lengths]
    ins = [_normal(rng, B, T, D), _normal(rng, D + H, 7, scale=0.5),
           _normal(rng, 7, 1), _normal(rng, D, 4 * H, scale=0.5),
           _normal(rng, H, 4 * H, scale=0.5), _normal(rng, 4 * H, scale=0.1)]
    if lens is not None:
        ins.append(lens)
    for op in ("attention_lstm", "attension_lstm"):
        (pair,) = run_both(op, ins, dtype, has_lengths=lens is not None)
        assert_close(pair, dtype)
        assert np.isnan(pair[0][1]).all() == (lens is not None)


# ----------------------------------------------- the other sequence ops


@pytest.mark.parametrize("dtype", DTYPES)
def test_sequence_concat_expand_and_mask(rng, dtype):
    a, b = _normal(rng, B, T, D), _normal(rng, B, T, H)
    _equal(run_both("sequence_concat", [a, b], dtype)[0])
    _equal(run_both("sequence_expand", [_normal(rng, B, D), b], dtype)[0])
    scores = _normal(rng, B, 2, T)
    for attrs in ({}, dict(mask=-1e4)):
        _equal(run_both("attention_padding_mask",
                        [scores, LENGTHS["full_zero_mid"]], dtype, **attrs)[0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lengths", sorted(LENGTHS))
def test_seq_concat_seq_pool_soft_sign(rng, dtype, lengths):
    lens = LENGTHS[lengths]
    ins = [_normal(rng, B, T, D), _normal(rng, B, T, H)]
    if lens is not None:
        ins.append(lens)
    assert_close(run_both("seq_concat_seq_pool_soft_sign", ins, dtype,
                          has_lengths=lens is not None)[0], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ctx_len,ctx_start,bias", [
    (3, None, True), (2, 0, False), (4, -3, True), (1, 2, False)])
def test_sequence_conv(rng, dtype, ctx_len, ctx_start, bias):
    x = _normal(rng, B, T, D)
    ins = [x, _normal(rng, ctx_len * D, H)] + ([_normal(rng, H)] if bias else [])
    attrs = dict(context_length=ctx_len, has_bias=bias)
    if ctx_start is not None:
        attrs["context_start"] = ctx_start
    assert_close(run_both("sequence_conv", ins, dtype, **attrs)[0], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["sum", "average", "avg", "max"])
def test_sequence_pool_concat(rng, dtype, mode):
    """Lengths are not read, as in the reference."""
    xs = [_normal(rng, B, T, D), _normal(rng, B, T, H)]
    assert_close(run_both("sequence_pool_concat", xs, dtype, mode=mode)[0],
                 dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["average", "sum", "sqrt", "max", "last",
                                  "first"])
def test_sequence_pool(rng, dtype, mode):
    x = _normal(rng, B, T, D)
    assert_close(run_both("sequence_pool", [x, LENGTHS["full_zero_mid"]],
                          dtype, mode=mode)[0], dtype)


@pytest.mark.parametrize("dtype", DTYPES + ["int32"])
@pytest.mark.parametrize("lengths", sorted(LENGTHS))
@pytest.mark.parametrize("rank", [2, 3])
def test_reverse_sequence(rng, dtype, lengths, rank):
    lens = LENGTHS[lengths]
    x = (rng.integers(-9, 9, (B, T, D)[:rank]).astype(np.int32)
         if dtype == "int32" else _normal(rng, *(B, T, D)[:rank]))
    ins = [x] if lens is None else [x, lens]
    _equal(run_both("reverse_sequence", ins, dtype)[0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("steps", [1, 2, T])
def test_crf_decoding(rng, dtype, ties, steps):
    """The Viterbi path, equal; with `ties`, integer-valued emissions and
    transitions that tie many paths, each argmax taking the first maximum
    as `jnp.argmax` does.  `lengths` is given and not read."""
    N = 4
    x = _normal(rng, B, steps, N)
    w = _normal(rng, N + 2, N)
    if ties:
        x, w = np.round(x), np.round(w)
        x[0] = 0.0
        w[2:, 1] = w[2:, 0]
    _equal(run_both("crf_decoding", [x, w, LENGTHS["full_zero_mid"]], dtype)[0])


# --------------------------------------------------------------- the nets

SIZES = dict(batch=2, seq_len=8, vocab=50, embed=16, hidden=16)
NETS = {"lstm_lm": ("build_lstm_lm", dict(SIZES, layers=2)),
        "text_classifier": ("build_text_classifier", SIZES),
        "ner_tagger": ("build_ner_tagger", SIZES)}


def _feed(seed):
    rng = np.random.default_rng(seed)
    return {"input": rng.integers(0, 50, (2, 8)).astype(np.int32),
            "lengths": np.array([8, 3], np.int32)}


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


def _taps(graph, feed, precision):
    edges = [e for n in ak.topological_order(graph) for e in n.outputs]
    return _interpret(lambda: {
        k: np.asarray(v) for k, v in
        ak.Net(graph, precision=precision, tap_edges=edges)
        .prediction(feed).items()})


@pytest.fixture(scope="module", params=sorted(NETS))
def case(request):
    """The JAX optimized float graph, its quantized graph with the int8
    dense on its Pallas route, the feed, the scales, and every edge of the
    JAX float and int8 nets per precision."""
    fn, kw = NETS[request.param]
    g = ak.optimize(getattr(jax_models, fn)(**kw))
    feed = _feed(11)
    scales = jax_calibrate(g, [feed], method="max")
    gq = jax_quantize_graph(g, scales)
    for node in gq.nodes.values():
        if node.op.endswith("_int8") and _pallas_eligible(node):
            node.attrs["impl"] = "pallas"
    return dict(name=request.param, g=g, gq=gq, feed=feed, scales=scales,
                taps={(q, p): _taps(gr, feed, p)
                      for q, gr in (("float", g), ("int8", gq))
                      for p in DTYPES})


def test_graph_matches_jax_package(case):
    """The builder, then `optimize`, then `quantize_graph` give the JAX
    package's graphs node for node and byte for byte; one int8 node, the
    output projection, on `dense_int8`."""
    fn, kw = NETS[case["name"]]
    raw = getattr(models, fn)(**kw)
    _assert_same_graph(raw, getattr(jax_models, fn)(**kw))
    got = pt.optimize(raw)
    _assert_same_graph(got, case["g"])
    gq = quantize_graph(got, case["scales"])
    _assert_same_graph(gq, jax_quantize_graph(case["g"], case["scales"]))
    assert [n.op for n in gq.nodes.values() if "int8" in n.op] == ["dense_int8"]


def test_meta_shapes_match_jax(case):
    """Shape inference on the meta device gives the JAX package's shapes
    and dtypes at every edge of the float and int8 graphs."""
    for g in (case["g"], case["gq"]):
        want = jax_infer_shapes(g)
        got = infer_shapes(graph_from_jax(g))
        for e, w in want.items():
            assert tuple(got[e].shape) == tuple(w.shape), e
            assert str(got[e].dtype).endswith(np.dtype(w.dtype).name), e


def _check_net_edge(got: torch.Tensor, want: np.ndarray, what: str):
    assert str(got.dtype).endswith(want.dtype.name), (what, got.dtype)
    g, w = got.float().numpy(), _f32(want)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(g, w, err_msg=what)
    elif want.dtype.name == "bfloat16":
        np.testing.assert_allclose(g, w, rtol=8e-3, atol=1e-4, err_msg=what)
    else:
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=what)


@pytest.mark.parametrize("weights", ["float", "int8"])
@pytest.mark.parametrize("precision", DTYPES)
def test_net_matches_jax_net(case, weights, precision):
    """The whole net against the JAX net.  With float weights every edge.
    With int8 weights the edges up to the int8 projection, whose float
    input the node quantizes itself: a last-bit difference of the RNN's
    output there can round one element to the other side, one LSB, so
    from it on the softmax is held within rtol 5e-3 / atol 1e-4 and top-1
    equal (the CNN slices' softmax tolerance), the NER tags equal (each
    node is held to the JAX node on the JAX node's own inputs in
    `test_each_int8_node_matches_jax_node`)."""
    g = graph_from_jax(case["g" if weights == "float" else "gq"])
    order = topological_order(g)
    edges = [e for n in order for e in n.outputs]
    got = pt.Net(g, precision=precision, device="cpu",
                 tap_edges=edges).prediction(case["feed"])
    want = case["taps"][(weights, precision)]
    cut = len(order) if weights == "float" else next(
        i for i, n in enumerate(order) if n.op == "dense_int8")
    for n in order[:cut]:
        for e in n.outputs:
            _check_net_edge(got[e], want[e], e)
    out = g.outputs[0]
    o, w = got[out].float().numpy(), _f32(want[out])
    if case["name"] == "ner_tagger":
        assert got[out].dtype == torch.int32 and o.shape == (2, 8)
        np.testing.assert_array_equal(o, w)
    else:
        np.testing.assert_allclose(o, w, rtol=5e-3, atol=1e-4)
        np.testing.assert_array_equal(o.argmax(-1), w.argmax(-1))


@pytest.mark.parametrize("precision", DTYPES)
def test_each_int8_node_matches_jax_node(case, precision):
    """Every node of the int8 net, run on the JAX net's values of its
    inputs, against the JAX net's value of its outputs, within the edge
    tolerances of the module docstring."""
    g = graph_from_jax(case["gq"])
    taps = dict(case["taps"][("int8", precision)], **case["feed"])
    net = pt.Net(g, precision=precision, device="cpu")
    for node in topological_order(g):
        fwd, _ = build_forward(g, precision, start_from=node.name,
                               stop_at=node.name)
        feed = params_from_numpy(
            {e: taps[e] for e in node.inputs if e not in g.params}, "cpu")
        with torch.inference_mode():
            ys = fwd(net.params, feed, net.prepared)
        for e in node.outputs:
            _check_net_edge(ys[e], taps[e], f"{node.name} {e}")


def test_int8_net_routes_to_matmul_int8(case, monkeypatch):
    """One int8 forward calls `matmul_int8` once (the projection) and no
    other kernel; `Net` prepared its weight when it was built."""
    calls = {}
    for name in ("matmul_int8", "conv3x3_int8", "depthwise3x3_int8"):
        real = getattr(port_quantized, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(port_quantized, name, counted)
    g = graph_from_jax(case["gq"])
    net = pt.Net(g, precision="bf16", device="cpu")
    assert list(net.prepared) == [n.name for n in g.nodes.values()
                                  if n.op == "dense_int8"]
    net.prediction(case["feed"])
    assert calls == {"matmul_int8": 1}


def test_calibrate_on_the_port_matches_jax(case):
    """The port's `calibrate` (max) gives the JAX package's scales within
    the float32 order of sums, and its quantized graph the same nodes."""
    fn, kw = NETS[case["name"]]
    g = pt.optimize(getattr(models, fn)(**kw))
    scales = calibrate(g, [case["feed"]], method="max", device="cpu")
    assert sorted(scales) == sorted(case["scales"])
    for e, s in scales.items():
        np.testing.assert_allclose(s, case["scales"][e], rtol=1e-5, err_msg=e)
    gq = quantize_graph(g, scales)
    assert [n.op for n in gq.nodes.values()] == [
        n.op for n in case["gq"].nodes.values()]


@pytest.mark.parametrize("weights", ["float", "int8"])
def test_net_forward_is_capture_safe(case, weights, monkeypatch):
    """A whole bf16 forward reads no tensor value on the host, indexes by
    no tensor and makes no tensor from host data, so `Net.compile` can
    capture it on CUDA; the compiled step (eager on the CPU) gives the
    eager forward's outputs."""
    g = graph_from_jax(case["g" if weights == "float" else "gq"])
    net = pt.Net(g, precision="bf16", device="cpu")
    feed = {k: torch.from_numpy(v) for k, v in case["feed"].items()}
    want = net.prediction(feed)
    step = net.compile(feed)

    def host_data(*a, **kw):
        raise AssertionError("a tensor made from host data")

    for fname in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, fname, host_data)
    with _NoHostSync(), torch.inference_mode():
        out = net.forward(net.params, feed, net.prepared)
        again = step(feed)
    for e in g.outputs:
        assert torch.equal(out[e], want[e]) and torch.equal(again[e], want[e])
