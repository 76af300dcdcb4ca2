"""The port's calibration, precision policy, shape inference and profiler
against the JAX package, on the CPU.

Tolerances, and why:
  * the histogram and KL arithmetic is the same numpy code on both sides:
    equal results;
  * max-method scales: rtol 2e-6, the float32 edge tolerance of the
    slices' tests (rtol 1e-6 plus 1e-6 of the largest value) at the largest
    value, since the two forwards sum in other orders (measured up to
    1.2e-6 in MobileNet v1's last layers).  The classifier's logits and
    softmax are held to rtol 1e-4: XLA's float32 dot over 1024-1280 inputs
    and its exp differ from PyTorch's by more than an ulp of the result,
    and no int8 node reads those two edges;
  * entropy-method thresholds: within one of the 2048 bins (a value on a
    bin edge may fall on either side when the edge's maximum differs in
    its last bit);
  * shapes, dtypes, FLOPs, bytes and policy decisions: equal.
"""

import json
import os

import numpy as np
import pytest

import torch

import anakin_tpu as ak
from anakin_tpu.graph.shape_infer import infer_shapes as jax_infer_shapes
from anakin_tpu.models import build_mobilenet_v1 as jax_build_mobilenet_v1
from anakin_tpu.models import build_mobilenet_v2 as jax_build_mobilenet_v2
from anakin_tpu.models import build_resnet50 as jax_build_resnet50
from anakin_tpu.models import transformer as jax_transformer
from anakin_tpu.quant import calibrator as jax_calibrator
from anakin_tpu.quant import policy as jax_policy
from anakin_tpu.quant import quantize_graph as jax_quantize_graph
from anakin_tpu.quant import weight_only_quantize as jax_weight_only_quantize
from anakin_tpu.runtime.profiler import flops_estimate as jax_flops_estimate
import anakin_tpu_torch as pt
from anakin_tpu_torch.graph.shape_infer import infer_shapes
from anakin_tpu_torch.models import (build_mobilenet_v1, build_mobilenet_v2,
                                     build_resnet50)
from anakin_tpu_torch.models import transformer as port_transformer
from anakin_tpu_torch.quant import calibrator, policy
from anakin_tpu_torch.quant import (apply_precision_policy, calibrate,
                                    calibrate_kv_scales, choose_precision,
                                    quantize_graph, weight_only_quantize)
from anakin_tpu_torch.runtime.profiler import (flops_estimate,
                                               roofline_report, trace)

CNNS = {"mobilenet_v1": (jax_build_mobilenet_v1, build_mobilenet_v1),
        "mobilenet_v2": (jax_build_mobilenet_v2, build_mobilenet_v2),
        "resnet50": (jax_build_resnet50, build_resnet50)}


def _graphs(name, batch=2, image=32):
    """(JAX optimized graph, port optimized graph) of one CNN."""
    jax_build, build = CNNS[name]
    return (ak.optimize(jax_build(batch=batch, image_size=image)),
            pt.optimize(build(batch=batch, image_size=image)))


def _image(batch=2, image=32, seed=0):
    return np.random.default_rng(seed).normal(
        size=(batch, image, image, 3)).astype(np.float32)


# ------------------------------------------------------------- KL pieces

def test_kl_pieces_equal_jax_package(rng):
    p = rng.integers(0, 100, size=700).astype(np.float64)
    p[rng.integers(0, 700, size=200)] = 0
    ref_q = calibrator.get_ref_q(p, 128)
    np.testing.assert_array_equal(ref_q, jax_calibrator.get_ref_q(p, 128))
    q = calibrator.expand_to_q(p, ref_q)
    np.testing.assert_array_equal(q, jax_calibrator.expand_to_q(p, ref_q))
    hist = rng.integers(0, 50, size=2048).astype(np.float64)
    qq = np.concatenate([q, np.zeros(2048 - q.size)])
    assert calibrator.kl_divergence(hist, qq) == \
        jax_calibrator.kl_divergence(hist, qq)


def test_entropy_calibrator_equals_jax_package(rng):
    """The same float32 tensors, streamed through both calibrators: equal
    maxima, histograms, KL thresholds and scales."""
    names = ["a", "b"]
    ours = calibrator.EntropyCalibrator(names)
    theirs = jax_calibrator.EntropyCalibrator(names)
    batches = [{"a": rng.normal(size=(4, 64)).astype(np.float32),
                "b": np.abs(rng.standard_t(3, size=(8, 32))).astype(np.float32)}
               for _ in range(3)]
    for cal in (ours, theirs):
        for observe in (cal.observe_max, cal.observe_hist):
            for batch in batches:
                for n in names:
                    observe(n, batch[n])
    assert ours.max_vec == theirs.max_vec
    for n in names:
        np.testing.assert_array_equal(ours.hists[n], theirs.hists[n])
        assert ours.kl_threshold(n) == theirs.kl_threshold(n)
    for method in ("max", "entropy"):
        assert ours.scales(method) == theirs.scales(method)


# ------------------------------------------------------------ calibrate

@pytest.mark.parametrize("name", ["mobilenet_v1", "mobilenet_v2"])
def test_calibrate_max_matches_jax(name):
    jg, g = _graphs(name)
    x = _image()
    want = jax_calibrator.calibrate(jg, [{"input": x}], method="max")
    got = calibrate(g, [{"input": x}], method="max", device="cpu")
    assert sorted(got) == sorted(want)
    classifier = {e for n in g.nodes.values() if n.op in ("dense", "softmax")
                  for e in n.outputs}
    for e, s in want.items():
        rtol = 1e-4 if e in classifier else 2e-6
        assert abs(got[e] - s) <= rtol * s, (e, got[e], s)
    # a callable of fresh iterators and chunked taps give the same table
    again = calibrate(g, lambda: iter([{"input": x}]), method="max",
                      edge_chunk=7, device="cpu")
    assert again == got


def test_calibrate_entropy_matches_jax():
    """KL-argmin thresholds of a few edges within one bin of JAX's."""
    jg, g = _graphs("mobilenet_v1", batch=1)
    x = _image(batch=1)
    order = [e for n in ak.topological_order(jg) for e in n.outputs]
    edges = order[2:4] + order[10:12]
    feed = [{"input": x}]
    want_max = jax_calibrator.calibrate(jg, feed, method="max", edges=edges)
    want = jax_calibrator.calibrate(jg, feed, method="entropy", edges=edges)
    got = calibrate(g, feed, method="entropy", edges=edges, device="cpu")
    assert sorted(got) == sorted(want) == sorted(edges)
    for e in edges:
        bins = [s / want_max[e] * 2048 for s in (got[e], want[e])]
        assert abs(bins[0] - bins[1]) <= 1.0 + 1e-6, (e, bins)


def test_calibrate_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is usable")
    _, g = _graphs("mobilenet_v1", batch=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        calibrate(g, [{"input": _image(batch=1)}], method="max")
    cfg = port_transformer.TransformerConfig(vocab=64, embed=32, heads=4,
                                             kv_heads=2, layers=1, max_seq=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        calibrate_kv_scales(cfg, port_transformer.make_transformer_params(cfg),
                            [np.zeros((1, 4), np.int32)])


def test_calibrate_kv_scales_matches_jax():
    kw = dict(vocab=64, embed=32, heads=4, kv_heads=2, layers=2, max_seq=64)
    cfg = port_transformer.TransformerConfig(**kw)
    params = port_transformer.make_transformer_params(cfg, 0)
    prompts = [np.random.default_rng(1).integers(0, 64, (2, 16)),
               np.random.default_rng(2).integers(0, 64, (1, 9))]
    want = jax_calibrator.calibrate_kv_scales(
        jax_transformer.TransformerConfig(**kw), params, prompts)
    got = calibrate_kv_scales(cfg, params, prompts, device="cpu")
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-6)


# --------------------------------------------------------------- policy

def test_policy_thresholds_equal_jax_package():
    for k in ("INT8_DEPTHWISE_MIN_BATCH", "INT8_DETECTION_MIN_BATCH",
              "INT8_DISPATCH_MIN_GFLOPS"):
        assert getattr(policy, k) == getattr(jax_policy, k), k


@pytest.mark.parametrize("name", ["mobilenet_v1", "resnet50"])
def test_choose_precision_matches_jax(name):
    """At 224 px, the graph built at b1 and served at b1/b4/b8/b128, with
    and without the dispatch gate."""
    jg, g = _graphs(name, batch=1, image=224)
    assert policy.is_depthwise_dominated(g) == (name == "mobilenet_v1")
    assert policy.is_detection_graph(g) is False
    decisions = []
    for batch in (1, 4, 8, 128):
        for bound in (True, False):
            want = jax_policy.choose_precision(jg, batch, bound)
            assert choose_precision(g, batch, bound) == want, (batch, bound)
            decisions.append(want)
    assert set(decisions) == {"bf16", "int8"}


@pytest.mark.parametrize("name", ["mobilenet_v1", "resnet50"])
def test_apply_precision_policy_matches_jax(name):
    jg, g = _graphs(name, batch=1)
    scales = {e: 0.05 for n in g.nodes.values() for e in n.outputs}
    scales["input"] = 0.03
    for batch in (1, 4, 8, 128):
        got_g, got = apply_precision_policy(g, batch, scales, False)
        want_g, want = jax_policy.apply_precision_policy(jg, batch, scales,
                                                         False)
        assert got == want
        assert [n.op for n in got_g.nodes.values()] == \
            [n.op for n in want_g.nodes.values()]
    assert apply_precision_policy(g, 128, None)[1] == "bf16"
    gq = quantize_graph(g, scales)
    assert apply_precision_policy(gq, 1)[1] == "int8"


# ------------------------------------------------- shapes, FLOPs, profiler

def _assert_same_shapes(got, want):
    assert sorted(got) == sorted(want)
    for e, s in want.items():
        assert got[e].device.type == "meta"
        assert tuple(got[e].shape) == tuple(s.shape), e
        assert str(got[e].dtype) == f"torch.{s.dtype}", e


@pytest.mark.parametrize("name", sorted(CNNS))
@pytest.mark.parametrize("quantized", [False, True])
def test_infer_shapes_and_flops_match_jax(name, quantized):
    jg, g = _graphs(name)
    if quantized:
        scales = jax_calibrator.calibrate(jg, [{"input": _image()}],
                                          method="max")
        jg, g = jax_quantize_graph(jg, scales), quantize_graph(g, scales)
    _assert_same_shapes(infer_shapes(g), jax_infer_shapes(jg))
    assert flops_estimate(g) == jax_flops_estimate(jg)


def test_infer_shapes_transformer_graphs_match_jax():
    kw = dict(vocab=64, embed=32, heads=4, kv_heads=2, layers=2, max_seq=64)
    cfg = port_transformer.TransformerConfig(**kw)
    jcfg = jax_transformer.TransformerConfig(**kw)
    params = port_transformer.make_transformer_params(cfg, 0)
    pairs = [
        (port_transformer.build_transformer_prefill(cfg, 2, 16, params),
         jax_transformer.build_transformer_prefill(jcfg, 2, 16, params)),
        (weight_only_quantize(port_transformer.build_transformer_decode_step(
            cfg, 2, params, kv_cache_dtype="int8"), bits=4),
         jax_weight_only_quantize(jax_transformer.build_transformer_decode_step(
             jcfg, 2, params, kv_cache_dtype="int8"), bits=4)),
    ]
    for g, jg in pairs:
        _assert_same_shapes(infer_shapes(g), jax_infer_shapes(jg))


@pytest.mark.parametrize("bits", [4, 8])
def test_weight_only_quantize_reuses_packed_weights(bits):
    """With a `packed` memo, a second graph over the same weight arrays gets
    the very arrays of the first call, and a graph equal to the JAX
    package's rewrite; a weight array that changed is quantized anew."""
    kw = dict(vocab=64, embed=128, heads=4, kv_heads=2, layers=2, max_seq=32)
    cfg = port_transformer.TransformerConfig(**kw)
    jcfg = jax_transformer.TransformerConfig(**kw)
    params = port_transformer.make_transformer_params(cfg, 0)
    memo = {}
    first = weight_only_quantize(port_transformer.build_transformer_decode_step(
        cfg, 2, params), bits=bits, packed=memo)
    second = weight_only_quantize(port_transformer.build_transformer_prefill(
        cfg, 2, 16, params), bits=bits, packed=memo)
    want = jax_weight_only_quantize(jax_transformer.build_transformer_prefill(
        jcfg, 2, 16, params), bits=bits)
    assert {n: (v.op, v.inputs, v.attrs) for n, v in second.nodes.items()} == \
        {n: (v.op, v.inputs, v.attrs) for n, v in want.nodes.items()}
    assert second.params.keys() == want.params.keys()
    quantized = [k for k in want.params if "__w" in k]
    assert len(quantized) == 2 * 2 * cfg.layers  # the MLPs' (lm_head is small)
    for k, v in want.params.items():
        np.testing.assert_array_equal(second.params[k], v)
        if k in quantized:
            assert second.params[k] is first.params[k]
    changed = dict(params, **{"l0.mlp_up": params["l0.mlp_up"] * 2.0})
    third = weight_only_quantize(port_transformer.build_transformer_decode_step(
        cfg, 2, changed), bits=bits, packed=memo)
    fresh = weight_only_quantize(port_transformer.build_transformer_decode_step(
        cfg, 2, changed), bits=bits)
    for k, v in fresh.params.items():
        np.testing.assert_array_equal(third.params[k], v)
    tag = "__w4" if bits == 4 else "__w8"
    assert third.params["l0.mlp_up" + tag] is not first.params["l0.mlp_up" + tag]
    assert third.params["l1.mlp_up" + tag] is first.params["l1.mlp_up" + tag]


def test_roofline_report_uses_h100_peaks():
    _, g = _graphs("mobilenet_v1", batch=1)
    flops = sum(v["flops"] for v in flops_estimate(g).values())
    byts = sum(v["bytes"] for v in flops_estimate(g).values())
    report = roofline_report(g, 1e-3)
    assert f"compute {flops / 1979e12 * 1e3:.3f} ms" in report
    assert f"memory {byts / 3.35e12 * 1e3:.3f} ms" in report


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        torch.ones(8) @ torch.ones(8)
    assert prof is not None
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    assert os.path.getsize(tmp_path / "trace.json") > 0
