"""The int8 GEMM core's prepared weights: the [N][K] copy that `prepare_b`
makes once (a `Net` does when it is built) gives the same outputs as the
weight in the JAX layout, through `matmul_int8`, `conv3x3_int8` and a
ResNet `Net`, and against the JAX package's Pallas kernels (interpret
mode), on the CPU.

Tolerances: int8 outputs equal (the same float32 steps on an exact
accumulator on every side); float outputs against the Pallas kernels rtol
1e-6 and an atol of 1e-6 of the largest output (XLA on the CPU contracts the
JAX epilogue into an FMA, see test_torch_kernels.py); prepared against
unprepared on the port, equal.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from anakin_tpu.kernels.conv_int8 import conv3x3_int8 as jax_conv3x3_int8
from anakin_tpu.kernels.matmul_int8 import matmul_int8 as jax_matmul_int8
import anakin_tpu_torch as pt
from anakin_tpu_torch.kernels.conv_int8 import conv3x3_int8
from anakin_tpu_torch.kernels.matmul_int8 import (PreparedB, matmul_int8,
                                                  prepare_b)
from anakin_tpu_torch.models import build_resnet50
from anakin_tpu_torch.ops.quantized import conv_kind, prepare_int8_weights
from anakin_tpu_torch.quant import quantize_graph, read_scale_table
from anakin_tpu_torch.runtime.net import build_forward

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _i8(rng, *shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _compare(got: torch.Tensor, want):
    want = np.asarray(want)
    if want.dtype == np.int8:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        want = want.astype(np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("shape", [(64, 32), (37, 9), (576, 64), (24, 40),
                                   (3, 3, 8, 16), (1, 1, 5, 7)])
def test_prepare_b_layout(rng, shape):
    """[N, ldb]: K contiguous, ldb the next multiple of 16, zero past K."""
    w = torch.from_numpy(_i8(rng, *shape))
    p = prepare_b(w)
    K, N = int(np.prod(shape[:-1])), shape[-1]
    assert p.t.shape == (N, -(-K // 16) * 16) and p.t.is_contiguous()
    assert (p.k, p.n, p.shape) == (K, N, tuple(shape))
    assert torch.equal(p.t[:, :K], w.reshape(K, N).t())
    assert not p.t[:, K:].any()
    assert torch.equal(p.kn(), w.reshape(K, N))


# (M, K, N, activation, bias, residual, out_scale): ResNet-like shapes cut
# down, a K that is not a multiple of 16 (MobileNet v2's 24) or of 4, a
# ragged N, an int8 residual
_MM_CASES = [
    (50, 64, 32, "relu", True, None, 0.7),
    (33, 24, 40, "relu6", True, None, 0.3),
    (17, 37, 9, None, False, None, None),
    (40, 128, 48, None, True, "int8", 0.9),
    (9, 256, 10, None, True, None, None),
]


@pytest.mark.parametrize("M,K,N,act,bias,res,out_scale", _MM_CASES)
def test_matmul_int8_prepared_matches_pallas(rng, M, K, N, act, bias, res,
                                             out_scale):
    a, b = _i8(rng, M, K), _i8(rng, K, N)
    ws = rng.uniform(0.001, 0.01, N).astype(np.float32)
    bv = rng.normal(size=N).astype(np.float32) if bias else None
    r = _i8(rng, M, N) if res else None
    kw = dict(in_scale=0.05, activation=act, out_scale=out_scale)
    want = jax_matmul_int8(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(ws),
        None if bv is None else jnp.asarray(bv),
        None if r is None else jnp.asarray(r).astype(jnp.float32) * 0.037,
        interpret=True, **kw)
    t = [None if v is None else torch.from_numpy(v) for v in (a, b, ws, bv, r)]
    plain = matmul_int8(t[0], t[1], t[2], t[3], t[4], residual_scale=0.037,
                        **kw)
    prep = matmul_int8(t[0], prepare_b(t[1]), t[2], t[3], t[4],
                       residual_scale=0.037, **kw)
    assert torch.equal(prep, plain)
    _compare(prep, want)


@pytest.mark.parametrize("N,H,W,C,O,act,res,out_scale", [
    (2, 6, 7, 16, 24, "relu", None, 0.2),
    (1, 5, 5, 8, 13, "relu6", "int8", 0.4),
    (2, 4, 9, 24, 32, None, None, None),
    (1, 3, 4, 5, 6, "relu", None, 0.5),
])
def test_conv3x3_int8_prepared_matches_pallas(rng, N, H, W, C, O, act, res,
                                              out_scale):
    x, w = _i8(rng, N, H, W, C), _i8(rng, 3, 3, C, O)
    ws = rng.uniform(0.001, 0.01, O).astype(np.float32)
    bv = rng.normal(size=O).astype(np.float32)
    r = _i8(rng, N, H, W, O) if res else None
    kw = dict(in_scale=0.05, activation=act, out_scale=out_scale)
    want = jax_conv3x3_int8(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(ws), jnp.asarray(bv),
        None if r is None else jnp.asarray(r).astype(jnp.float32) * 0.037,
        interpret=True, **kw)
    t = [None if v is None else torch.from_numpy(v) for v in (x, w, ws, bv, r)]
    plain = conv3x3_int8(*t, residual_scale=0.037, **kw)
    prep = conv3x3_int8(t[0], prepare_b(t[1]), *t[2:], residual_scale=0.037,
                        **kw)
    assert torch.equal(prep, plain)
    _compare(prep, want)


def test_prepared_weight_refuses_a_changed_weight(rng):
    """A prepared copy remembers its weight's version: an in-place change
    of the weight afterwards is refused, not run on a stale copy."""
    a, b = torch.from_numpy(_i8(rng, 4, 32)), torch.from_numpy(_i8(rng, 32, 8))
    p = prepare_b(b)
    matmul_int8(a, p, torch.ones(8), in_scale=1.0)
    b[0, 0] += 1
    with pytest.raises(RuntimeError, match="prepare it again"):
        matmul_int8(a, p, torch.ones(8), in_scale=1.0)


def _small_resnet():
    """ResNet-50 at 32 px and batch 1, quantized with the checked-in scale
    table of the bench configuration."""
    scales = read_scale_table(os.path.join(ROOT, "artifacts",
                                           "resnet50_seed0_scales.txt"))
    return quantize_graph(pt.optimize(build_resnet50(batch=1, image_size=32)),
                          scales)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_resnet_net_prepares_each_int8_weight_once(rng, precision):
    """A ResNet-50 `Net` (32 px) prepares the weight of every int8 conv
    and dense that runs on matmul_int8 / conv3x3_int8 once when it is
    built, and none in a step; its outputs equal those of the same graph
    run with the weights in the JAX layout, edge for edge."""
    gq = _small_resnet()
    x = rng.normal(size=(1, 32, 32, 3)).astype(np.float32)
    routed = [n for n in gq.nodes.values()
              if n.op == "dense_int8" or n.op == "conv2d_int8"]
    assert len(routed) == 53 and all(conv_kind(n) != "dw3x3" for n in routed
                                     if n.op == "conv2d_int8")
    before = prepare_b.calls
    edges = [e for n in gq.nodes.values() for e in n.outputs]
    net = pt.Net(gq, precision=precision, device="cpu", tap_edges=edges)
    assert prepare_b.calls - before == len({n.inputs[1] for n in routed})
    assert set(net.prepared) == {n.name for n in routed}
    assert all(isinstance(p, PreparedB) and p.source is net.params[
        gq.nodes[name].inputs[1]] for name, p in net.prepared.items())
    after_build = prepare_b.calls
    got = net.prediction({"input": x})
    net.prediction({"input": x})
    assert prepare_b.calls == after_build
    fwd, _ = build_forward(gq, precision, tap_edges=edges)
    with torch.inference_mode():
        want = fwd(net.params, {"input": torch.from_numpy(x)})
    for e in edges:
        assert torch.equal(got[e], want[e]), e


def test_prepare_int8_weights_shares_a_weight_between_nodes(rng):
    """Two nodes on one weight edge get one prepared copy; depthwise convs
    on `depthwise3x3_int8` (their own kernel, weights as they are) get
    none; any other grouped conv (here the same weight at pad 0, which the
    JAX package leaves to XLA and the port runs on `matmul_int8` once per
    group) gets one copy a group."""
    from anakin_tpu_torch.graph.ir import Node
    from anakin_tpu_torch.ops.quantized import PreparedGroups

    w = torch.from_numpy(_i8(rng, 16, 8))
    dw = torch.from_numpy(_i8(rng, 3, 3, 1, 8))
    dw0 = torch.from_numpy(_i8(rng, 3, 3, 1, 8))
    nodes = [Node("a", "dense_int8", ["x", "w", "s"], ["y"], {}),
             Node("b", "dense_int8", ["y", "w", "s"], ["z"], {}),
             Node("c", "conv2d_int8", ["z", "dw", "s"], ["o"],
                  dict(groups=8, padding=(1, 1))),
             Node("d", "dense", ["o", "w"], ["p"], {}),
             Node("e", "conv2d_int8", ["o", "dw0", "s"], ["q"],
                  dict(groups=8))]
    before = prepare_b.calls
    prepared = prepare_int8_weights(nodes, {"w": w, "dw": dw, "dw0": dw0})
    assert prepare_b.calls - before == 1 + 8
    assert set(prepared) == {"a", "b", "e"}
    assert prepared["a"] is prepared["b"]
    assert isinstance(prepared["e"], PreparedGroups)
    assert prepared["e"].source is dw0 and len(prepared["e"].parts) == 8


def test_net_device_params_shares_the_prepared_weights(rng):
    """A second ResNet `Net` on `device_params=first.params` neither copies
    a weight nor prepares one: its params and prepared weights are the
    first net's objects, and its outputs equal the first net's."""
    gq = _small_resnet()
    x = rng.normal(size=(1, 32, 32, 3)).astype(np.float32)
    a = pt.Net(gq, device="cpu")
    before = prepare_b.calls
    b = pt.Net(gq, device="cpu", device_params=a.params)
    assert prepare_b.calls == before
    assert all(b.params[k] is a.params[k] for k in a.params)
    assert b.prepared.keys() == a.prepared.keys() and all(
        b.prepared[n] is a.prepared[n] for n in a.prepared)
    out = gq.outputs[0]
    assert torch.equal(b.prediction({"input": x})[out],
                       a.prediction({"input": x})[out])
