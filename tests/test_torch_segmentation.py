"""Segmentation on the port: `deconv2d` (and its aliases), `resize` /
`interp`, `argmax` / `arg_max`, `crop`, and the FCN-8s lite and ICNet lite
nets, each against the JAX package on the same graph and the same seeded
inputs, on the CPU.  The nets run at 32 px, b2, in float32 and bf16 (they
have no int8 route in the reference's benchmark suite).

Tolerances, and why:
  * `resize` and `crop` move or blend values with the JAX formulas: nearest
    and crop equal; bilinear float32 within rtol 1e-6 (one rounding of the
    blend); bf16 within one bf16 ulp (rtol 8e-3).
  * `argmax`: indices equal, ties to the lower index included; values
    equal.
  * `deconv2d`: float32 within rtol 1e-5 and 1e-5 of the largest value
    (PyTorch's and XLA's convolutions sum in other orders); bf16 within
    rtol 8e-3.
  * the float32 nets: every edge within 1e-5 of its largest value; the
    label maps equal where the two largest logits of a pixel differ by more
    than 1e-4 of the largest logit (a closer pair may swap on a last-bit
    difference).
  * the bf16 nets: each node held to the JAX node on the JAX node's own
    inputs (a bf16 difference grows through the layers), bf16 within
    rtol 8e-3 / atol 1e-4; the label maps equal on those inputs.
"""

import numpy as np
import pytest

import torch

import anakin_tpu as ak
from anakin_tpu import models as jax_models
from anakin_tpu.graph.shape_infer import infer_shapes as jax_infer_shapes
import anakin_tpu_torch as pt
from anakin_tpu_torch import models
from anakin_tpu_torch.convert import graph_from_jax, params_from_numpy
from anakin_tpu_torch.graph.ir import topological_order
from anakin_tpu_torch.graph.shape_infer import infer_shapes
from anakin_tpu_torch.runtime.net import build_forward

from test_torch_mobilenet import _assert_same_graph
from test_torch_ops import run_both
from test_torch_resnet import _f32

BF16_RTOL = 8e-3
FLOAT_NET_RTOL = 1e-5
# a pixel whose two largest logits are closer than this (of the largest
# logit) may take either label on a last-bit difference
LABEL_MARGIN = 1e-4


def _close(pair, dtype, rtol=1e-6):
    got, want = pair
    want = _f32(want)
    if dtype == "bf16":
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=1e-2)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=rtol * float(np.abs(want).max()))


# ------------------------------------------------------------------ ops


RESIZE = {
    "nearest_up2": dict(method="nearest", scale=2.0),
    "nearest_down": dict(method="nearest", out_hw=(3, 4)),
    "nearest_odd": dict(method="nearest", scale_h=1.5, scale_w=0.7),
    "bilinear_align_up": dict(method="bilinear", align_corners=True,
                              out_hw=(13, 22)),
    "bilinear_align_down": dict(method="bilinear", align_corners=True,
                                out_hw=(4, 3)),
    "bilinear_half_pixel_up": dict(method="bilinear", align_corners=False,
                                   scale_h=2.0, scale_w=2.0),
    "bilinear_half_pixel_down": dict(method="bilinear", align_corners=False,
                                     scale_h=0.5, scale_w=0.5),
    "bilinear_default_scale": dict(scale=1.75),
    "bilinear_align_one_row": dict(method="bilinear", align_corners=True,
                                   out_hw=(1, 9)),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(RESIZE))
def test_resize(case, dtype):
    x = np.random.default_rng(1).normal(size=(2, 6, 7, 5)).astype(np.float32)
    for op in ("resize", "interp"):
        (pair,) = run_both(op, [x], dtype, **RESIZE[case])
        if RESIZE[case].get("method") == "nearest":
            np.testing.assert_array_equal(*pair)
        else:
            _close(pair, dtype)


def test_resize_int8_nearest():
    """Nearest resize moves values, so int8 edges pass through it."""
    x = np.random.default_rng(2).integers(-127, 128, size=(2, 4, 5, 3)).astype(
        np.int8)
    (pair,) = run_both("resize", [x], method="nearest", scale=2.0)
    np.testing.assert_array_equal(*pair)


@pytest.mark.parametrize("op", ["argmax", "arg_max"])
@pytest.mark.parametrize("attrs", [dict(axis=3), dict(axis=1, top_k=2),
                                   dict(axis=3, top_k=3, out_max_val=True),
                                   dict(axis=None, top_k=4),
                                   dict(axis=None, out_max_val=True)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_argmax(op, attrs, dtype):
    """Indices in x's dtype, ties (a pixel of equal logits, repeated
    values) to the lower index."""
    x = np.random.default_rng(3).normal(size=(2, 5, 4, 6)).astype(np.float32)
    x[0, 0, 0, :] = 0.5          # every channel equal
    x[1, :, 1, 2] = x[1, 0, 1, 2]  # equal along axis 1
    x = np.round(x * 4) / 4      # more ties
    for got, want in run_both(op, [x], dtype, **attrs):
        np.testing.assert_array_equal(got, _f32(want))


@pytest.mark.parametrize("attrs,with_ref", [
    (dict(axis=1, offset=[1]), True),
    (dict(axis=2, offset=[2, 0]), True),
    (dict(axis=1, offset=[0, 1]), True),
    (dict(axis=1, offset=[1, 2, 3], shape=[2, 3, 4, 2]), False),
])
def test_crop(attrs, with_ref):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, 7, 5)).astype(np.float32)
    ins = [x] + ([np.zeros((2, 4, 5, 3), np.float32)] if with_ref else [])
    (pair,) = run_both("crop", ins, **attrs)
    np.testing.assert_array_equal(*pair)


DECONV = {
    "fcn_up2": dict(k=4, strides=(2, 2), padding=(1, 1)),
    "s1_p0": dict(k=3, strides=(1, 1), padding=(0, 0)),
    "s3_p2_bias_relu": dict(k=5, strides=(3, 3), padding=(2, 2), bias=True,
                            activation="relu"),
    "s2_dilated": dict(k=3, strides=(2, 2), padding=(1, 1),
                       dilation=(2, 2)),
    "groups2": dict(k=4, strides=(2, 2), padding=(1, 1), groups=2,
                    bias=True),
    "pad_past_kernel": dict(k=2, strides=(2, 1), padding=(2, 1)),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(DECONV))
def test_deconv2d(case, dtype):
    """Strides, paddings up to past the kernel (a crop), dilation, groups,
    bias and activation, under each alias."""
    cfg = dict(DECONV[case])
    k, bias, groups = cfg.pop("k"), cfg.pop("bias", False), cfg.get("groups", 1)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 5, 6, 4)).astype(np.float32)
    w = (rng.normal(size=(k, k, 4, 6 // groups)) * 0.3).astype(np.float32)
    ins = [x, w] + ([rng.normal(size=6).astype(np.float32)] if bias else [])
    for op in ("deconv2d", "deconvolution", "deconv_relu"):
        (pair,) = run_both(op, ins, dtype, has_bias=bias, **cfg)
        _close(pair, dtype, rtol=1e-5)


# ----------------------------------------------------------------- nets


NETS = {"fcn8s_lite": "build_fcn8s_lite", "icnet_lite": "build_icnet_lite"}
SIZE = 32


def _taps(graph, x, precision):
    edges = [e for n in ak.topological_order(graph) for e in n.outputs]
    return {k: np.asarray(v) for k, v in
            ak.Net(graph, precision=precision, tap_edges=edges)
            .prediction({"input": x}).items()}


@pytest.fixture(scope="module", params=sorted(NETS))
def case(request):
    fn = NETS[request.param]
    g = ak.optimize(getattr(jax_models, fn)(batch=2, image_size=SIZE))
    x = np.random.default_rng(7).normal(size=(2, SIZE, SIZE, 3)).astype(
        np.float32)
    return dict(name=request.param, g=g, x=x,
                taps={p: _taps(g, x, p) for p in ("fp32", "bf16")})


def test_graph_matches_jax_package(case):
    """The builder alone and after `optimize` give the JAX package's
    graphs node for node and byte for byte, and shape inference on the
    meta device its shapes and dtypes."""
    fn = NETS[case["name"]]
    raw = getattr(models, fn)(batch=2, image_size=SIZE)
    _assert_same_graph(raw, getattr(jax_models, fn)(batch=2, image_size=SIZE))
    got = pt.optimize(raw)
    _assert_same_graph(got, case["g"])
    want = jax_infer_shapes(case["g"])
    shapes = infer_shapes(got)
    for e, w in want.items():
        assert tuple(shapes[e].shape) == tuple(w.shape), e
        assert str(shapes[e].dtype).endswith(np.dtype(w.dtype).name), e


def _labels_agree(labels, logits, want_labels):
    """Label maps equal wherever the two largest logits are apart by more
    than LABEL_MARGIN of the largest logit."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > LABEL_MARGIN * np.abs(logits).max()
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(labels[..., 0][clear],
                                  want_labels[..., 0][clear])


def test_fp32_net_matches_jax_net(case):
    g = case["g"]
    want = case["taps"]["fp32"]
    edges = [e for n in topological_order(g) for e in n.outputs]
    got = pt.Net(graph_from_jax(g), device="cpu", tap_edges=edges).prediction(
        {"input": case["x"]})
    logits_e, labels_e = g.outputs
    for e in edges:
        if e == labels_e:
            continue
        w = want[e]
        np.testing.assert_allclose(got[e].numpy(), w, rtol=0,
                                   atol=FLOAT_NET_RTOL * np.abs(w).max(),
                                   err_msg=e)
    assert got[labels_e].dtype == torch.float32
    _labels_agree(got[labels_e].numpy(), want[logits_e], want[labels_e])


def test_bf16_net_matches_jax_net_node_by_node(case):
    g = graph_from_jax(case["g"])
    taps = dict(case["taps"]["bf16"], input=case["x"])
    net = pt.Net(g, precision="bf16", device="cpu")
    for node in topological_order(g):
        fwd, _ = build_forward(g, "bf16", start_from=node.name,
                               stop_at=node.name)
        feed = params_from_numpy(
            {e: taps[e] for e in node.inputs if e not in g.params}, "cpu")
        with torch.inference_mode():
            y = fwd(net.params, feed, net.prepared)[node.outputs[0]]
        want = taps[node.outputs[0]]
        assert str(y.dtype).endswith(want.dtype.name), node.name
        if node.op == "argmax":
            np.testing.assert_array_equal(y.float().numpy(), _f32(want))
        else:
            np.testing.assert_allclose(y.float().numpy(), _f32(want),
                                       rtol=BF16_RTOL, atol=1e-4,
                                       err_msg=node.name)
