"""Each op of the port against the JAX package's op of the same name, on
the same `Node` and the same seeded inputs.

Tolerances, and why:
  * float32 conv / dense / pooling: rtol 1e-5, atol 1e-5 — the two
    libraries sum in different orders;
  * bf16 outputs: rtol 8e-3 — one bf16 ulp (2**-8) after such a sum;
  * int8 outputs of float ops (`quant_out_scale`): within 1 LSB, and equal
    for 99% of the elements — a different float sum can cross a rounding
    boundary;
  * int8 ops routed to a Pallas kernel on the JAX side: equal;
  * int8 convs of the "other" kind, which the JAX package runs through XLA
    and which divide by out_scale where the port's kernel multiplies by its
    reciprocal: within 1 LSB.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from anakin_tpu.graph.ir import Node as JaxNode
from anakin_tpu.ops import get_op as jax_get_op
from anakin_tpu_torch.graph.ir import Node
from anakin_tpu_torch.ops import get_op


def _jnp(a, dtype):
    a = jnp.asarray(a)
    return a.astype(jnp.bfloat16) if dtype == "bf16" and a.dtype == jnp.float32 else a


def _torch(a, dtype):
    t = torch.from_numpy(np.array(a))
    return t.to(torch.bfloat16) if dtype == "bf16" and t.dtype == torch.float32 else t


def run_both(op, inputs, dtype="fp32", **attrs):
    """Outputs of the JAX op and of the port's op, as numpy arrays."""
    names = [f"i{k}" for k in range(len(inputs))]
    jn = JaxNode("n", op, names, ["out"], dict(attrs))
    pn = Node("n", op, names, ["out"], dict(attrs))
    want = jax_get_op(op)(jn, [_jnp(x, dtype) for x in inputs])
    got = get_op(op)(pn, [_torch(x, dtype) for x in inputs])
    assert len(got) == len(want)
    out = []
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).endswith(w.dtype.name), (g.dtype, w.dtype)
        out.append((g.float().numpy() if g.is_floating_point() else g.numpy(),
                    w.astype(np.float32) if w.dtype.name == "bfloat16" else w))
    return out


def assert_close(pair, dtype="fp32"):
    got, want = pair
    if want.dtype == np.int8:
        np.testing.assert_array_equal(got, want)
    elif dtype == "bf16":
        np.testing.assert_allclose(got, want, rtol=8e-3, atol=1e-2)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def assert_within_lsb(pair, min_equal=0.0):
    got, want = pair
    assert got.dtype == want.dtype == np.int8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1
    assert (d == 0).mean() >= min_equal


# ----------------------------------------------------------------- float


@pytest.mark.parametrize("strides,padding,dilation,groups,act,bias,res", [
    ((1, 1), (1, 1), (1, 1), 1, "relu", True, False),
    ((1, 1), ((2, 1), (2, 1)), (1, 1), 1, None, True, False),
    ((2, 2), "SAME", (1, 1), 1, "relu6", False, True),
    ((1, 1), "SAME", (2, 2), 1, "leaky_relu", True, False),
    ((2, 2), "VALID", (1, 1), 2, "tanh", True, False),
    ((2, 1), (0, 1), (1, 1), 1, None, False, False),
])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_conv2d(rng, dtype, strides, padding, dilation, groups, act, bias, res):
    x = rng.normal(size=(2, 9, 11, 8)).astype(np.float32)
    w = rng.normal(size=(3, 3, 8 // groups, 12)).astype(np.float32)
    inputs = [x, w]
    if bias:
        inputs.append(rng.normal(size=12).astype(np.float32))
    oh, ow = run_both("conv2d", [x, w], strides=strides, padding=padding,
                      dilation=dilation, groups=groups)[0][0].shape[1:3]
    if res:
        inputs.append(rng.normal(size=(2, oh, ow, 12)).astype(np.float32))
    out = run_both("conv2d", inputs, dtype, strides=strides, padding=padding,
                   dilation=dilation, groups=groups, activation=act,
                   act_alpha=0.1, has_bias=bias, has_residual=res)
    assert_close(out[0], dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_conv2d_quant_out_scale(rng, dtype):
    """The stem's float conv with its fused requant, as the stem pass
    leaves it: asymmetric pads ((2, 1), (2, 1)), bias and relu."""
    x = rng.normal(size=(2, 16, 16, 12)).astype(np.float32)
    w = rng.normal(0, 0.2, size=(4, 4, 12, 64)).astype(np.float32)
    b = rng.normal(size=64).astype(np.float32)
    out = run_both("conv2d", [x, w, b], dtype, strides=(1, 1),
                   padding=((2, 1), (2, 1)), has_bias=True, activation="relu",
                   quant_out_scale=0.05)
    assert_within_lsb(out[0], min_equal=0.99)


@pytest.mark.parametrize("mode,window,strides,padding,ceil_mode,exclusive", [
    ("max", (3, 3), (2, 2), (0, 0), True, True),
    ("max", (2, 2), (2, 2), (1, 1), False, True),
    ("max", (3, 3), (2, 2), ((0, 1), (0, 1)), True, True),
    ("avg", (3, 3), (2, 2), (1, 1), True, True),
    ("avg", (3, 3), (1, 1), (1, 1), True, False),
    ("avg", (2, 2), (2, 2), ((1, 0), (0, 1)), True, True),
])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_pool2d(rng, dtype, mode, window, strides, padding, ceil_mode, exclusive):
    x = rng.normal(size=(2, 11, 10, 5)).astype(np.float32)
    out = run_both("pool2d", [x], dtype, mode=mode, window=window,
                   strides=strides, padding=padding, ceil_mode=ceil_mode,
                   exclusive=exclusive)
    assert_close(out[0], dtype)


@pytest.mark.parametrize("mode", ["max", "avg"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_global_pool(rng, dtype, mode):
    x = rng.normal(size=(2, 7, 7, 16)).astype(np.float32)
    out = run_both("pool2d", [x], dtype, mode=mode, global_pooling=True)
    assert_close(out[0], dtype)


@pytest.mark.parametrize("op", ["pool2d", "pool2d_int8"])
def test_int8_max_pool(rng, op):
    """ResNet's stem pool on an int8 edge: 3x3 s2 ceil mode, -128 identity."""
    x = rng.integers(-128, 128, (2, 9, 9, 8)).astype(np.int8)
    out = run_both(op, [x], mode="max", window=(3, 3), strides=(2, 2),
                   padding=(0, 0), ceil_mode=True)
    assert_close(out[0])


@pytest.mark.parametrize("axis,act,bias,qs", [
    (1, None, True, None), (1, "relu", False, None), (2, "sigmoid", True, None),
    (1, "relu", True, 0.04),
])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_dense(rng, dtype, axis, act, bias, qs):
    x = rng.normal(size=(3, 4, 6)).astype(np.float32)
    k = 24 if axis == 1 else 6
    inputs = [x, rng.normal(0, 0.3, size=(k, 10)).astype(np.float32)]
    if bias:
        inputs.append(rng.normal(size=10).astype(np.float32))
    out = run_both("dense", inputs, dtype, axis=axis, activation=act,
                   has_bias=bias, quant_out_scale=qs)
    if qs is None:
        assert_close(out[0], dtype)
    else:
        assert_within_lsb(out[0], min_equal=0.99)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_softmax(rng, dtype):
    x = rng.normal(size=(4, 1000)).astype(np.float32) * 3
    assert_close(run_both("softmax", [x], dtype, axis=-1)[0], dtype)


def test_batch_norm_and_scale(rng):
    x = rng.normal(size=(2, 5, 5, 6)).astype(np.float32)
    mean = rng.normal(size=6).astype(np.float32)
    var = rng.uniform(0.5, 2, size=6).astype(np.float32)
    assert_close(run_both("batch_norm", [x, mean, var], eps=1e-3)[0])
    g, b = mean * 2, var - 1
    assert_close(run_both("scale", [x, g, b])[0])
    assert_close(run_both("scale", [x, g, b], bias_term=False)[0])


@pytest.mark.parametrize("act", ["relu", "relu6", "clipped_relu", "leaky_relu",
                                 "elu", "sigmoid", "tanh", "swish", "gelu",
                                 "soft_sign", "softplus", "abs", "identity"])
def test_activation(rng, act):
    x = rng.normal(size=(3, 40)).astype(np.float32) * 4
    assert_close(run_both("activation", [x], activation=act, act_alpha=0.3)[0])


@pytest.mark.parametrize("mode,coeffs", [
    ("sum", None), ("sum", (0.5, -2.0, 1.5)), ("prod", None), ("max", None),
    ("min", None), ("sub", None), ("div", None),
])
def test_eltwise(rng, mode, coeffs):
    n = 2 if mode in ("sub", "div") else 3
    xs = [rng.uniform(0.5, 2, size=(2, 4, 4, 3)).astype(np.float32)
          for _ in range(n)]
    assert_close(run_both("eltwise", xs, mode=mode, coeffs=coeffs,
                          activation="relu")[0])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_space_to_depth_and_flatten(rng, dtype):
    x = rng.normal(size=(2, 8, 6, 3)).astype(np.float32)
    assert_close(run_both("space_to_depth", [x], dtype, block=2)[0], dtype)
    assert_close(run_both("flatten", [x], dtype, axis=1)[0], dtype)
    assert_close(run_both("flatten", [x], dtype, axis=2)[0], dtype)


# ------------------------------------------------------------------ int8


def test_quantize_dequantize(rng):
    x = rng.normal(size=(4, 50)).astype(np.float32) * 3
    x[0, :4] = [0.25, 0.75, -0.25, 1.25]  # exact halves: half-to-even
    assert_close(run_both("quantize", [x], scale=0.5)[0])
    q = rng.integers(-127, 128, (4, 50)).astype(np.int8)
    assert_close(run_both("dequantize", [q], scale=0.03)[0])
    got, want = run_both("dequantize", [q], scale=0.03, dtype="bfloat16")[0]
    np.testing.assert_array_equal(got, want)


def _int8_conv_inputs(rng, x_shape, k, cout, bias, res_shape, float_input=False):
    cin = x_shape[-1]
    x = (rng.normal(size=x_shape).astype(np.float32) if float_input
         else rng.integers(-127, 128, x_shape).astype(np.int8))
    inputs = [x, rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8),
              rng.uniform(0.001, 0.01, cout).astype(np.float32)]
    if bias:
        inputs.append(rng.normal(size=cout).astype(np.float32))
    if res_shape is not None:
        inputs.append(rng.integers(-127, 128, res_shape).astype(np.int8))
    return inputs


@pytest.mark.parametrize("k,padding,act,bias,res,out_scale", [
    (1, (0, 0), "relu", True, False, 0.2),
    (1, (0, 0), None, True, True, 0.3),
    (1, (0, 0), "relu", True, True, None),
    (3, (1, 1), "relu", True, False, 0.15),
    (3, (1, 1), "relu6", False, True, 0.3),
    (3, (1, 1), None, True, True, None),
])
def test_conv2d_int8_kernel_routes(rng, monkeypatch, k, padding, act, bias,
                                   res, out_scale):
    """The "gemm" and "conv3x3" kinds against the JAX op on its Pallas
    route (interpret mode): the same arithmetic, so int8 outputs are equal."""
    monkeypatch.setenv("ANAKIN_PALLAS_INTERPRET", "1")
    inputs = _int8_conv_inputs(rng, (2, 6, 7, 32), k, 48, bias,
                               (2, 6, 7, 48) if res else None)
    out = run_both("conv2d_int8", inputs, strides=(1, 1), padding=padding,
                   has_bias=bias, has_residual=res, activation=act,
                   in_scale=0.05, out_scale=out_scale, residual_scale=0.04,
                   impl="pallas")
    if out_scale is None:
        got, want = out[0]
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()))
    else:
        assert_close(out[0])


@pytest.mark.parametrize("k,strides,padding,float_input", [
    (3, (2, 2), (1, 1), False),      # ResNet's strided 3x3
    (1, (2, 2), (0, 0), False),      # ResNet's strided 1x1 shortcut
    (3, (1, 1), (0, 0), True),       # unpadded 3x3: "other" kind as well
    (3, (2, 1), ((1, 0), (0, 1)), False),
])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_conv2d_int8_other_kind(rng, dtype, k, strides, padding, float_input):
    """im2col + matmul_int8 against the JAX op's XLA int8 conv: within one
    LSB (divide vs reciprocal; in bf16 the JAX route also forms
    in_scale * w_scale in bf16)."""
    inputs = _int8_conv_inputs(rng, (2, 9, 8, 16), k, 24, True, None,
                               float_input)
    out = run_both("conv2d_int8", inputs, dtype, strides=strides,
                   padding=padding, has_bias=True, activation="relu",
                   in_scale=0.05, out_scale=0.4)
    assert_within_lsb(out[0], min_equal=0.95)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("out_scale", [None, 0.5])
def test_dense_int8(rng, monkeypatch, impl, out_scale):
    """The classifier: a float input quantized inline, then matmul_int8."""
    monkeypatch.setenv("ANAKIN_PALLAS_INTERPRET", "1")
    x = rng.normal(size=(3, 64)).astype(np.float32) * 2
    inputs = [x, rng.integers(-127, 128, (64, 40)).astype(np.int8),
              rng.uniform(0.001, 0.01, 40).astype(np.float32),
              rng.normal(size=40).astype(np.float32)]
    out = run_both("dense_int8", inputs, has_bias=True, in_scale=0.03,
                   out_scale=out_scale, impl=impl)
    got, want = out[0]
    if out_scale is not None:
        assert_within_lsb(out[0], min_equal=1.0 if impl == "pallas" else 0.95)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("prec", ["highest", "high", "medium"])
def test_full_fp32_restores_the_callers_setting(prec):
    """The float ops' TF32 scope: full float32 inside, the caller's
    matmul precision and cuDNN TF32 flag back outside, on an exception
    too."""
    from anakin_tpu_torch.ops.nn import full_fp32

    saved = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    try:
        torch.set_float32_matmul_precision(prec)
        torch.backends.cudnn.allow_tf32 = True
        with full_fp32():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == prec
        assert torch.backends.cudnn.allow_tf32
        with pytest.raises(KeyError):
            with full_fp32():
                raise KeyError("inside")
        assert torch.get_float32_matmul_precision() == prec
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


class _MatmulPrecisions(TorchDispatchMode):
    """Records the float32 matmul precision in force at every float32
    matrix product that reaches ATen."""

    PRODUCTS = ("mm", "bmm", "addmm", "baddbmm", "addbmm")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if (func.overloadpacket.__name__ in self.PRODUCTS
                and args[0].dtype == torch.float32):
            self.seen.append(torch.get_float32_matmul_precision())
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("which", ["dense", "project"])
def test_float32_products_ignore_high_precision(rng, which):
    """A `dense` node and the attention projection under the process-wide
    `set_float32_matmul_precision("high")` (TF32 on a CUDA card): every
    float32 product they issue runs at "highest", and the result is within
    1e-6 of |x| @ |w| of a float64 reference (float32 rounding gives ~4e-8
    at K = 2048 on an H100, TF32 some 6e-5; this CPU has no TF32, so the
    recorded precision is what can fail here)."""
    from anakin_tpu_torch.ops.attention import _project

    x = rng.normal(size=(4, 3, 256)).astype(np.float32)
    w = rng.normal(size=(256, 64)).astype(np.float32)
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with _MatmulPrecisions() as rec:
            if which == "dense":
                node = Node("n", "dense", ["x", "w"], ["y"], dict(axis=2))
                got = get_op("dense")(node, [torch.from_numpy(x),
                                             torch.from_numpy(w)])[0]
            else:
                got = _project(torch.from_numpy(x), torch.from_numpy(w), 2, 32)
                got = got.permute(0, 2, 1, 3).reshape(4, 3, 64)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)
    assert rec.seen and set(rec.seen) == {"highest"}, rec.seen
    want = x.astype(np.float64) @ w.astype(np.float64)
    mag = np.abs(x).astype(np.float64) @ np.abs(w).astype(np.float64)
    assert (np.abs(got.numpy() - want) <= 1e-6 * mag).all()
