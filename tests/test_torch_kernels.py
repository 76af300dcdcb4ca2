"""The port's int8 kernels (plain versions, on the CPU) against the JAX
package's Pallas kernels run in interpret mode, on the same seeded inputs.

Tolerances: int8 outputs must be equal (both sides do the same float32
operations in the same order on an exact accumulator).  Float outputs use
rtol 1e-6 and an atol of 1e-6 of the largest output: XLA on the CPU
contracts `acc * scale + bias` into one fused multiply-add, where the port
rounds the product first (as its CUDA kernel does), so the two differ by an
ulp of the product, which is large beside an output that cancels to near 0.
sigmoid/tanh may also differ in their last bits between libraries.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from anakin_tpu.kernels.conv_int8 import conv3x3_int8 as jax_conv3x3_int8
from anakin_tpu.kernels.depthwise_int8 import \
    depthwise3x3_int8 as jax_depthwise3x3_int8
from anakin_tpu.kernels.matmul_int8 import matmul_int8 as jax_matmul_int8
from anakin_tpu.graph.ir import Node as JaxNode
from anakin_tpu.ops import get_op as jax_get_op
from anakin_tpu_torch.kernels import _build
from anakin_tpu_torch.kernels.conv_int8 import conv3x3_int8
from anakin_tpu_torch.kernels.depthwise_int8 import depthwise3x3_int8
from anakin_tpu_torch.kernels.matmul_int8 import matmul_int8
from anakin_tpu_torch.graph.ir import Node
from anakin_tpu_torch.ops import get_op

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _to_torch(a):
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _epilogue_inputs(rng, rows_shape, n, bias, residual):
    """w_scale, bias, the residual as the port takes it, the residual as
    the Pallas kernel takes it (the op path dequantizes int8 first), and
    residual_scale."""
    ws = rng.uniform(0.001, 0.01, n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32) if bias else None
    res_port = res_jax = rs = None
    if residual == "int8":
        res_port = rng.integers(-127, 128, rows_shape + (n,)).astype(np.int8)
        rs = 0.037
        res_jax = jnp.asarray(res_port).astype(jnp.float32) * rs
    elif residual == "float32":
        res_port = rng.normal(size=rows_shape + (n,)).astype(np.float32)
        res_jax = jnp.asarray(res_port)
    elif residual == "bfloat16":
        res_jax = jnp.asarray(rng.normal(size=rows_shape + (n,))
                              .astype(np.float32)).astype(jnp.bfloat16)
        res_port = np.asarray(res_jax)
    return ws, b, res_port, res_jax, rs


def _compare(got: torch.Tensor, want):
    want = np.asarray(want)
    if want.dtype == np.int8:
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert str(got.dtype).endswith(want.dtype.name)
        want = want.astype(np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()))


# (activation, bias, residual, out_scale, out_dtype)
_EPILOGUES = [
    (None, False, None, None, "float32"),
    ("relu", True, None, 0.7, "float32"),
    ("relu", True, "int8", 0.9, "float32"),
    ("relu", True, "float32", None, "float32"),
    ("relu6", False, "bfloat16", 0.05, "float32"),
    ("leaky_relu", True, "int8", None, "bfloat16"),
    ("identity", True, "float32", 0.3, "float32"),
]


@pytest.mark.parametrize("M,K,N", [(37, 200, 300), (64, 256, 128), (5, 24, 13)])
@pytest.mark.parametrize("act,bias,residual,out_scale,out_dtype", _EPILOGUES)
def test_matmul_int8_plain_matches_pallas(rng, M, K, N, act, bias, residual,
                                          out_scale, out_dtype):
    a = rng.integers(-127, 128, (M, K)).astype(np.int8)
    b = rng.integers(-127, 128, (K, N)).astype(np.int8)
    ws, bi, res_port, res_jax, rs = _epilogue_inputs(rng, (M,), N, bias, residual)
    kw = dict(in_scale=0.05, activation=act, act_alpha=0.1, out_scale=out_scale)
    want = jax_matmul_int8(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(ws),
        None if bi is None else jnp.asarray(bi), res_jax,
        out_dtype=jnp.dtype(out_dtype), interpret=True, **kw)
    got = matmul_int8(_to_torch(a), _to_torch(b), _to_torch(ws), _to_torch(bi),
                      _to_torch(res_port), out_dtype=_TORCH_DTYPES[out_dtype],
                      residual_scale=rs, **kw)
    _compare(got, want)


@pytest.mark.parametrize("act,out_scale", [("sigmoid", None), ("tanh", None),
                                           ("sigmoid", 0.01), ("tanh", 0.02)])
def test_matmul_int8_transcendental_epilogue(rng, act, out_scale):
    M, K, N = 48, 96, 40
    a = rng.integers(-127, 128, (M, K)).astype(np.int8)
    b = rng.integers(-127, 128, (K, N)).astype(np.int8)
    ws = rng.uniform(0.0001, 0.001, N).astype(np.float32)
    kw = dict(in_scale=0.01, activation=act, out_scale=out_scale)
    want = jax_matmul_int8(jnp.asarray(a), jnp.asarray(b), jnp.asarray(ws),
                           interpret=True, **kw)
    got = matmul_int8(_to_torch(a), _to_torch(b), _to_torch(ws), **kw)
    _compare(got, want)


@pytest.mark.parametrize("N,H,W,C,O", [(2, 8, 12, 64, 128), (1, 7, 9, 33, 20),
                                       (3, 4, 4, 16, 48)])
@pytest.mark.parametrize("act,bias,residual,out_scale,out_dtype", _EPILOGUES)
def test_conv3x3_int8_plain_matches_pallas(rng, N, H, W, C, O, act, bias,
                                           residual, out_scale, out_dtype):
    x = rng.integers(-127, 128, (N, H, W, C)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, C, O)).astype(np.int8)
    ws, bi, res_port, res_jax, rs = _epilogue_inputs(rng, (N, H, W), O, bias,
                                                     residual)
    kw = dict(in_scale=0.02, activation=act, act_alpha=0.1, out_scale=out_scale)
    want = jax_conv3x3_int8(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(ws),
        None if bi is None else jnp.asarray(bi), res_jax,
        out_dtype=jnp.dtype(out_dtype), interpret=True, **kw)
    got = conv3x3_int8(_to_torch(x), _to_torch(w), _to_torch(ws), _to_torch(bi),
                       _to_torch(res_port), out_dtype=_TORCH_DTYPES[out_dtype],
                       residual_scale=rs, **kw)
    _compare(got, want)


_DW_SPECS = [  # the JAX package's own depthwise cases, tests/test_kernels.py
    dict(shape=(2, 16, 16, 128), act="relu6", out_scale=0.07, bias=True),
    dict(shape=(1, 14, 14, 256), act=None, out_scale=None, bias=False),
    dict(shape=(2, 12, 20, 64), act="relu", out_scale=0.11, bias=True),
    # ragged C, leaky_relu, bf16 out
    dict(shape=(2, 10, 6, 40), act="leaky_relu", out_scale=0.09, bias=True),
    dict(shape=(1, 8, 12, 24), act="leaky_relu", out_scale=None, bias=True,
         out_dtype="bfloat16"),
    dict(shape=(2, 6, 8, 48), act="relu6", out_scale=None, bias=True,
         out_dtype="bfloat16"),
]


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("spec", _DW_SPECS)
def test_depthwise3x3_int8_plain_matches_pallas(rng, stride, spec):
    """int8 outputs within 1 LSB with at least 99.9% equal (XLA on the CPU
    may contract the JAX epilogue into an FMA, which can move a value
    across a rounding edge); float outputs as `_compare`."""
    N, H, W, C = spec["shape"]
    out_dtype = spec.get("out_dtype", "float32")
    x = rng.integers(-127, 128, (N, H, W, C)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, 1, C)).astype(np.int8)
    ws = rng.uniform(0.001, 0.01, C).astype(np.float32)
    bias = rng.normal(0, 0.5, C).astype(np.float32) if spec["bias"] else None
    kw = dict(stride=stride, in_scale=0.05, activation=spec["act"],
              act_alpha=0.1, out_scale=spec["out_scale"])
    want = jax_depthwise3x3_int8(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(ws),
        None if bias is None else jnp.asarray(bias),
        out_dtype=jnp.dtype(out_dtype), interpret=True, **kw)
    got = depthwise3x3_int8(_to_torch(x), _to_torch(w), _to_torch(ws),
                            _to_torch(bias), out_dtype=_TORCH_DTYPES[out_dtype],
                            **kw)
    assert tuple(got.shape) == tuple(want.shape)
    if spec["out_scale"] is not None:
        assert got.dtype == torch.int8
        d = np.abs(got.numpy().astype(np.int32) - np.asarray(want, np.int32))
        assert d.max() <= 1 and (d == 0).mean() >= 0.999
    else:
        _compare(got, want)


@pytest.mark.parametrize("act", ["sigmoid", "tanh"])
def test_depthwise3x3_int8_refuses_transcendental_epilogue(act):
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    w = torch.zeros((3, 3, 1, 8), dtype=torch.int8)
    with pytest.raises(ValueError):
        depthwise3x3_int8(x, w, torch.ones(8), in_scale=1.0, activation=act)


@pytest.mark.parametrize("shape", [(1, 5, 4, 8), (1, 4, 7, 8), (2, 25, 25, 16),
                                   (1, 7, 9, 24)])
def test_depthwise3x3_int8_takes_odd_size_at_stride_2(rng, shape):
    """A stride-2 "dw3x3" node over an odd H or W (MobileNet v1 at 200 px
    reaches 25 x 25): the port's `conv2d_int8` (depthwise3x3_int8) against
    the JAX package's default route (XLA) on the same node.  int8 outputs
    equal: out_scale is a power of two, so the JAX route's divide and the
    kernel's reciprocal multiply round alike."""
    N, H, W, C = shape
    x = rng.integers(-127, 128, shape).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, 1, C)).astype(np.int8)
    ws = rng.uniform(0.001, 0.01, C).astype(np.float32)
    b = rng.normal(size=C).astype(np.float32)
    attrs = dict(strides=(2, 2), padding=(1, 1), groups=C, has_bias=True,
                 has_residual=False, activation="relu6", in_scale=0.05,
                 out_scale=0.25)
    names = ["x", "w", "w_scale", "bias"]
    want = np.asarray(jax_get_op("conv2d_int8")(
        JaxNode("dw", "conv2d_int8", names, ["out"], dict(attrs)),
        [jnp.asarray(v) for v in (x, w, ws, b)])[0])
    got = get_op("conv2d_int8")(Node("dw", "conv2d_int8", names, ["out"],
                                     dict(attrs)),
                                [_to_torch(v) for v in (x, w, ws, b)])[0]
    assert want.shape == (N, (H - 1) // 2 + 1, (W - 1) // 2 + 1, C)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_matmul_int8_exact_at_large_accumulators():
    """|acc| above 2**24 (K = 9*512, all operands at the int8 extreme):
    the accumulation must be exact before the float epilogue."""
    K = 9 * 512
    a = np.full((4, K), -127, np.int8)
    b = np.full((K, 3), 127, np.int8)
    b[0, 0] = 126  # one unit off: visible only to an exact sum
    got = matmul_int8(_to_torch(a), _to_torch(b), torch.ones(3), in_scale=1.0)
    want = (a.astype(np.int64) @ b.astype(np.int64)).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_conv3x3_int8_refuses_transcendental_epilogue(rng):
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    w = torch.zeros((3, 3, 8, 8), dtype=torch.int8)
    with pytest.raises(ValueError):
        conv3x3_int8(x, w, torch.ones(8), in_scale=1.0, activation="sigmoid")


class _Elsewhere(torch.Tensor):
    """A tensor that says it lies on a device that is neither CPU, CUDA nor
    meta, and refuses every operation."""

    @staticmethod
    def __new__(cls, shape, dtype):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=dtype,
                                                   device="xpu")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise AssertionError(f"{func} ran on a tensor of another device")


@pytest.mark.parametrize("fn,shapes", [
    (matmul_int8, ((4, 8), (8, 4))),
    (conv3x3_int8, ((1, 4, 4, 8), (3, 3, 8, 4))),
    (depthwise3x3_int8, ((1, 4, 4, 4), (3, 3, 1, 4))),
])
def test_wrappers_take_no_other_device(fn, shapes):
    """Off the CPU a wrapper launches its kernel or raises: a tensor on a
    device that is neither CPU nor CUDA gets no plain-version fallback.
    A meta tensor (shape inference) goes through the plain version and
    gives a meta tensor of the output's shape, with no launch counted."""
    a, b = (_Elsewhere(s, torch.int8) for s in shapes)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        fn(a, b, _Elsewhere((4,), torch.float32), in_scale=1.0)
    a, b = (torch.zeros(s, dtype=torch.int8, device="meta") for s in shapes)
    launches = fn.launches
    y = fn(a, b, torch.ones(4, device="meta"), in_scale=1.0, out_scale=0.5)
    assert y.device.type == "meta" and y.dtype == torch.int8
    assert tuple(y.shape) == shapes[0][:-1] + (4,) and fn.launches == launches


def test_kernels_build_lazily_and_name_their_sources():
    """Every kernel source exists; building needs the CUDA toolkit, so
    where there is none, loading a kernel raises instead of running
    anything else."""
    import os

    for name in _build.SOURCES:
        assert os.path.exists(os.path.join(_build.CSRC, name + ".cu"))
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        with pytest.raises(RuntimeError):
            _build.load("matmul_int8")
