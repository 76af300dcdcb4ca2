"""The port's fused int8 bottleneck (`kernels.bottleneck_int8`, its plain
version on the CPU) against the JAX package's Pallas kernel in interpret
mode, against the port's own unfused chain, and on the identity blocks of a
ResNet-50 at 32 px, batch 2.

Tolerances, and why:
  * int8 outputs against the Pallas kernel: within 1 LSB on at most 1% of
    the elements, the JAX package's own test's limit (XLA on the CPU may
    contract `acc * scale + bias` into one FMA and so round a value on a
    .5 boundary the other way).  Measured: equal everywhere, at the four
    int8 cases and the eight ResNet blocks.
  * float outputs against the Pallas kernel: rtol and atol 1e-4, as the
    JAX package's test holds its kernel.  Measured: 1.5e-8 at most
    (float32, largest value 1.58), bf16 equal.
  * the fused plain version against the unfused chain, and a block of the
    port's net against the net's own output: equal, bit for bit (the same
    float32 steps in the same order).
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import anakin_tpu as ak
from anakin_tpu.kernels.bottleneck_int8 import bottleneck_int8 as jax_bottleneck
from anakin_tpu.models import build_resnet50 as jax_build_resnet50
from anakin_tpu.ops.quantized import _pallas_eligible
from anakin_tpu.quant import calibrate
from anakin_tpu.quant import quantize_graph as jax_quantize_graph
import anakin_tpu_torch as pt
from anakin_tpu_torch.convert import graph_from_jax
from anakin_tpu_torch.graph.ir import topological_order
from anakin_tpu_torch.kernels import conv3x3_int8, matmul_int8
from anakin_tpu_torch.kernels.bottleneck_int8 import (bottleneck_int8,
                                                      identity_block,
                                                      pad_block)
from anakin_tpu_torch.kernels.matmul_int8 import prepare_b
from anakin_tpu_torch.models import identity_bottlenecks

from test_torch_kernels import _Elsewhere

SCALES = dict(in_scale=2e-2, a_scale=1.5e-2, b_scale=1.2e-2, res_scale=2e-2)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (H, W, C, P, bias, out): the JAX package's three cases
# (tests/test_bottleneck_kernel.py), an H and W that are not multiples of 8
# and not equal, and a bf16 output
CASES = [
    (8, 8, 256, 128, True, "int8"),
    (8, 8, 256, 128, False, "float32"),
    (12, 12, 128, 128, True, "int8"),
    (9, 11, 128, 64, True, "int8"),
    (8, 8, 128, 64, True, "bfloat16"),
]


def _block_inputs(rng, H, W, C, P, bias, N=2):
    """x, wa, wsa, wb, wsb, wc, wsc, ba, bb, bc as the JAX test makes them."""
    x = rng.integers(-80, 80, (N, H, W, C)).astype(np.int8)
    wa = rng.integers(-60, 60, (C, P)).astype(np.int8)
    wb = rng.integers(-20, 20, (3, 3, P, P)).astype(np.int8)
    wc = rng.integers(-60, 60, (P, C)).astype(np.int8)
    ws = [rng.uniform(1e-4, 3e-4, n).astype(np.float32) for n in (P, P, C)]
    bs = [rng.normal(0, 0.1, n).astype(np.float32) if bias else None
          for n in (P, P, C)]
    return [x, wa, ws[0], wb, ws[1], wc, ws[2]] + bs


def _torch(arrays):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
            for a in arrays]


def _jax(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _out_kw(out):
    """(port kwargs, JAX kwargs) of an output kind."""
    if out == "int8":
        return dict(out_scale=2.5e-2), dict(out_scale=2.5e-2)
    return (dict(out_dtype=_DTYPES[out]),
            dict(out_dtype=jnp.dtype(out)))


def _near_pallas(got: torch.Tensor, want):
    """The tolerance of the module docstring."""
    want = np.asarray(want)
    if want.dtype == np.int8:
        assert got.dtype == torch.int8
        d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 0.01, (d.max(), (d > 0).mean())
    else:
        assert str(got.dtype).endswith(want.dtype.name)
        np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("H,W,C,P,bias,out", CASES)
def test_bottleneck_plain_matches_pallas(rng, H, W, C, P, bias, out):
    arrays = _block_inputs(rng, H, W, C, P, bias)
    kw_t, kw_j = _out_kw(out)
    want = jax_bottleneck(*_jax(arrays), **SCALES, **kw_j, interpret=True)
    got = bottleneck_int8(*_torch(arrays), **SCALES, **kw_t)
    assert tuple(got.shape) == (2, H, W, C)
    _near_pallas(got, want)


@pytest.mark.parametrize("H,W,C,P,bias,out", CASES)
def test_bottleneck_equals_unfused_chain(rng, H, W, C, P, bias, out):
    """The fused block against the port's own three kernels called one
    after the other (their plain versions here): bit-equal."""
    x, wa, wsa, wb, wsb, wc, wsc, ba, bb, bc = _torch(
        _block_inputs(rng, H, W, C, P, bias))
    kw_t, _ = _out_kw(out)
    got = bottleneck_int8(x, wa, wsa, wb, wsb, wc, wsc, ba, bb, bc, **SCALES,
                          **kw_t)
    rows = x.reshape(-1, C)
    a = matmul_int8(rows, wa, wsa, ba, in_scale=SCALES["in_scale"],
                    activation="relu", out_scale=SCALES["a_scale"])
    b = conv3x3_int8(a.reshape(2, H, W, P), wb, wsb, bb,
                     in_scale=SCALES["a_scale"], activation="relu",
                     out_scale=SCALES["b_scale"])
    want = matmul_int8(b.reshape(-1, P), wc, wsc, bc, rows,
                       in_scale=SCALES["b_scale"], activation="relu",
                       residual_scale=SCALES["res_scale"], **kw_t)
    assert got.dtype == want.dtype
    assert torch.equal(got, want.reshape(got.shape))


@pytest.mark.parametrize("H,W,C,P,bias,out", CASES)
def test_bottleneck_takes_prepared_weights(rng, H, W, C, P, bias, out):
    """wa, wb and wc as `prepare_b` copies (the [N][K] layout the CUDA
    kernel reads, as a Net holds them): equal to the raw-weight call, and
    to the Pallas kernel in interpret mode within the module's tolerance."""
    arrays = _block_inputs(rng, H, W, C, P, bias)
    kw_t, kw_j = _out_kw(out)
    x, wa, wsa, wb, wsb, wc, wsc, ba, bb, bc = _torch(arrays)
    raw = bottleneck_int8(x, wa, wsa, wb, wsb, wc, wsc, ba, bb, bc, **SCALES,
                          **kw_t)
    got = bottleneck_int8(x, prepare_b(wa), wsa, prepare_b(wb), wsb,
                          prepare_b(wc), wsc, ba, bb, bc, **SCALES, **kw_t)
    assert got.dtype == raw.dtype and torch.equal(got, raw)
    want = jax_bottleneck(*_jax(arrays), **SCALES, **kw_j, interpret=True)
    _near_pallas(got, want)


def test_bottleneck_refuses_a_changed_prepared_weight(rng):
    """A prepared copy remembers its weight's version counter: once the
    weight is changed in place, the call raises instead of computing with
    the stale copy."""
    x, wa, wsa, wb, wsb, wc, wsc, ba, bb, bc = _torch(
        _block_inputs(rng, 8, 8, 128, 64, True))
    pa, pb, pc = prepare_b(wa), prepare_b(wb), prepare_b(wc)
    bottleneck_int8(x, pa, wsa, pb, wsb, pc, wsc, ba, bb, bc, **SCALES)
    wb[0, 0, 0, 0] += 1
    with pytest.raises(RuntimeError, match="changed in place"):
        bottleneck_int8(x, pa, wsa, pb, wsb, pc, wsc, ba, bb, bc, **SCALES)


def test_bottleneck_prepared_on_meta_gives_shapes():
    """Prepared weights on the meta device (shape inference): a meta result
    of the output's shape and type, and no launch."""
    args = _zeros(H=5, W=7, device="meta")
    for i in (1, 3, 5):
        args[i] = prepare_b(args[i])
    launches = bottleneck_int8.launches
    y = bottleneck_int8(*args, **SCALES, out_scale=0.5)
    assert y.device.type == "meta" and y.dtype == torch.int8
    assert tuple(y.shape) == (1, 5, 7, 64)
    assert bottleneck_int8.launches == launches


@pytest.mark.parametrize("C,P,out", [(32, 8, "int8"), (32, 8, "float32"),
                                     (96, 40, "int8")])
def test_narrow_block_padded_equals_the_narrow_block(rng, C, P, out):
    """A block whose C or P is not a multiple of 64 (C 32 / P 8: Faster
    R-CNN's first stage at base_width 8) goes to the CUDA kernel widened
    with zero channels (`pad_block`) and sliced back: that computation,
    run here through the plain version on the prepared padded weights,
    equals the narrow block bit for bit, which equals the Pallas kernel in
    interpret mode."""
    arrays = _block_inputs(rng, 6, 5, C, P, True)
    kw_t, kw_j = _out_kw(out)
    args = _torch(arrays)
    narrow = bottleneck_int8(*args, **SCALES, **kw_t)
    padded = pad_block(*args)
    assert tuple(padded[0].shape) == (2, 6, 5, 64 * -(-C // 64))
    assert padded[1].shape == (64 * -(-C // 64), 64 * -(-P // 64))
    wide = bottleneck_int8(*padded, **SCALES, **kw_t)
    assert torch.equal(wide[..., :C], narrow)
    assert not wide[..., C:].any()    # the zero channels stay zero
    prepared = pad_block(args[0], prepare_b(args[1]), args[2],
                         prepare_b(args[3]), *args[4:])
    assert all(torch.equal(a.t, b.t) for a, b in zip(prepared[1:6:2],
                                                      padded[1:6:2]))
    want = jax_bottleneck(*_jax(arrays), **SCALES, **kw_j, interpret=True)
    _near_pallas(narrow, want)


# ------------------------------------------------------------ ResNet-50

@pytest.fixture(scope="module")
def resnet():
    """The JAX quantized ResNet-50 at 32 px, b2 (Pallas route forced where
    eligible), its input, and every edge of the JAX net per precision."""
    g = ak.optimize(jax_build_resnet50(batch=2, image_size=32))
    x = np.random.default_rng(7).normal(size=(2, 32, 32, 3)).astype(np.float32)
    gq = jax_quantize_graph(g, calibrate(g, [{"input": x}], method="max"))
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
    return dict(g=graph_from_jax(gq), x=x, taps=taps)


def test_resnet50_has_twelve_identity_blocks(resnet):
    """2 / 3 / 5 / 2 over the four stages, each 1x1 -> 3x3 -> 1x1 with
    C = 4 P; the downsample blocks are not among them."""
    g = resnet["g"]
    blocks = identity_bottlenecks(g)
    widths = [g.params[a.inputs[1]].shape[3] for a, _, _ in blocks]
    assert widths == [64] * 2 + [128] * 3 + [256] * 5 + [512] * 2
    for a, b, c in blocks:
        assert g.params[c.inputs[1]].shape[2:] == (
            g.params[a.inputs[1]].shape[3], g.params[a.inputs[1]].shape[2])
        assert c.inputs[-1] == a.inputs[0]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_identity_blocks_equal_the_net(resnet, precision):
    """Each identity block through the fused kernel (plain version), from
    the port net's tapped input and with its params (bf16-cast in a bf16
    net), equals the net's own block output: int8 blocks bit for bit, the
    last block's float32 output too."""
    g = resnet["g"]
    edges = [e for n in topological_order(g) for e in n.outputs]
    net = pt.Net(g, precision=precision, device="cpu", tap_edges=edges)
    taps = net.prediction({"input": resnet["x"]})
    blocks = identity_bottlenecks(g)
    launches = bottleneck_int8.launches
    for block in blocks:
        a, _, c = block
        got = identity_block(block, net.params, taps[a.inputs[0]])
        want = taps[c.outputs[0]]
        assert got.dtype == want.dtype and got.shape == want.shape, c.name
        assert torch.equal(got, want), c.name
    assert taps[blocks[-1][2].outputs[0]].dtype == torch.float32
    assert bottleneck_int8.launches == launches  # the CPU launches nothing


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_identity_blocks_take_the_nets_prepared_weights(resnet, precision):
    """`identity_block(..., prepared=net.prepared)` hands the kernel the
    copies the Net made for nodes A, B and C when it was built: each block
    equals the net's own block output, and no weight is prepared again."""
    g = resnet["g"]
    edges = [e for n in topological_order(g) for e in n.outputs]
    net = pt.Net(g, precision=precision, device="cpu", tap_edges=edges)
    taps = net.prediction({"input": resnet["x"]})
    calls = prepare_b.calls
    for block in identity_bottlenecks(g):
        a, _, c = block
        got = identity_block(block, net.params, taps[a.inputs[0]],
                             prepared=net.prepared)
        want = taps[c.outputs[0]]
        assert got.dtype == want.dtype and torch.equal(got, want), c.name
    assert prepare_b.calls == calls


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_identity_block_matches_pallas_kernel(resnet, precision, stage):
    """The first identity block of each stage from the JAX net's tapped
    input: the port's fused block against the JAX Pallas bottleneck kernel
    with the same params, each side as its net holds them."""
    g = resnet["g"]
    blocks = identity_bottlenecks(g)
    first = [0, 2, 5, 10][stage]
    block = blocks[first]
    a, b, c = block
    params = pt.Net(g, precision=precision, device="cpu").params
    x = resnet["taps"][precision][a.inputs[0]]
    assert x.dtype == np.int8
    got = identity_block(block, params, torch.from_numpy(np.array(x)))

    def arr(e, shape=None):
        v = params[e].float() if params[e].is_floating_point() else params[e]
        v = v.numpy()
        return jnp.asarray(v if shape is None else v.reshape(shape))

    C, P = x.shape[3], params[a.inputs[1]].shape[3]
    out_scale = c.attr("out_scale")
    want = jax_bottleneck(
        jnp.asarray(x), arr(a.inputs[1], (C, P)), arr(a.inputs[2]),
        arr(b.inputs[1]), arr(b.inputs[2]), arr(c.inputs[1], (P, C)),
        arr(c.inputs[2]), arr(a.inputs[3]), arr(b.inputs[3]), arr(c.inputs[3]),
        in_scale=float(a.attr("in_scale")), a_scale=float(a.attr("out_scale")),
        b_scale=float(b.attr("out_scale")),
        res_scale=float(c.attr("residual_scale")),
        out_scale=None if out_scale is None else float(out_scale),
        interpret=True)
    _near_pallas(got, want)


# ------------------------------------------------------- argument checks

def _zeros(H=4, W=4, C=64, P=64, device="cpu"):
    i8 = dict(dtype=torch.int8, device=device)
    return [torch.zeros((1, H, W, C), **i8), torch.zeros((C, P), **i8),
            torch.ones(P, device=device), torch.zeros((3, 3, P, P), **i8),
            torch.ones(P, device=device), torch.zeros((P, C), **i8),
            torch.ones(C, device=device)]


@pytest.mark.parametrize("which,shape", [(1, (64, 32)), (3, (3, 3, 64, 32)),
                                         (3, (1, 1, 64, 64)), (5, (64, 32)),
                                         (2, (32,)), (6, (64, 1))])
def test_bottleneck_refuses_wrong_shapes(which, shape):
    args = _zeros()
    args[which] = torch.zeros(shape, dtype=args[which].dtype)
    with pytest.raises(ValueError):
        bottleneck_int8(*args, **SCALES)


@pytest.mark.parametrize("which", [0, 1, 3, 5])
def test_bottleneck_refuses_non_int8(which):
    args = _zeros()
    args[which] = args[which].float()
    with pytest.raises(TypeError):
        bottleneck_int8(*args, **SCALES)


def test_bottleneck_refuses_other_devices_and_takes_meta():
    """A device that is neither CPU nor CUDA raises; a meta tensor (shape
    inference) gets a meta result of the output's shape and type; a wrong
    out_dtype raises."""
    args = [_Elsewhere(t.shape, t.dtype) for t in _zeros()]
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        bottleneck_int8(*args, **SCALES)
    launches = bottleneck_int8.launches
    meta = _zeros(H=5, W=7, device="meta")
    y = bottleneck_int8(*meta, **SCALES, out_scale=0.5)
    assert y.device.type == "meta" and y.dtype == torch.int8
    assert tuple(y.shape) == (1, 5, 7, 64)
    y = bottleneck_int8(*meta, **SCALES, out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16 and bottleneck_int8.launches == launches
    with pytest.raises(TypeError):
        bottleneck_int8(*_zeros(), **SCALES, out_dtype=torch.int32)
