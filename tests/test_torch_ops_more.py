"""The port's last tensor and nn op entries (`ops/tensor.py`: permute ...
coord2patch; `ops/nn.py`: pool2d_with_index ... maxout) against the JAX
package's ops of the same names, on the same `Node` and the same seeded
inputs; the registry against the JAX package's, name for name; these
entries and the sequence ops on the `meta` device against
`jax.eval_shape`; and none of them reads a tensor on the host.

Tolerances, and why:
  * layout ops, selections, one_hot, topk, casts, integer results,
    max pooling with its indices, maxout: equal — they move values;
  * float32 arithmetic (sums, norms, matmul, exp / log / erf, spp's
    average, the scatter-add of unpool2d): rtol 1e-5, atol 1e-5, as
    `tests/test_torch_ops.py` — the two libraries sum in other orders and
    their transcendental functions may part in the last ulp;
  * bf16 outputs: rtol 8e-3, atol 1e-2 — one bf16 ulp (2**-8) after such a
    sum;
  * the reference's quirks are held as they are: `slice_v2` does not clamp
    a negative end or any start, `cumsum` with `reverse` ignores
    `exclusive`, `spp`'s average counts the padding, `gather` follows
    `jnp.take`'s default mode (an index in [-n, 0) counts from the end, any
    other index out of range gives NaN / the integer's lowest value),
    `one_hot` gives a zero row out of range, ties take the first maximum.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from anakin_tpu.graph.ir import Node as JaxNode
from anakin_tpu.ops import ALIASES as JAX_ALIASES
from anakin_tpu.ops import OPS as JAX_OPS
from anakin_tpu.ops import get_op as jax_get_op
from anakin_tpu_torch.graph.ir import Node
from anakin_tpu_torch.ops import ALIASES, OPS, get_op

from test_torch_detection import _NoHostSync
from test_torch_ops import assert_close, run_both

DTYPES = ["fp32", "bf16"]


def _equal(pair):
    got, want = pair
    np.testing.assert_array_equal(got, want)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------- registry


def test_registry_names_equal_the_jax_package():
    """The port's op names and aliases are the JAX package's, all 150, and
    each alias names the same op."""
    want = set(JAX_OPS) | set(JAX_ALIASES)
    assert set(OPS) | set(ALIASES) == want and len(want) == 150
    for alias, name in ALIASES.items():
        assert JAX_ALIASES.get(alias, alias) == name or alias in JAX_OPS, alias


def test_alias_resolves_as_the_jax_package(monkeypatch):
    """`alias` maps reference names (any case) to an op as the JAX
    package's does: `resolve_op_name` gives the same op on both sides,
    registered names pass through, an unknown name raises on both.  Each
    registry works on a copy of its alias table, so no name stays."""
    import anakin_tpu.ops.registry as jax_registry
    import anakin_tpu_torch.ops.registry as registry

    monkeypatch.setattr(jax_registry, "ALIASES", dict(jax_registry.ALIASES))
    monkeypatch.setattr(registry, "ALIASES", dict(registry.ALIASES))
    for reg in (jax_registry, registry):
        reg.alias("conv2d", "MyConvRef", "other_conv_ref")
    for name in ("MyConvRef", "myconvref", "OTHER_CONV_REF", "convolution",
                 "Pooling"):
        assert registry.resolve_op_name(name) == \
            jax_registry.resolve_op_name(name)
    assert registry.resolve_op_name("MyConvRef") == "conv2d"
    for reg in (jax_registry, registry):
        with pytest.raises(KeyError):
            reg.resolve_op_name("no_such_ref")


@pytest.mark.parametrize("axis", [0, 1, 2, 3])
def test_nchw_axis_to_nhwc_matches_jax(axis):
    """The NCHW -> NHWC axis map, each of the four axes, against the JAX
    package's."""
    from anakin_tpu.ops.tensor import nchw_axis_to_nhwc as jax_nchw_to_nhwc
    from anakin_tpu_torch.ops.tensor import nchw_axis_to_nhwc

    assert nchw_axis_to_nhwc(axis) == jax_nchw_to_nhwc(axis)


# ------------------------------------------------------------ tensor ops


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op,attrs", [
    ("permute", dict(order=(0, 3, 1, 2))),
    ("permute", dict(order=(2, 0, 3, 1))),
    ("transpose", {}),
    ("permute_power", dict(order=(0, 2, 1, 3))),
    ("permute_power", dict(order=(0, 3, 1, 2), power=2.0, scale=0.5,
                           shift=1.0)),
    ("permute_power", dict(order=(0, 3, 1, 2), power=0.5, scale=2.0,
                           shift=3.0)),
])
def test_permutes(rng, dtype, op, attrs):
    x = _normal(rng, 2, 3, 4, 5)
    (pair,) = run_both(op, [x], dtype, **attrs)
    if op == "permute_power" and "power" in attrs:
        assert_close(pair, dtype)
    else:
        _equal(pair)


def test_split_fans_out(rng):
    """One output per `num`, or per output edge without it."""
    x = _normal(rng, 2, 3)
    node = Node("n", "split", ["x"], ["a", "b", "c"], {})
    ys = get_op("split")(node, [torch.from_numpy(x)])
    assert len(ys) == 3 and all(np.array_equal(y.numpy(), x) for y in ys)
    pairs = run_both("split", [x], num=2)
    assert len(pairs) == 2
    for p in pairs:
        _equal(p)


@pytest.mark.parametrize("axes,starts,ends", [
    ((1,), (1,), (4,)),
    ((1, 2), (-3, 0), (-1, 100)),   # a negative start, an end past the axis
    ((0, 3), (0, 2), (-9, 5)),      # an end still negative after + dim
    ((2,), (7,), (9,)),             # a start past the axis: empty
    ((3,), (-10, ), (3,)),          # a start still negative after + dim
])
def test_slice_v2(rng, axes, starts, ends):
    x = _normal(rng, 2, 5, 6, 7)
    _equal(run_both("slice_v2", [x], axes=axes, starts=starts, ends=ends)[0])


@pytest.mark.parametrize("dtype", DTYPES + ["int8"])
@pytest.mark.parametrize("mode,ph,pw,pc,value", [
    ("constant", (1, 2), (0, 3), (0, 0), 0.0),
    ("constant", (0, 0), (2, 1), (1, 2), -1.5),
    ("reflect", (2, 1), (1, 3), (0, 0), 0.0),
    ("reflect", (4, 6), (0, 0), (2, 1), 0.0),   # wider than the axis - 1
    ("edge", (2, 0), (1, 4), (3, 1), 0.0),
])
def test_pad(rng, dtype, mode, ph, pw, pc, value):
    """pad / pad2d of NHWC H, W and C; "edge" is torch's replicate."""
    if dtype == "int8":
        x = rng.integers(-127, 128, (2, 4, 5, 3)).astype(np.int8)
        value = float(int(value))
    else:
        x = _normal(rng, 2, 4, 5, 3)
    for op in ("pad", "pad2d"):
        _equal(run_both(op, [x], dtype, pad_h=ph, pad_w=pw, pad_c=pc,
                        mode=mode, value=value)[0])


@pytest.mark.parametrize("r", [2, 3])
def test_pixel_shuffle(rng, r):
    x = _normal(rng, 2, 3, 4, 2 * r * r)
    _equal(run_both("pixel_shuffle", [x], upscale_factor=r)[0])


@pytest.mark.parametrize("reps", [(1, 2, 3), (2, 1, 1), (3,), (2, 2)])
def test_expand(rng, reps):
    x = _normal(rng, 2, 3, 4)
    _equal(run_both("expand", [x], expand_times=reps)[0])


@pytest.mark.parametrize("dtype", DTYPES + ["int8", "int32"])
@pytest.mark.parametrize("axis,idx", [
    (0, [[2, 0], [1, 1]]),
    (1, [3, -1, -4, 0]),           # negative indices count from the end
    (1, [4, -5, 100, -100, 2]),    # out of range: NaN / the lowest integer
    (-1, [0, 4, 5]),
])
def test_gather(rng, dtype, axis, idx):
    """`jnp.take`'s default mode, out-of-range indices included."""
    if dtype in ("int8", "int32"):
        x = rng.integers(-100, 100, (3, 4, 5)).astype(dtype)
    else:
        x = _normal(rng, 3, 4, 5)
    _equal(run_both("gather", [x, np.array(idx, np.int32)], dtype,
                    axis=axis)[0])


@pytest.mark.parametrize("to", ["float32", "int32", "int8", "bfloat16",
                                "float16", "bool"])
def test_cast(rng, to):
    x = (_normal(rng, 3, 5) * 40).astype(np.float32)
    x[0, :3] = [0.0, -0.0, 1.5]
    _equal(run_both("cast", [x], dtype=to)[0])


@pytest.mark.parametrize("depth", [1, 4, 7])
def test_one_hot(depth):
    """Indices below 0 and from `depth` on give zero rows."""
    ids = np.array([[-3, -1, 0, 1], [2, 3, 4, 9]], np.int32)
    _equal(run_both("one_hot", [ids], depth=depth)[0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 3, 6])
def test_topk_ties_take_the_lower_index(rng, dtype, k):
    x = np.round(_normal(rng, 3, 4, 6))
    x[0, 0] = [2.0, 2.0, 2.0, 1.0, 2.0, 0.0]
    x[1, 1] = 0.0
    x[1, 1, 2] = -0.0
    vals, idx = run_both("topk", [x], dtype, k=k)
    _equal(vals)
    _equal(idx)


@pytest.mark.parametrize("dtype", DTYPES + ["int8"])
@pytest.mark.parametrize("op,mode,axes,keep", [
    ("reduce", None, (1,), False),
    ("reduce", "sum", (1, 2), True),
    ("reduce", "max", None, False),
    ("reduce", "prod", (0, 2), False),
    ("reduce", "mean", (-1,), True),
    ("reduce_min", None, (2,), False),
    ("reduce_min", "min", None, True),
])
def test_reduce(rng, dtype, op, mode, axes, keep):
    """Integer sums and products in int32, an integer mean in float32, as
    JAX gives them."""
    if dtype == "int8":
        x = rng.integers(-3, 4, (2, 3, 4)).astype(np.int8)
    else:
        x = (_normal(rng, 2, 3, 4) * 0.5 + 1.0).astype(np.float32)
    attrs = dict(axes=axes, keep_dims=keep)
    if mode is not None:
        attrs["mode"] = mode
    pair = run_both(op, [x], dtype, **attrs)[0]
    if pair[1].dtype.kind in "iu":
        _equal(pair)
    else:
        assert_close(pair, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mean(rng, dtype):
    assert_close(run_both("mean", [_normal(rng, 2, 3, 5)], dtype)[0], dtype)


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
@pytest.mark.parametrize("axis,exclusive,reverse", [
    (-1, False, False), (1, True, False), (0, False, True),
    (2, True, True),   # reverse ignores exclusive, as in the reference
])
def test_cumsum(rng, dtype, axis, exclusive, reverse):
    if dtype == "int8":
        x = rng.integers(-20, 20, (3, 4, 5)).astype(np.int8)
    else:
        x = _normal(rng, 3, 4, 5)
    pair = run_both("cumsum", [x], dtype, axis=axis, exclusive=exclusive,
                    reverse=reverse)[0]
    (_equal if dtype == "int8" else assert_close)(pair)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["sum", "sub", "mul", 1, 2, 3])
def test_arithmetic(rng, dtype, mode):
    a, b = _normal(rng, 2, 3, 4), _normal(rng, 2, 3, 4)
    assert_close(run_both("arithmetic", [a, b], dtype, mode=mode)[0], dtype)


def test_reverse_input_and_coord2patch(rng):
    xs = [_normal(rng, 3, 2), _normal(rng, 4, 2, 2)]
    for pair in run_both("reverse_input", xs):
        _equal(pair)
    _equal(run_both("coord2patch", [xs[0]])[0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,strides,padding", [
    ((2, 2), (2, 2), (0, 0)),
    ((3, 2), (1, 2), (1, 0)),
    ((3, 3), (2, 1), (2, 1)),
])
def test_im2sequence(rng, dtype, window, strides, padding):
    """Columns in (C, KH, KW) order, C major."""
    x = _normal(rng, 2, 5, 6, 3)
    _equal(run_both("im2sequence", [x], dtype, window=window, strides=strides,
                    padding=padding)[0])


# ---------------------------------------------------------------- nn ops


def _first_max_in_window_order(x, window, strides, padding):
    """numpy: (the index of the first maximum of each window in row-major
    window order, how many taps of the window hold that maximum)."""
    (kh, kw), (sh, sw), (ph, pw) = window, strides, padding
    n, h, w, c = x.shape
    flat = np.broadcast_to((np.arange(h)[:, None] * w + np.arange(w))[
        None, :, :, None], x.shape)
    xp = np.pad(x, ((0, 0), (ph, ph), (pw, pw), (0, 0)),
                constant_values=-np.inf)
    ip = np.pad(flat, ((0, 0), (ph, ph), (pw, pw), (0, 0)),
                constant_values=-1)
    oh, ow = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
    taps = [(xp[:, dy:dy + sh * (oh - 1) + 1:sh, dx:dx + sw * (ow - 1) + 1:sw],
             ip[:, dy:dy + sh * (oh - 1) + 1:sh, dx:dx + sw * (ow - 1) + 1:sw])
            for dy in range(kh) for dx in range(kw)]
    best = np.full((n, oh, ow, c), -np.inf, np.float32)
    idx = np.full((n, oh, ow, c), -1)
    for v, i in taps:
        idx, best = np.where(v > best, i, idx), np.maximum(best, v)
    return idx, sum((v == best).astype(int) for v, _ in taps)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,strides,padding", [
    ((2, 2), (2, 2), (0, 0)),
    ((3, 3), (2, 2), (1, 1)),
    ((3, 2), (1, 1), (1, 0)),
    ((3, 2), (1, 1), (0, 1)),
])
@pytest.mark.parametrize("ties", [False, True])
def test_pool2d_with_index(rng, dtype, window, strides, padding, ties):
    """Max and the flat index of the first maximum in row-major window
    order; with `ties`, whole windows of equal values and rounded ones.
    The port's indices are held to that order everywhere, and to the JAX
    op's wherever XLA's reduce_window takes the same tap: where a window
    holds its maximum more than once, XLA on the CPU visits the taps of a
    window 2 wide with a W padding of 1 column by column (measured: every
    tied window of such a pool), so there the JAX index is another of the
    tied taps; reduce_window's order is XLA's choice, not the op's."""
    x = _normal(rng, 2, 6, 7, 3)
    if ties:
        x = np.round(x)
        x[0] = 1.0
        x[1, :, :, 1] = 0.0
    attrs = dict(window=window, strides=strides, padding=padding)
    xr = torch.from_numpy(x).to(torch.bfloat16).float().numpy() \
        if dtype == "bf16" else x
    want_idx, n_max = _first_max_in_window_order(xr, **attrs)
    xla_order_parts = window[1] == 2 and padding[1] == 1
    for op in ("pool2d_with_index", "pooling_with_index"):
        vals, (idx, jax_idx) = run_both(op, [x], dtype, **attrs)
        _equal(vals)
        np.testing.assert_array_equal(idx, want_idx)
        if xla_order_parts:
            np.testing.assert_array_equal(idx[n_max == 1],
                                          jax_idx[n_max == 1])
        else:
            np.testing.assert_array_equal(idx, jax_idx)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,strides", [((2, 2), (2, 2)),
                                            ((3, 3), (1, 1))])
def test_unpool2d(rng, dtype, window, strides):
    """The indices of `pool2d_with_index`; windows that overlap (3 x 3 at
    stride 1) add several values into one cell."""
    x = _normal(rng, 2, 6, 6, 3)
    node = Node("p", "pool2d_with_index", ["x"], ["v", "i"],
                dict(window=window, strides=strides))
    y, idx = (t.numpy() for t in get_op("pool2d_with_index")(
        node, [torch.from_numpy(x)]))
    assert len(np.unique(idx)) < idx.size or strides == (2, 2)
    for op in ("unpool2d", "unpool"):
        assert_close(run_both(op, [y, idx], dtype, out_hw=(6, 6))[0], dtype)


def test_unpool2d_indices_out_of_range(rng):
    """A negative index counts from the end once, one still out of range
    is dropped, as `.at[].add` does."""
    y = _normal(rng, 1, 2, 2, 2)
    idx = np.array([[[[0, -1], [3, 4]], [[-5, 2], [1, 100]]]], np.int32)
    assert_close(run_both("unpool2d", [y, idx], out_hw=(2, 2))[0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["max", "avg"])
@pytest.mark.parametrize("hw,levels", [((8, 8), 3), ((7, 5), 3), ((5, 9), 2)])
def test_spp(rng, dtype, mode, hw, levels):
    """The average counts the bin's padding, as the reference does."""
    x = _normal(rng, 2, hw[0], hw[1], 3)
    pair = run_both("spp", [x], dtype, mode=mode, pyramid_height=levels)[0]
    if mode == "max":
        _equal(pair)
    else:
        assert_close(pair, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op,sa,sb,attrs", [
    ("matmul", (3, 4), (4, 5), {}),
    ("mat_mul", (2, 3, 4), (2, 5, 4), dict(transpose_b=True)),
    ("aligned_mat_mul", (2, 4, 3), (4, 5), dict(transpose_a=True,
                                                coeff=0.5)),
    ("batch_gemm", (2, 2, 3, 4), (2, 1, 4, 5), dict(activation="relu")),
    ("gemm", (3, 4), (5, 4), dict(transpose_b=True, coeff=2.0,
                                  activation="tanh")),
])
def test_matmul(rng, dtype, op, sa, sb, attrs):
    a, b = _normal(rng, *sa), _normal(rng, *sb)
    assert_close(run_both(op, [a, b], dtype, **attrs)[0], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("affine", [0, 1, 2])
def test_group_norm(rng, dtype, affine):
    x = _normal(rng, 2, 3, 4, 8)
    ins = [x, _normal(rng, 8), _normal(rng, 8)][:1 + affine]
    assert_close(run_both("group_norm", ins, dtype, groups=4)[0], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("across,variance", [(False, True), (True, True),
                                             (False, False)])
def test_mvn(rng, dtype, across, variance):
    x = _normal(rng, 2, 3, 4, 5) * 3 + 1
    assert_close(run_both("mvn", [x], dtype, across_channels=across,
                          normalize_variance=variance)[0], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shared", [False, True])
def test_prelu(rng, dtype, shared):
    x = _normal(rng, 2, 3, 4, 5)
    slope = _normal(rng, 1 if shared else 5)
    _equal(run_both("prelu", [x, slope], dtype, channel_shared=shared)[0])


@pytest.mark.parametrize("dtype", DTYPES)
def test_axpy_and_power(rng, dtype):
    a, x, b = _normal(rng, 2, 1, 1, 4), _normal(rng, 2, 3, 3, 4), \
        _normal(rng, 2, 3, 3, 4)
    assert_close(run_both("axpy", [a, x, b], dtype)[0], dtype)
    pos = np.abs(x) + 0.5
    for attrs in ({}, dict(power=2.0, scale=0.5, shift=0.25),
                  dict(power=0.5, scale=3.0), dict(power=-1.0, shift=1.0)):
        assert_close(run_both("power", [pos], dtype, **attrs)[0], dtype)


@pytest.mark.parametrize("op,dtype", [
    (op, dtype) for op in ("exp", "log", "erf") for dtype in DTYPES]
    + [("exp", "int32"), ("log", "int32")])   # jnp.erf takes floats only
def test_elementwise_math(rng, dtype, op):
    if dtype == "int32":
        x = rng.integers(1, 6, (3, 4)).astype(np.int32)
    else:
        x = _normal(rng, 3, 4) * 2
        if op == "log":
            x = np.abs(x) + 1e-3
    pair = run_both(op, [x], dtype)[0]
    assert_close(pair, "bf16" if dtype == "bf16" else "fp32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_cos_sim_and_dot(rng, dtype):
    a, b = _normal(rng, 2, 3, 6), _normal(rng, 2, 3, 6)
    b[0, 0] = 0.0
    assert_close(run_both("cos_sim", [a, b], dtype)[0], dtype)
    assert_close(run_both("dot", [a, b], dtype)[0], dtype)


@pytest.mark.parametrize("dtype", DTYPES + ["int8"])
@pytest.mark.parametrize("groups", [2, 3])
def test_maxout(rng, dtype, groups):
    if dtype == "int8":
        x = rng.integers(-127, 128, (2, 3, 4, 6)).astype(np.int8)
    else:
        x = _normal(rng, 2, 3, 4, 6)
    _equal(run_both("maxout", [x], dtype, groups=groups)[0])


# ------------------------------------------- every new entry: meta, capture


def new_entry_cases():
    """One (op, inputs, attrs) for each of 46 entries: the sequence ops and
    the tensor and nn entries this file tests."""
    rng = np.random.default_rng(5)
    n = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    B, T, D, H = 2, 5, 3, 4
    lens = np.array([5, 2], np.int32)
    lstm_w = [n(D, 4 * H), n(H, 4 * H), n(4 * H)]
    return [
        ("lstm", [n(B, T, D)] + lstm_w + [lens],
         dict(has_lengths=True, reverse=True)),
        ("lstmp", [n(B, T, D), n(D, 4 * H), n(2, 4 * H), n(H, 2), n(4 * H),
                   lens], dict(has_lengths=True)),
        ("gru", [n(B, T, D), n(D, 3 * H), n(H, 3 * H), n(3 * H), lens],
         dict(has_lengths=True)),
        ("sequence_concat", [n(B, T, D), n(B, T, H)], {}),
        ("seq_concat_seq_pool_soft_sign", [n(B, T, D), n(B, T, H), lens],
         dict(has_lengths=True)),
        ("sequence_expand", [n(B, D), n(B, T, H)], {}),
        ("sequence_conv", [n(B, T, D), n(3 * D, H), n(H)],
         dict(has_bias=True)),
        ("sequence_pool_concat", [n(B, T, D), n(B, T, H)], dict(mode="max")),
        ("reverse_sequence", [n(B, T, D), lens], {}),
        ("crf_decoding", [n(B, T, H), n(H + 2, H), lens], {}),
        ("attention_lstm", [n(B, T, D), n(D + H, 6), n(6, 1)] + lstm_w
         + [lens], dict(has_lengths=True)),
        ("attention_padding_mask", [n(B, T, T), lens], {}),
        ("permute", [n(2, 3, 4, 5)], dict(order=(0, 3, 1, 2))),
        ("transpose", [n(2, 3, 4)], {}),
        ("permute_power", [n(2, 3, 4)], dict(order=(1, 0, 2), power=2.0)),
        ("split", [n(2, 3)], dict(num=1)),
        ("slice_v2", [n(2, 5, 6)], dict(axes=(1, 2), starts=(-3, 1),
                                        ends=(4, -1))),
        ("pad", [n(1, 3, 4, 2)], dict(pad_h=(1, 2), pad_w=(2, 0),
                                      mode="reflect")),
        ("pixel_shuffle", [n(1, 2, 3, 8)], dict(upscale_factor=2)),
        ("expand", [n(2, 3)], dict(expand_times=(2, 3))),
        ("gather", [n(4, 3), np.array([3, -1, 7], np.int32)], dict(axis=0)),
        ("cast", [n(2, 3)], dict(dtype="int32")),
        ("one_hot", [np.array([[0, 5], [-1, 2]], np.int32)], dict(depth=4)),
        ("topk", [n(2, 3, 6)], dict(k=2)),
        ("reduce", [n(2, 3, 4)], dict(mode="sum", axes=(1,))),
        ("mean", [n(2, 3)], {}),
        ("cumsum", [n(2, 4)], dict(axis=1, exclusive=True)),
        ("arithmetic", [n(2, 3), n(2, 3)], dict(mode="sub")),
        ("reverse_input", [n(3, 2), n(2, 2)], {}),
        ("im2sequence", [n(1, 5, 5, 2)], dict(window=(2, 3), strides=(1, 2),
                                              padding=(1, 0))),
        ("coord2patch", [n(2, 4)], {}),
        ("pool2d_with_index", [n(1, 6, 6, 2)], dict(window=(3, 3),
                                                    strides=(2, 2),
                                                    padding=(1, 1))),
        ("unpool2d", [n(1, 3, 3, 2), np.arange(18, dtype=np.int32)
                      .reshape(1, 3, 3, 2) % 36], dict(out_hw=(6, 6))),
        ("spp", [n(1, 7, 5, 2)], dict(mode="avg")),
        ("matmul", [n(2, 3, 4), n(2, 4, 5)], dict(coeff=0.5)),
        ("group_norm", [n(1, 2, 2, 4), n(4), n(4)], dict(groups=2)),
        ("mvn", [n(1, 3, 3, 2)], {}),
        ("prelu", [n(1, 2, 2, 3), n(3)], {}),
        ("axpy", [n(1, 1, 1, 2), n(1, 2, 2, 2), n(1, 2, 2, 2)], {}),
        ("power", [np.abs(n(2, 3))], dict(power=0.5)),
        ("exp", [n(2, 3)], {}),
        ("log", [np.abs(n(2, 3))], {}),
        ("erf", [n(2, 3)], {}),
        ("cos_sim", [n(2, 4), n(2, 4)], {}),
        ("dot", [n(2, 4), n(2, 4)], {}),
        ("maxout", [n(1, 2, 2, 4)], dict(groups=2)),
    ]


def _node(cls, op, k, attrs, n_out=1):
    return cls("n", op, [f"i{j}" for j in range(k)],
               [f"o{j}" for j in range(n_out)], dict(attrs))


def test_new_entry_cases_cover_every_new_entry():
    """The cases name 46 registered entries, once each."""
    ops = [op for op, _, _ in new_entry_cases()]
    assert len(ops) == len(set(ops)) == 46
    assert all(op in OPS for op in ops)


@pytest.mark.parametrize("case", new_entry_cases(), ids=lambda c: c[0])
def test_new_entry_on_meta_matches_jax_shapes(case):
    """The op on `meta` tensors (shape inference, and the converters'
    shapes) gives the shapes and dtypes `jax.eval_shape` gives the JAX
    op, without data."""
    op, ins, attrs = case
    n_out = 2 if op in ("topk", "pool2d_with_index", "reverse_input") else 1
    want = jax.eval_shape(
        lambda *a: jax_get_op(op)(_node(JaxNode, op, len(ins), attrs, n_out),
                                  list(a)),
        *[jax.ShapeDtypeStruct(a.shape, a.dtype) for a in ins])
    metas = [torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                         device="meta") for a in ins]
    got = get_op(op)(_node(Node, op, len(ins), attrs, n_out), metas)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape), op
        assert str(g.dtype).endswith(jnp.dtype(w.dtype).name), (op, g.dtype)


def test_new_entries_are_capture_safe(monkeypatch):
    """No new op reads a tensor value on the host, indexes by a tensor or
    makes a tensor from host data (a CUDA capture fails on each), and each
    gives what it gives outside the check."""

    def host_data(*a, **kw):
        raise AssertionError("a tensor made from host data")

    for op, ins, attrs in new_entry_cases():
        n_out = 2 if op in ("topk", "pool2d_with_index") else 1
        node = _node(Node, op, len(ins), attrs, n_out)
        xs = [torch.from_numpy(np.array(a)) for a in ins]
        first = get_op(op)(node, xs)
        with monkeypatch.context() as m, _NoHostSync():
            for name in ("tensor", "as_tensor", "from_numpy"):
                m.setattr(torch, name, host_data)
            again = get_op(op)(node, xs)
        for a, b in zip(first, again):
            assert torch.equal(a, b) or (a.is_floating_point() and torch.equal(
                torch.nan_to_num(a), torch.nan_to_num(b))), op
