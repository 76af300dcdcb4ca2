"""The port's LLM serving slice against the JAX package on the CPU: the
transformer builders and `weight_only_quantize`, the plain versions of the
two kernels (`flash_attention`, `matmul_w4`) against the Pallas kernels in
interpret mode, the attention and weight-only ops, bf16 nets node by node,
and `GenerationSession` end to end.  A small model: vocab 512, E 256,
2 layers, 8 heads over 4 kv heads (D 32), max_seq 256.

Tolerances, and why:
  * graphs and weights: equal (names, ops, attrs, bytes);
  * float32 results: rtol 1e-5 with an atol of 1e-5 of the largest value
    (float32 sums in another order; XLA contracts multiply-adds the port
    rounds separately), 1e-4 where a softmax and two layers lie between;
  * bf16 results: one bf16 ulp (rtol 2**-7) where the float32 value under
    the rounding differs only by summation order; node by node in a bf16
    net also an atol of 1e-3 of the largest value, since an input one ulp
    apart moves a layer_norm's mean (measured worst: 2e-4);
  * int8 caches: within 1 LSB (a k / scale on a .5 boundary may round
    either way after a product in another order);
  * flash rows at or past a length: not compared (they differ from the
    dense path's by design; only rows below the length are read).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import anakin_tpu as ak
from anakin_tpu.kernels.flash_attention import flash_attention as jax_flash
from anakin_tpu.kernels.matmul_w4 import matmul_w4 as jax_matmul_w4
from anakin_tpu.models import transformer as jax_tf
from anakin_tpu.ops import attention as jax_attention
from anakin_tpu.ops import get_op as jax_get_op
from anakin_tpu.quant import weight_only_quantize as jax_weight_only_quantize
from anakin_tpu.runtime.generate import GenerationSession as JaxSession
import anakin_tpu_torch as pt
from anakin_tpu_torch.convert import graph_from_jax, params_from_numpy
from anakin_tpu_torch.graph.ir import Node, topological_order
from anakin_tpu_torch.kernels.flash_attention import flash_attention
from anakin_tpu_torch.kernels.matmul_w4 import (matmul_w4, unpack_w4,
                                                unpack_w4_v2)
from anakin_tpu_torch.models import transformer as pt_tf
from anakin_tpu_torch.ops import get_op
from anakin_tpu_torch.quant import weight_only_quantize
from anakin_tpu_torch.runtime.generate import GenerationSession
from anakin_tpu_torch.runtime.net import build_forward

from test_torch_kernels import _Elsewhere

CFG = dict(vocab=512, embed=256, heads=8, kv_heads=4, layers=2, max_seq=256)
BF16_ULP = 2.0 ** -7


@pytest.fixture(scope="module")
def params():
    return pt_tf.make_transformer_params(pt_tf.TransformerConfig(**CFG), 0)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("ANAKIN_PALLAS_INTERPRET", "1")


def _cfgs():
    return jax_tf.TransformerConfig(**CFG), pt_tf.TransformerConfig(**CFG)


def _t(a, dtype=None):
    """numpy -> torch on the CPU, optionally rounded to `dtype`."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _j(a, dtype=None):
    j = jnp.asarray(a)
    return j if dtype is None else j.astype(dtype)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _close_f32(got, want, rtol=1e-5, what=""):
    g, w = _f32(got), _f32(want)
    np.testing.assert_allclose(g, w, rtol=rtol,
                               atol=rtol * float(np.abs(w).max()), err_msg=what)


def _close_bf16(got, want, what=""):
    g, w = _f32(got), _f32(want)
    np.testing.assert_allclose(g, w, rtol=BF16_ULP,
                               atol=1e-5 * float(np.abs(w).max()), err_msg=what)


def _same_graph(got, want):
    assert list(got.nodes) == list(want.nodes)
    for name, n in got.nodes.items():
        w = want.nodes[name]
        assert (n.op, n.inputs, n.outputs, n.attrs) == (
            w.op, w.inputs, w.outputs, w.attrs), name
    assert (got.inputs, got.outputs, got.input_specs, got.precisions) == (
        want.inputs, want.outputs, want.input_specs, want.precisions)
    assert sorted(got.params) == sorted(want.params)
    for k, v in got.params.items():
        assert v.dtype == want.params[k].dtype and v.shape == want.params[k].shape
        assert v.tobytes() == want.params[k].tobytes(), k


# ------------------------------------------------------------- graphs

_BUILDERS = {
    "lm": lambda m, c, p: m.build_transformer_lm(c, 2, 16, p),
    "prefill": lambda m, c, p: m.build_transformer_prefill(c, 2, 32, p),
    "prefill_flash_kv8_last": lambda m, c, p: m.build_transformer_prefill(
        c, 2, 64, p, kv_cache_dtype="int8", kv_scale=[0.03, (0.02, 0.04)],
        attention_impl="flash", last_token_only=True),
    "decode": lambda m, c, p: m.build_transformer_decode_step(c, 2, p),
    "decode_kv8_aligned": lambda m, c, p: m.build_transformer_decode_step(
        c, 2, p, kv_cache_dtype="int8", aligned_pos=True),
    "decode_rows_view": lambda m, c, p: m.build_transformer_decode_step(
        c, 2, p, cache_update="rows", cache_view=64),
    "verify": lambda m, c, p: m.build_transformer_verify_step(c, 2, 4, p),
}


@pytest.mark.parametrize("which", sorted(_BUILDERS))
def test_builders_match_jax_package(params, which):
    jc, pc = _cfgs()
    _same_graph(_BUILDERS[which](pt_tf, pc, params),
                _BUILDERS[which](jax_tf, jc, params))


@pytest.mark.parametrize("recipe", [dict(), dict(norm="rms", mlp="swiglu")])
def test_make_transformer_params_matches_jax_package(recipe):
    kw = dict(CFG, layers=1, **recipe)
    got = pt_tf.make_transformer_params(pt_tf.TransformerConfig(**kw), 3)
    want = jax_tf.make_transformer_params(jax_tf.TransformerConfig(**kw), 3)
    assert list(got) == list(want)
    assert all(got[k].tobytes() == want[k].tobytes() for k in got)


@pytest.mark.parametrize("bits,group", [(4, 128), (8, 128), (4, 96)])
def test_weight_only_quantize_matches_jax_package(params, bits, group):
    """bits 4 and 8 give the JAX package's graph and byte-equal params;
    group 96 divides neither reduction dim (256, 1024), so at bits 4 every
    layer falls back to w8."""
    jc, pc = _cfgs()
    got = weight_only_quantize(pt_tf.build_transformer_decode_step(
        pc, 2, params, kv_cache_dtype="int8", aligned_pos=True), bits=bits,
        group=group)
    want = jax_weight_only_quantize(jax_tf.build_transformer_decode_step(
        jc, 2, params, kv_cache_dtype="int8", aligned_pos=True), bits=bits,
        group=group)
    _same_graph(got, want)
    n_w4 = sum(n.op == "dense_w4" for n in got.nodes.values())
    assert n_w4 == (2 * CFG["layers"] + 1 if (bits, group) == (4, 128) else 0)


# ------------------------------------------------------------- kernels

def _qkv(rng, B, H, Hkv, Sq, Sk, D):
    return (rng.normal(size=(B, H, Sq, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["causal", "full", "segments", "gqa_causal",
                                  "cross"])
def test_flash_attention_plain_matches_pallas(rng, dtype, case):
    """The port's flash_attention on CPU tensors (its plain version)
    against the Pallas kernel in interpret mode; grouped kv heads are
    repeated for the JAX kernel, which takes H heads only."""
    B, H, Hkv, S, D = 2, 4, (2 if case.startswith("gqa") else 4), 128, 32
    Sk = 256 if case == "cross" else S
    q, k, v = _qkv(rng, B, H, Hkv, S, Sk, D)
    causal = case in ("causal", "gqa_causal")
    segs = None
    if case == "segments":
        segs = np.sort(rng.integers(0, 3, (B, S)), axis=1).astype(np.int32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    rep = H // Hkv
    want = jax_flash(_j(q, jd), _j(np.repeat(k, rep, 1), jd),
                     _j(np.repeat(v, rep, 1), jd),
                     None if segs is None else _j(segs),
                     None if segs is None else _j(segs),
                     causal=causal, block_q=64, block_k=64, interpret=True)
    got = flash_attention(_t(q, td), _t(k, td), _t(v, td),
                          None if segs is None else _t(segs),
                          None if segs is None else _t(segs), causal=causal)
    assert got.dtype == td and got.shape == (B, H, S, D)
    (_close_f32 if dtype == "float32" else _close_bf16)(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ragged_valid_rows(rng, interpret, dtype):
    """S = 300 with per-row lengths: the port's kernel takes the ragged S
    unpadded with segment ids; the JAX path pads it to 384 for its TPU
    kernel.  Rows below each length agree."""
    B, H, S, D = 2, 4, 300, 32
    q, k, v = _qkv(rng, B, H, H, S, S, D)
    lengths = np.array([300, 211])
    seg = (np.arange(S)[None] >= lengths[:, None]).astype(np.int32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(jax_attention._flash_attn_padded(
        _j(q, jd), _j(k, jd), _j(v, jd), _j(seg), _j(seg), causal=True)
        .astype(jnp.float32))
    got = flash_attention(_t(q, td), _t(k, td), _t(v, td), _t(seg), _t(seg),
                          causal=True)
    for b, n in enumerate(lengths):
        (_close_f32 if dtype == "float32" else _close_bf16)(
            got[b, :, :n], want[b, :, :n], what=f"row {b}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,G", [(8, 256, 1024, 128), (5, 1024, 256, 128),
                                     (33, 256, 520, 64), (1, 512, 512, 512)])
def test_matmul_w4_plain_matches_pallas(rng, dtype, M, K, N, G):
    from anakin_tpu.quant.quantize import _w4_group_quantize

    packed, scale, g = _w4_group_quantize(
        rng.normal(size=(K, N)).astype(np.float32), G)
    x = rng.normal(size=(M, K)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax_matmul_w4(_j(x, jd), _j(packed), _j(scale), group=g,
                         block_n=256, block_k=256, interpret=True)
    got = matmul_w4(_t(x, td), _t(packed), _t(scale), group=g)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    _close_f32(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,G", [(8, 256, 1024, 128), (5, 1024, 256, 128),
                                     (33, 256, 520, 64), (1, 512, 512, 512)])
def test_matmul_w4_v2_plain_matches_pallas(rng, dtype, M, K, N, G):
    """v2's plain version against the Pallas v2 kernel, float32 scales on
    both sides (so in bf16 both round the scale to bf16 first)."""
    from anakin_tpu.quant.quantize import _w4_group_quantize

    packed, scale, g = _w4_group_quantize(
        rng.normal(size=(K, N)).astype(np.float32), G)
    x = rng.normal(size=(M, K)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax_matmul_w4(_j(x, jd), _j(packed), _j(scale), group=g,
                         block_n=256, block_k=256, variant="v2",
                         interpret=True)
    got = matmul_w4(_t(x, td), _t(packed), _t(scale), group=g, variant="v2")
    assert got.dtype == torch.float32 and got.shape == (M, N)
    _close_f32(got, want)


@pytest.mark.parametrize("case", ["float32", "bf16_scales",
                                  "float32_scales_bf16_x"])
def test_matmul_w4_v2_dequant_against_v1(rng, case):
    """The dequantized weights of the two variants, read exactly through
    the Pallas kernels on an identity x: equal in float32 and where the
    scales are already bf16 (a bf16 net casts them so); with float32
    scales and bf16 x, v2 rounds the scale to bf16 before the product (a
    double rounding), so some weights differ, each by at most one bf16
    ulp."""
    from anakin_tpu.quant.quantize import _w4_group_quantize

    K, N = 256, 384
    packed, scale, g = _w4_group_quantize(
        rng.normal(size=(K, N)).astype(np.float32), 128)
    if case == "bf16_scales":
        scale = np.array(jnp.asarray(scale).astype(jnp.bfloat16)
                         .astype(jnp.float32))
    dtype = "float32" if case == "float32" else "bfloat16"
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    eye = np.eye(K, dtype=np.float32)
    jax_w = {v: np.asarray(jax_matmul_w4(
        _j(eye, jd), _j(packed), _j(scale), group=g, block_n=128,
        block_k=128, variant=v, interpret=True)) for v in ("v1", "v2")}
    w1 = unpack_w4(_t(packed), _t(scale), g, td).float()
    w2 = unpack_w4_v2(_t(packed), _t(scale), g, td).float()
    np.testing.assert_array_equal(w1.numpy(), jax_w["v1"])
    np.testing.assert_array_equal(w2.numpy(), jax_w["v2"])
    if case != "float32_scales_bf16_x":
        assert torch.equal(w1, w2)
        return
    differ = w1 != w2
    assert 0 < int(differ.sum()) < differ.numel() // 2
    assert bool(((w1 - w2).abs() <= BF16_ULP * w1.abs()).all())
    rounded_first = unpack_w4(_t(packed), _t(scale).to(td).float(), g, td)
    assert torch.equal(w2, rounded_first.float())


@pytest.mark.parametrize("variant", ["v1", "v2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_w4_takes_bf16_scales(rng, variant, dtype):
    """bf16 scales, as a bf16 net hands them over, give exactly what their
    float32 widening gives: the wrapper and the kernel read either dtype and
    widen in registers, so `dense_w4` needs no cast."""
    from anakin_tpu.quant.quantize import _w4_group_quantize

    packed, scale, g = _w4_group_quantize(
        rng.normal(size=(256, 384)).astype(np.float32), 128)
    x = _t(rng.normal(size=(8, 256)).astype(np.float32), getattr(torch, dtype))
    s16 = _t(scale).to(torch.bfloat16)
    got = matmul_w4(x, _t(packed), s16, group=g, variant=variant)
    want = matmul_w4(x, _t(packed), s16.float(), group=g, variant=variant)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    with pytest.raises(TypeError, match="scales"):
        matmul_w4(x, _t(packed), s16.half(), group=g, variant=variant)


def test_matmul_w4_refuses_v2_and_other_devices():
    """An unknown variant raises (the JAX package would quietly run v1 for
    it); a device that is neither CPU nor CUDA raises in both LLM wrappers,
    for v1 and v2 alike; a meta tensor (shape inference) gets a meta result
    in both variants."""
    x = torch.zeros((2, 128))
    packed = torch.zeros((64, 8), dtype=torch.int8)
    scales = torch.ones((1, 8))
    with pytest.raises(ValueError, match="variant"):
        matmul_w4(x, packed, scales, group=128, variant="v3")
    for variant in ("v1", "v2"):
        with pytest.raises(ValueError, match="runs on cuda or cpu"):
            matmul_w4(_Elsewhere((2, 128), torch.float32),
                      _Elsewhere((64, 8), torch.int8),
                      _Elsewhere((1, 8), torch.float32), group=128,
                      variant=variant)
        y = matmul_w4(x.to("meta"), packed.to("meta"), scales.to("meta"),
                      group=128, variant=variant)
        assert y.device.type == "meta" and tuple(y.shape) == (2, 8)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        flash_attention(*(_Elsewhere((1, 2, 4, 32), torch.float32),) * 3)
    q = torch.zeros((1, 2, 4, 32), device="meta")
    y = flash_attention(q, q, q, causal=True)
    assert y.device.type == "meta" and tuple(y.shape) == (1, 2, 4, 32)


# ------------------------------------------------------------- ops

def _run_both(op, arrays, jdtypes, tdtypes, **attrs):
    """One op on both sides, on the same seeded arrays (each cast as
    given, None keeping it)."""
    node = Node("n", op, [f"i{i}" for i in range(len(arrays))], ["o"], attrs)
    want = jax_get_op(op)(node, [_j(a, d) for a, d in zip(arrays, jdtypes)])
    got = get_op(op)(node, [_t(a, d) for a, d in zip(arrays, tdtypes)])
    return got, want


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("epilogue", [dict(), dict(has_bias=True, activation="gelu")])
def test_dense_w4_matches_jax(rng, interpret, precision, impl, epilogue):
    """dense_w4 on the port (matmul_w4's plain version) against both JAX
    routes; in a bf16 net the activations and the float32 group scales are
    bf16 on both sides, as each `Net` casts float params."""
    from anakin_tpu.quant.quantize import _w4_group_quantize

    K, N = 512, 384
    packed, scale, G = _w4_group_quantize(
        rng.normal(size=(K, N)).astype(np.float32) * 0.05, 128)
    arrays = [rng.normal(size=(2, 3, K)).astype(np.float32), packed, scale]
    if epilogue:
        arrays.append(rng.normal(size=(N,)).astype(np.float32))
    jd = jnp.float32 if precision == "fp32" else jnp.bfloat16
    td = torch.float32 if precision == "fp32" else torch.bfloat16
    fl = [True, False, True, True]
    got, want = _run_both("dense_w4", arrays, [jd if f else None for f in fl],
                          [td if f else None for f in fl], axis=2,
                          w4_group=G, impl=impl, **epilogue)
    assert got[0].dtype == td and tuple(got[0].shape) == (2, 3, N)
    (_close_f32 if precision == "fp32" else _close_bf16)(got[0], want[0])


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("K,group", [(256, 32), (96, 128), (192, 6)])
def test_dense_w4_takes_every_quantizer_group(rng, precision, K, group):
    """Every group the quantizer writes (any even G that divides K: 32, K
    itself when the asked-for group is larger, 6) through the port's
    dense_w4 against the JAX op's default route."""
    from anakin_tpu.quant.quantize import _w4_group_quantize

    N = 136
    packed, scale, G = _w4_group_quantize(
        rng.normal(size=(K, N)).astype(np.float32) * 0.05, group)
    assert G == min(group, K)
    arrays = [rng.normal(size=(3, K)).astype(np.float32), packed, scale]
    jd = jnp.float32 if precision == "fp32" else jnp.bfloat16
    td = torch.float32 if precision == "fp32" else torch.bfloat16
    got, want = _run_both("dense_w4", arrays, [jd, None, jd], [td, None, td],
                          w4_group=G)
    assert got[0].dtype == td and tuple(got[0].shape) == (3, N)
    (_close_f32 if precision == "fp32" else _close_bf16)(got[0], want[0])


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_dense_w4_routes_like_jax(rng, interpret, monkeypatch, precision,
                                  impl, variant):
    """dense_w4 takes matmul_w4 v2 exactly when the node says impl="pallas"
    and variant="v2", as the JAX op does (it reads `variant` on its Pallas
    route only), and matches the JAX op in each of the four combinations;
    the scales are in the activation dtype, as a `Net` casts them, and
    reach matmul_w4 in that dtype (no cast launch a call)."""
    from anakin_tpu.quant.quantize import _w4_group_quantize
    from anakin_tpu_torch.ops import quantized

    variants, scale_dtypes = [], []

    def spy(*args, variant, **kw):
        variants.append(variant)
        scale_dtypes.append(args[2].dtype)
        return matmul_w4(*args, variant=variant, **kw)

    monkeypatch.setattr(quantized, "matmul_w4", spy)
    K, N = 256, 384
    packed, scale, G = _w4_group_quantize(
        rng.normal(size=(K, N)).astype(np.float32) * 0.05, 128)
    arrays = [rng.normal(size=(4, K)).astype(np.float32), packed, scale]
    jd = jnp.float32 if precision == "fp32" else jnp.bfloat16
    td = torch.float32 if precision == "fp32" else torch.bfloat16
    got, want = _run_both("dense_w4", arrays, [jd, None, jd], [td, None, td],
                          w4_group=G, impl=impl, variant=variant)
    assert variants == ["v2" if (impl, variant) == ("pallas", "v2") else "v1"]
    assert scale_dtypes == [td]
    assert got[0].dtype == td and tuple(got[0].shape) == (4, N)
    (_close_f32 if precision == "fp32" else _close_bf16)(got[0], want[0])


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_dense_w8_matches_jax(rng, precision):
    from anakin_tpu.quant.quantize import (_quantize_weight,
                                           per_channel_weight_scale)

    w = rng.normal(size=(256, 192)).astype(np.float32)
    ws = per_channel_weight_scale(w, 1)
    arrays = [rng.normal(size=(4, 256)).astype(np.float32),
              _quantize_weight(w, ws, 1), ws]
    jd = jnp.float32 if precision == "fp32" else jnp.bfloat16
    td = torch.float32 if precision == "fp32" else torch.bfloat16
    got, want = _run_both("dense_w8", arrays, [jd, None, jd], [td, None, td])
    (_close_f32 if precision == "fp32" else _close_bf16)(got[0], want[0])


@pytest.mark.parametrize("mode", ["average", "sum", "sqrt", "max", "last",
                                  "first"])
def test_sequence_pool_matches_jax(rng, mode):
    x = rng.normal(size=(3, 7, 5)).astype(np.float32)
    lengths = np.array([7, 2, 0], np.int32)
    got, want = _run_both("sequence_pool", [x, lengths], [None] * 2, [None] * 2,
                          mode=mode)
    _close_f32(got[0], want[0])


@pytest.mark.parametrize("op,attrs,n_in", [
    ("layer_norm", dict(begin_norm_axis=2), 3),
    ("rms_norm", dict(), 2),
])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_norms_match_jax(rng, op, attrs, n_in, precision):
    arrays = [rng.normal(size=(2, 5, 64)).astype(np.float32) * 3 + 1] + [
        rng.normal(size=(64,)).astype(np.float32) for _ in range(n_in - 1)]
    d = (jnp.float32, torch.float32) if precision == "fp32" else (
        jnp.bfloat16, torch.bfloat16)
    got, want = _run_both(op, arrays, [d[0]] * n_in, [d[1]] * n_in, **attrs)
    (_close_f32 if precision == "fp32" else _close_bf16)(got[0], want[0])


def test_embedding_and_reshape_match_jax(rng):
    ids = np.array([[0, 3, 7], [7, 7, 1]], np.int32)
    table = rng.normal(size=(8, 6)).astype(np.float32)
    got, want = _run_both("embedding", [ids, table], [None] * 2, [None] * 2,
                          padding_idx=7)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    got, want = _run_both("reshape", [table], [None], [None], shape=[0, 2, 3])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def _attn_weights(rng, E, H, Hkv, D):
    return [rng.normal(size=s).astype(np.float32) * E ** -0.5
            for s in ((E, H * D), (E, Hkv * D), (E, Hkv * D), (H * D, E))]


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("lengths", [False, True])
def test_mha_prefill_matches_jax(rng, interpret, impl, kv, lengths):
    """mha_prefill: output rows below each length and the emitted caches;
    at S = 100 the JAX flash path pads to 128 and the port's flash path
    takes the ragged S as it is."""
    B, S, E, H, Hkv = 2, 100, 128, 4, 2
    D = E // H
    arrays = [rng.normal(size=(B, S, E)).astype(np.float32)] + _attn_weights(
        rng, E, H, Hkv, D)
    lens = np.array([100, 61], np.int32)
    attrs = dict(num_heads=H, num_kv_heads=Hkv, causal=True, rope=True,
                 max_seq=128, impl=impl)
    if lengths:
        arrays.append(lens)
        attrs["has_lengths"] = True
    if kv == "int8":
        attrs.update(kv_cache_dtype="int8", k_scale=0.05, v_scale=0.04)
    n = len(arrays)
    got, want = _run_both("mha_prefill", arrays, [None] * n, [None] * n, **attrs)
    for b in range(B):
        n_valid = lens[b] if lengths else S
        _close_f32(got[0][b, :n_valid], np.asarray(want[0])[b, :n_valid],
                   rtol=1e-4)
    for g_c, w_c in zip(got[1:], want[1:]):
        if kv == "int8":
            assert g_c.dtype == torch.int8
            d = np.abs(g_c.numpy().astype(int) - np.asarray(w_c).astype(int))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3
        else:
            _close_f32(g_c, w_c)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_multi_head_attention_matches_jax(rng, interpret, impl):
    B, S, E, H, Hkv = 2, 64, 128, 4, 2
    arrays = ([rng.normal(size=(B, S, E)).astype(np.float32)]
              + _attn_weights(rng, E, H, Hkv, E // H) + [np.array([64, 40], np.int32)])
    got, want = _run_both("multi_head_attention", arrays, [None] * 6, [None] * 6,
                          num_heads=H, num_kv_heads=Hkv, has_lengths=True,
                          impl=impl)
    for b, n in enumerate((64, 40)):
        _close_f32(got[0][b, :n], np.asarray(want[0])[b, :n], rtol=1e-4)


_DECODE_MODES = {
    "aligned": dict(aligned_pos=True),
    "blend": dict(),
    "rows": dict(cache_update="rows"),
    "scatter": dict(cache_update="scatter"),
}


@pytest.mark.parametrize("mode", sorted(_DECODE_MODES))
@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("view", [0, 32])
def test_mha_decode_matches_jax(rng, mode, kv, view):
    """Every cache-write mode, float32 and int8 caches, with and without a
    cache view.  The port writes into the caches it is given, so it gets
    copies; the JAX op returns new arrays."""
    B, E, H, Hkv, Smax = 3, 128, 4, 2, 48
    D = E // H
    shape = (B, Hkv, Smax, D)
    if kv == "int8":
        caches = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
    else:
        caches = [rng.normal(size=shape).astype(np.float32) for _ in range(2)]
    pos = (np.full(B, 17) if mode == "aligned" else np.array([3, 30, 17])
           ).astype(np.int32)
    arrays = ([rng.normal(size=(B, 1, E)).astype(np.float32)]
              + _attn_weights(rng, E, H, Hkv, D) + caches + [pos])
    attrs = dict(num_heads=H, num_kv_heads=Hkv, rope=True, cache_view=view,
                 **_DECODE_MODES[mode])
    if kv == "int8":
        attrs.update(kv_cache_dtype="int8", k_scale=0.05, v_scale=0.04)
    got, want = _run_both("mha_decode", arrays, [None] * 8, [None] * 8, **attrs)
    _close_f32(got[0], want[0], rtol=1e-4)
    for g_c, w_c in zip(got[1:], want[1:]):
        if kv == "int8":
            d = np.abs(g_c.numpy().astype(int) - np.asarray(w_c).astype(int))
            assert d.max() <= 1 and (d > 0).sum() <= 2
        else:
            _close_f32(g_c, w_c)


@pytest.mark.parametrize("mode", ["aligned", "rows", "blend", "scatter"])
def test_mha_decode_out_of_range_position(rng, mode):
    """A position past the cache: the aligned and per-row writes clamp onto
    the last row (`dynamic_update_slice`), the blend and the scatter write
    nothing."""
    B, E, H, Smax = 2, 64, 2, 8
    D = E // H
    caches = [rng.normal(size=(B, H, Smax, D)).astype(np.float32) for _ in range(2)]
    pos = np.array([Smax + 3, Smax + 3] if mode == "aligned" else [2, Smax + 3],
                   np.int32)
    arrays = ([rng.normal(size=(B, 1, E)).astype(np.float32)]
              + _attn_weights(rng, E, H, H, D) + caches + [pos])
    got, want = _run_both("mha_decode", arrays, [None] * 8, [None] * 8,
                          num_heads=H, **_DECODE_MODES[mode])
    for g_c, w_c in zip(got, want):
        _close_f32(g_c, w_c, rtol=1e-4)


# ------------------------------------------------------------- nets

def _graphs(params, which):
    jc, _ = _cfgs()
    if which == "prefill_flash_kv8":
        return jax_tf.build_transformer_prefill(
            jc, 2, 128, params, kv_cache_dtype="int8", attention_impl="flash",
            last_token_only=True)
    g = jax_tf.build_transformer_decode_step(
        jc, 2, params, kv_cache_dtype="int8", aligned_pos=True)
    return jax_weight_only_quantize(g, bits=4) if which == "decode_w4" else g


def _feed(rng, g):
    feed = {}
    for e, (shape, dt) in g.input_specs.items():
        if e == "input":
            feed[e] = rng.integers(0, CFG["vocab"], shape).astype(np.int32)
        elif e == "nreal":
            feed[e] = np.array([128, 77], np.int32)
        elif e == "pos":
            feed[e] = np.full(shape, 40, np.int32)
        else:
            feed[e] = rng.integers(-127, 128, shape).astype(np.int8)
    return feed


@pytest.mark.parametrize("which", ["prefill_flash_kv8", "decode_kv8", "decode_w4"])
def test_bf16_net_each_node_matches_jax_node(rng, params, interpret, which):
    """In a bf16 net every node of the port, on the JAX net's values of its
    inputs, against the JAX net's value of its output; the logits are also
    held end to end, within 2% of the largest (one-ulp differences
    propagate through the layers: 0.6-0.9% measured on these graphs)."""
    g = _graphs(params, which)
    feed = _feed(rng, g)
    edges = [e for n in ak.topological_order(g) for e in n.outputs]
    taps = {k: np.asarray(v) for k, v in ak.Net(g, precision="bf16",
                                                tap_edges=edges)
            .prediction({k: v.copy() for k, v in feed.items()}).items()}
    taps.update(feed)
    pg = graph_from_jax(g)
    net = pt.Net(pg, precision="bf16", device="cpu")
    for node in topological_order(pg):
        fwd, _ = build_forward(pg, "bf16", start_from=node.name, stop_at=node.name)
        inputs = params_from_numpy(
            {e: np.array(taps[e]) for e in node.inputs if e not in pg.params}, "cpu")
        with torch.inference_mode():
            out = fwd(net.params, inputs)
        for e in node.outputs:
            want = taps[e]
            if want.dtype == np.int8:
                d = np.abs(out[e].numpy().astype(int) - want.astype(int))
                assert d.max() <= 1, (node.name, e)
            elif want.dtype == np.int32:
                np.testing.assert_array_equal(out[e].numpy(), want)
            else:
                w = want.astype(np.float32)
                np.testing.assert_allclose(
                    _f32(out[e]), w, rtol=BF16_ULP,
                    atol=1e-3 * float(np.abs(w).max()), err_msg=f"{node.name}:{e}")
    got = pt.Net(pg, precision="bf16", device="cpu").prediction(feed)
    logits = g.outputs[0]
    lg, lw = _f32(got[logits]), taps[logits].astype(np.float32)
    assert np.abs(lg - lw).max() <= 0.02 * np.abs(lw).max()


@pytest.mark.parametrize("kv,attention,prompt_len", [
    ("float32", "dense", 20), ("int8", "dense", 200),
    ("float32", "flash", 200), ("int8", "flash", 30)])
def test_generation_session_matches_jax(rng, params, interpret, kv, attention,
                                        prompt_len):
    """fp32 sessions: the same greedy tokens and prefill logits within
    rtol 1e-4 of the largest; prompts of 20 and 30 tokens take bucket 32,
    200 takes bucket 256 (= max_seq)."""
    jc, pc = _cfgs()
    prompt = rng.integers(0, CFG["vocab"], (2, prompt_len)).astype(np.int32)
    n_new = 6
    js = JaxSession(jc, batch=2, params=params, kv_cache_dtype=kv,
                    kv_scale=0.05, prefill_attention=attention)
    ps = GenerationSession(pc, batch=2, params=params, kv_cache_dtype=kv,
                           kv_scale=0.05, prefill_attention=attention,
                           device="cpu")
    assert ps._bucket(prompt_len) == js._bucket(prompt_len) in (32, 256)
    want_logits, _ = js._prefill(prompt)
    got_logits, _ = ps._prefill(torch.from_numpy(prompt))
    _close_f32(got_logits, want_logits, rtol=1e-4)
    np.testing.assert_array_equal(ps.generate(prompt, n_new),
                                  js.generate(prompt, n_new))


def test_session_flash_gate_and_device():
    """"auto" takes flash only on CUDA and from bucket 512; with no device
    the session is CUDA and raises without one."""
    _, pc = _cfgs()
    s = GenerationSession(pt_tf.TransformerConfig(**dict(CFG, layers=1)),
                          device="cpu", params=None)
    assert s._attention_impl(512) is None
    s.device = torch.device("cuda")
    assert s._attention_impl(512) == "flash" and s._attention_impl(384) is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            GenerationSession(pc)


@pytest.mark.parametrize("embed,heads,precision,want", [
    (160, 2, "bf16", "flash"),   # head dim 80
    (192, 2, "fp32", "flash"),   # 96
    (512, 2, "bf16", "flash"),   # 256
    (512, 2, "fp32", None),      # 256: the float32 kernel stops at 128
    (96, 2, "bf16", None),       # 48: no kernel instance
])
def test_session_auto_takes_flash_only_for_its_head_dims(embed, heads,
                                                         precision, want):
    """"auto" on a CUDA session takes flash from bucket 512 only where the
    kernel takes the head dim for the session's dtype; else the dense
    path."""
    cfg = pt_tf.TransformerConfig(**dict(CFG, embed=embed, heads=heads,
                                         kv_heads=1, layers=1))
    s = GenerationSession(cfg, device="cpu", precision=precision)
    s.device = torch.device("cuda")
    assert s._attention_impl(512) == want and s._attention_impl(384) is None


def test_flash_head_dims():
    from anakin_tpu_torch.kernels.flash_attention import (head_dims,
                                                          takes_head_dim)

    assert head_dims(torch.bfloat16) == (32, 64, 80, 96, 128, 256)
    assert head_dims(torch.float32) == (32, 64, 80, 96, 128)
    assert takes_head_dim(80, torch.float32)
    assert not takes_head_dim(256, torch.float32)
    assert not takes_head_dim(48, torch.bfloat16)


def test_kernel_sources_and_launch_counters():
    """Both new kernels build from csrc/ with the others, and their
    wrappers carry a launch count that the plain version leaves alone."""
    from anakin_tpu_torch.kernels import _build

    assert {"flash_attention", "matmul_w4"} <= set(_build.SOURCES)
    def counts():
        return (flash_attention.launches, matmul_w4.launches,
                matmul_w4.launches_v2)

    before = counts()
    flash_attention(*(torch.zeros((1, 2, 4, 32)),) * 3)
    for variant in ("v1", "v2"):
        matmul_w4(torch.zeros((2, 128)), torch.zeros((64, 8), dtype=torch.int8),
                  torch.ones((1, 8)), group=128, variant=variant)
    assert counts() == before


# ------------------------------------------------------ mha_verify

@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("mode", ["rows", "blend"])
@pytest.mark.parametrize("at_end", [False, True])
def test_mha_verify_matches_jax(rng, kv, mode, at_end):
    """A chunk of T = 5 tokens per row against the cache: float32 and int8
    caches, "rows" and "blend" writes; `at_end` puts one chunk on the
    cache's last rows and one past it ("rows" moves it back to end on the
    last row, "blend" drops the rows past it).  Outputs within rtol 1e-4
    of the largest (float32 sums in another order, then a softmax); float
    caches within 1e-5; int8 caches equal (the same divide-round-clip of
    the same rotated k and v)."""
    B, E, H, Hkv, Smax, T = 3, 128, 4, 2, 24, 5
    D = E // H
    shape = (B, Hkv, Smax, D)
    if kv == "int8":
        caches = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
    else:
        caches = [rng.normal(size=shape).astype(np.float32) for _ in range(2)]
    pos = np.array([Smax - T, Smax - 2, 3] if at_end else [0, 10, 17], np.int32)
    arrays = ([rng.normal(size=(B, T, E)).astype(np.float32)]
              + _attn_weights(rng, E, H, Hkv, D) + caches + [pos])
    attrs = dict(num_heads=H, num_kv_heads=Hkv, rope=True, cache_update=mode)
    if kv == "int8":
        attrs.update(kv_cache_dtype="int8", k_scale=0.05, v_scale=0.04)
    before = [c.copy() for c in caches]  # the port writes into its inputs
    got, want = _run_both("mha_verify", arrays, [None] * 8, [None] * 8, **attrs)
    assert tuple(got[0].shape) == (B, T, E)
    _close_f32(got[0], want[0], rtol=1e-4)
    for g_c, w_c, c0 in zip(got[1:], want[1:], before):
        if kv == "int8":
            np.testing.assert_array_equal(g_c.numpy(), np.asarray(w_c))
        else:
            _close_f32(g_c, w_c)
        assert not np.array_equal(np.asarray(w_c), c0)  # the chunk was written


def test_verify_net_matches_jax(rng, params):
    """The verify graph (`mha_verify` in every layer) through `Net`, int8
    caches, against the JAX `Net`: logits within rtol 1e-4 of the largest,
    caches equal."""
    jc, pc = _cfgs()
    g = jax_tf.build_transformer_verify_step(jc, 2, 4, params,
                                             kv_cache_dtype="int8")
    feed = _feed(rng, g)
    want = ak.Net(g).prediction({k: v.copy() for k, v in feed.items()})
    got = pt.Net(graph_from_jax(g), device="cpu").prediction(
        {k: v.copy() for k, v in feed.items()})
    _close_f32(got[g.outputs[0]], want[g.outputs[0]], rtol=1e-4)
    for e in g.outputs[1:]:
        np.testing.assert_array_equal(got[e].numpy(), np.asarray(want[e]))


# ------------------------------------------------------------- Net

def _decode_graph(params, **kw):
    _, pc = _cfgs()
    return pt_tf.build_transformer_decode_step(pc, 2, params, **kw)


def test_net_device_params_shares_the_weights(params):
    """A second Net on another graph of the same weights runs on the first
    one's tensors themselves; an edge the dict lacks raises KeyError."""
    _, pc = _cfgs()
    a = pt.Net(_decode_graph(params), device="cpu")
    v = pt.Net(pt_tf.build_transformer_verify_step(pc, 2, 4, params),
               device="cpu", device_params=a.params)
    assert set(v.params) == set(a.params)
    assert all(v.params[k] is a.params[k] for k in v.params)
    assert v.params.prepared is a.params.prepared
    with pytest.raises(KeyError, match="lm_head"):
        pt.Net(_decode_graph(params), device="cpu", device_params={
            k: t for k, t in a.params.items() if k != "lm_head"})


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_net_strict_sync_raises_on_a_non_finite_output(precision):
    """strict_sync: a NaN in a float output raises FloatingPointError (in
    a bf16 net too); a finite step returns."""
    b = pt.GraphBuilder("d")
    w = b.graph.add_param("w", np.ones((4, 3), np.float32))
    x = b.input((2, 4), name="input")
    b.output(b.op("dense", [x, w]))
    g = b.finish()
    net = pt.Net(g, precision=precision, device="cpu", strict_sync=True)
    out = net.prediction({"input": np.ones((2, 4), np.float32)})
    assert torch.isfinite(out[g.outputs[0]].float()).all()
    bad = np.ones((2, 4), np.float32)
    bad[1, 2] = np.nan
    with pytest.raises(FloatingPointError, match="non-finite"):
        net.prediction({"input": bad})
    pt.Net(g, precision=precision, device="cpu").prediction({"input": bad})


def test_net_op_timer_reports_each_node(rng, params):
    """enable_op_timer: one line per node, "name(op)" with its mean ms and
    the step count, the same keys as the JAX Net's report, then the TOTAL
    line; the summary resets; with the timer off, the JAX Net's report."""
    jc, _ = _cfgs()
    jg = jax_tf.build_transformer_decode_step(jc, 2, params)
    feed = _feed(rng, jg)
    for e, (shape, dt) in jg.input_specs.items():
        if dt == "float32":
            feed[e] = rng.normal(size=shape).astype(np.float32)
    net = pt.Net(graph_from_jax(jg), device="cpu", enable_op_timer=True)
    for _ in range(2):
        net.prediction({k: v.copy() for k, v in feed.items()})
    report = net.print_and_reset_optime_summary().splitlines()
    jnet = ak.Net(jg, enable_op_timer=True)
    jnet.prediction(feed)
    jreport = jnet.print_and_reset_optime_summary().splitlines()
    assert len(report) == len(net.order) + 1 == len(jreport)
    keys = sorted(line.split()[0] for line in report[:-1])
    assert keys == sorted(line.split()[0] for line in jreport[:-1])
    assert keys == sorted(f"{n.name}({n.op})" for n in net.order)
    assert all(line.endswith("ms (n=2)") for line in report[:-1])
    assert report[-1].startswith("TOTAL (sum of op means)")
    total = sum(float(line.split()[-3]) for line in report[:-1])
    assert abs(float(report[-1].split()[-2]) - total) < 1e-3
    assert net.print_and_reset_optime_summary().splitlines()[0].startswith(
        "TOTAL")
    off = pt.Net(graph_from_jax(jg), device="cpu")
    off.prediction({k: v.copy() for k, v in feed.items()})
    assert off.print_and_reset_optime_summary() == \
        ak.Net(jg).print_and_reset_optime_summary()


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("weights", ["float", "w4"])
def test_net_param_bytes_match_jax(params, precision, weights):
    """param_bytes: the weights at the net's dtypes, as the JAX Net counts
    them (float params in the compute dtype, packed int4 as int8)."""
    jc, _ = _cfgs()
    g = jax_tf.build_transformer_decode_step(jc, 2, params)
    if weights == "w4":
        g = jax_weight_only_quantize(g, bits=4)
    got = pt.Net(graph_from_jax(g), precision=precision,
                 device="cpu").param_bytes()
    assert got == ak.Net(g, precision=precision).param_bytes()


def test_net_compile_on_the_cpu_equals_prediction(rng, params):
    """compile() on the CPU is the eager forward behind the replayable
    step's interface: the caches are bound as static inputs and written in
    place; logits and caches equal prediction()'s on copies of the feed."""
    g = _decode_graph(params, kv_cache_dtype="int8", cache_update="rows")
    feed = _feed(rng, g)
    feed["pos"] = np.array([3, 40], np.int32)
    net = pt.Net(g, device="cpu")
    want = net.prediction({k: v.copy() for k, v in feed.items()})
    caches = {k: torch.from_numpy(v.copy()) for k, v in feed.items()
              if k.startswith("cache_")}
    step = net.compile(dict(caches, input=feed["input"], pos=feed["pos"]),
                       static=caches)
    got = step({"input": feed["input"], "pos": feed["pos"]})
    for e in g.outputs:
        assert torch.equal(got[e], want[e]), e
    assert {id(got[e]) for e in g.outputs[1:]} == {id(t) for t in
                                                   caches.values()}
    with pytest.raises(ValueError, match="bound"):
        step(dict(caches, cache_k_0=caches["cache_k_0"].clone()))


@pytest.mark.parametrize("arg", ["mesh", "param_sharding", "input_shardings"])
def test_net_refuses_sharding(params, arg):
    """Sharding runs over a `parallel.Mesh` (tests/test_torch_parallel.py):
    a mesh of another type, and a sharding without a mesh, are refused."""
    with pytest.raises(TypeError if arg == "mesh" else ValueError,
                       match="parallel.Mesh"):
        pt.Net(_decode_graph(params), device="cpu", **{arg: {}})


# ---------------------------------------------------------- session

@pytest.mark.parametrize("greedy", [True, False])
def test_session_exact_length_prefill_matches_jax(rng, params, greedy):
    """prefill_buckets=False builds the prefill for the prompt's own
    length; generate(greedy=...) takes the argmax either way, as the JAX
    session does: the same tokens."""
    jc, pc = _cfgs()
    prompt = rng.integers(0, CFG["vocab"], (2, 20)).astype(np.int32)
    js = JaxSession(jc, batch=2, params=params, prefill_buckets=False)
    ps = GenerationSession(pc, batch=2, params=params, prefill_buckets=False,
                           device="cpu")
    assert ps._bucket(20) == js._bucket(20) == 20
    np.testing.assert_array_equal(ps.generate(prompt, 5, greedy=greedy),
                                  js.generate(prompt, 5, greedy=greedy))
    assert list(ps._prefill_nets) == [20]
