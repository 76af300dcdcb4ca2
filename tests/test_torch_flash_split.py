"""The arithmetic of the port's float32 flash route (`csrc/flash_attention.cu`,
`flash_tf32`), emulated in numpy, against the Pallas kernel in interpret
mode.  The CUDA kernel itself runs only on the card; this file holds its
numerics to the JAX kernel on the CPU, so that a change of the split is
seen here first.

What is emulated, as the kernel does it:
  * TF32 as the tensor core reads a float32 register: its low 13 bits
    ignored (truncation);
  * hi = x rounded to TF32 as `cvt.rna.tf32.f32` rounds (the kernel adds
    2^12 to the float32 bits and the MMA drops the low 13: nearest, ties
    away from zero), lo = x - hi, which the MMA reads truncated;
  * the three-product split a b = lo_a hi_b + hi_a lo_b + hi_a hi_b,
    float32 sums, for both q k^T and P V;
  * the online softmax in log2 units over kv tiles of 32 keys (the route's
    tile with one row tile a warp, which these sizes take): masked scores
    at the Pallas mask value, the running max and sum, the accumulator
    rescaled by exp2 of the max's move, out = acc * (1 / sum).

Tolerance: the route's own, |diff| <= 3e-5 max|v| (csrc/flash_attention.cu).
One TF32 pass instead of the split misses it at D 128, which is why the
kernel pays three products.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from anakin_tpu.kernels.flash_attention import flash_attention as jax_flash

MASK = np.float32(-0.7 * float(np.finfo(np.float32).max))
LOG2E = np.float32(1.4426950408889634)
KV_TILE = 32
TOL = 3e-5  # of max|v|


def _bits(x):
    return np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)


def tf32(x):
    """float32 -> TF32 (10 mantissa bits) as cvt.rna rounds, on the bits."""
    return ((_bits(x) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_read(x):
    """A float32 register as the tensor core reads it: TF32, truncated."""
    return (_bits(x) & np.uint32(0xFFFFE000)).view(np.float32)


def split_mm(a, b):
    """a @ b as the kernel's three TF32 products into float32."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32_read(a - ah), tf32_read(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def single_mm(a, b):
    """a @ b as one TF32 product (what the kernel does not do)."""
    return tf32(a) @ tf32(b)


def emulate(q, k, v, segs, causal, mm=split_mm):
    """The route's forward on float32 q [B, H, Sq, D], k, v [B, Hkv, Sk, D]
    (grouped heads read in place), segment ids [B, S] or None."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    sc = np.float32(1.0 / np.sqrt(D)) * LOG2E
    rows = np.arange(Sq)[:, None]
    out = np.empty_like(q)
    for b in range(B):
        for h in range(H):
            qh, kh, vh = q[b, h], k[b, h // (H // Hkv)], v[b, h // (H // Hkv)]
            m = np.full((Sq, 1), -np.inf, np.float32)
            l = np.zeros((Sq, 1), np.float32)
            acc = np.zeros((Sq, D), np.float32)
            for k0 in range(0, Sk, KV_TILE):
                cols = np.arange(k0, k0 + KV_TILE)[None, :]
                kt = np.zeros((KV_TILE, D), np.float32)
                vt = np.zeros((KV_TILE, D), np.float32)
                kt[:min(KV_TILE, Sk - k0)] = kh[k0:k0 + KV_TILE]
                vt[:min(KV_TILE, Sk - k0)] = vh[k0:k0 + KV_TILE]
                s = mm(qh, kt.T) * sc
                keep = np.ones(s.shape, bool)
                if causal:
                    keep &= cols <= rows
                if segs is not None:
                    kseg = np.zeros(KV_TILE, segs.dtype)
                    kseg[:min(KV_TILE, Sk - k0)] = segs[b, k0:k0 + KV_TILE]
                    keep &= segs[b][:, None] == kseg[None, :]
                s = np.where(keep, s, MASK)
                s = np.where(cols < Sk, s, -np.inf).astype(np.float32)
                m_new = np.maximum(m, s.max(axis=1, keepdims=True))
                alpha = np.exp2(m - m_new)
                p = np.exp2(s - m_new)
                l = alpha * l + p.sum(axis=1, keepdims=True, dtype=np.float32)
                acc = acc * alpha + mm(p, vt)
                m = m_new
            out[b, h] = acc * np.where(l == 0, np.float32(1), 1 / l)
    return out


def _case(rng, case):
    """The cases of test_torch_llm.py's test_flash_attention_plain_matches_
    pallas at D 32, plus a causal one at D 128."""
    D = 128 if case == "causal_d128" else 32
    B, H, Hkv, S = 2, 4, (2 if case.startswith("gqa") else 4), 128
    Sk = 256 if case == "cross" else S
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32)
    segs = None
    if case == "segments":
        segs = np.sort(rng.integers(0, 3, (B, S)), axis=1).astype(np.int32)
    causal = case in ("causal", "gqa_causal", "causal_d128")
    return q, k, v, segs, causal


def _pallas(q, k, v, segs, causal):
    rep = q.shape[1] // k.shape[1]
    seg = None if segs is None else jnp.asarray(segs)
    return np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(np.repeat(k, rep, 1)),
        jnp.asarray(np.repeat(v, rep, 1)), seg, seg, causal=causal,
        block_q=64, block_k=64, interpret=True))


@pytest.mark.parametrize("case", ["causal", "full", "segments", "gqa_causal",
                                  "cross", "causal_d128"])
def test_split_tf32_matches_pallas(rng, case):
    q, k, v, segs, causal = _case(rng, case)
    want = _pallas(q, k, v, segs, causal)
    got = emulate(q, k, v, segs, causal)
    err = float(np.abs(got - want).max())
    assert err <= TOL * float(np.abs(v).max()), (case, err)


def test_single_pass_tf32_misses_the_tolerance(rng):
    """One TF32 product for q k^T and P V, on the same inputs at D 128: its
    error exceeds the route's tolerance, the split's does not."""
    q, k, v, segs, causal = _case(rng, "causal_d128")
    want = _pallas(q, k, v, segs, causal)
    tol = TOL * float(np.abs(v).max())
    single = float(np.abs(emulate(q, k, v, segs, causal, single_mm) - want).max())
    split = float(np.abs(emulate(q, k, v, segs, causal) - want).max())
    assert split <= tol < single, (split, tol, single)


def test_tf32_rounds_as_cvt_rna():
    """hi: nearest, ties away from zero, on 10 mantissa bits; hi + lo,
    lo read truncated, keeps about 21 bits."""
    ulp = 2.0 ** -10
    x = np.array([1 + ulp / 2, 1 + ulp / 2 - 2.0 ** -23, -(1 + ulp / 2),
                  1 + 1.5 * ulp], np.float32)
    np.testing.assert_array_equal(
        tf32(x), np.array([1 + ulp, 1, -(1 + ulp), 1 + 2 * ulp], np.float32))
    y = np.random.default_rng(0).normal(size=4096).astype(np.float32)
    hi = tf32(y)
    lo = tf32_read(y - hi)
    assert np.all(np.abs(y - hi) <= np.abs(y) * 2.0 ** -11)
    assert np.all(np.abs(y - (hi + lo)) <= np.abs(y) * 2.0 ** -21)
    np.testing.assert_array_equal(tf32_read(np.float32(1 + 1.5 * ulp)),
                                  np.float32(1 + ulp))
