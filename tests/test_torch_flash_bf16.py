"""The arithmetic of the port's bf16 flash route on wgmma (`csrc/flash_attention.cu`,
`flash_wgmma`), emulated in numpy, against the Pallas kernel in interpret mode.
The CUDA kernel itself runs only on the card; this file holds its numerics to
the JAX kernel on the CPU, so that a change of its tiles or of the P split is
seen here first.

What is emulated, as the kernel does it:
  * bf16 q, k and v; S = q k^T with the bf16 products exact and the sums in
    float32 (the tensor cores' float32 accumulation, in another order);
  * kv tiles of the route's BN keys (128 at D <= 128, 64 at D 256), keys past
    Sk weighing exactly 0;
  * the online softmax in log2 units: scores times sm_scale * log2 e, masked
    scores at the Pallas mask value, the running max and sum, the accumulator
    rescaled by exp2 of the max's move;
  * P V with P = hi + lo, hi = bf16(P) and lo = bf16(P - hi), each half a
    bf16 product with v summed in float32; out = acc * (1 / sum), which the
    kernel rounds to bf16 as it stores it.

Tolerance: the route's own, |diff| <= 2^-7 |want| + 3e-5 max|v|
(csrc/flash_attention.cu, chip_smoke.py's check_flash).  Before the bf16
store the emulation stays within a tenth of it of the Pallas kernel's
float32 result; the two bf16 stores stay within it.  A single bf16 rounding of P
misses it several times over at D 128, which is why the kernel pays for the
lo product.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from anakin_tpu.kernels.flash_attention import flash_attention as jax_flash

MASK = np.float32(-0.7 * float(np.finfo(np.float32).max))
LOG2E = np.float32(1.4426950408889634)
REL, ABS = 2.0 ** -7, 3e-5  # of |want|, of max|v|


def bf16(x):
    """float32 -> bf16 (round to nearest, ties to even), kept in float32."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return b.view(np.float32)


def kv_tile(D):
    """The route's keys a kv tile (registers: D 256 holds a 64 x 256 float32
    accumulator a warpgroup)."""
    return 64 if D > 128 else 128


def split_pv(p, v):
    """P V as the kernel's two bf16 products into float32."""
    hi = bf16(p)
    lo = bf16(p - hi)
    return hi @ v + lo @ v


def single_pv(p, v):
    """P V with P rounded to bf16 once (what the kernel does not do)."""
    return bf16(p) @ v


def emulate(q, k, v, segs, causal, pv=split_pv):
    """The route's forward on bf16-valued q [B, H, Sq, D], k, v [B, Hkv, Sk,
    D] (grouped heads read in place), segment ids [B, S] or None, in
    float32, before the store's rounding to bf16."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    BN = kv_tile(D)
    sc = np.float32(1.0 / np.sqrt(D)) * LOG2E
    rows = np.arange(Sq)[:, None]
    out = np.empty_like(q)
    for b in range(B):
        for h in range(H):
            qh, kh, vh = q[b, h], k[b, h // (H // Hkv)], v[b, h // (H // Hkv)]
            m = np.full((Sq, 1), -np.inf, np.float32)
            l = np.zeros((Sq, 1), np.float32)
            acc = np.zeros((Sq, D), np.float32)
            for k0 in range(0, Sk, BN):
                cols = np.arange(k0, k0 + BN)[None, :]
                n = min(BN, Sk - k0)
                kt = np.zeros((BN, D), np.float32)
                vt = np.zeros((BN, D), np.float32)
                kt[:n], vt[:n] = kh[k0:k0 + BN], vh[k0:k0 + BN]
                s = (qh @ kt.T) * sc
                keep = np.ones(s.shape, bool)
                if causal:
                    keep &= cols <= rows
                if segs is not None:
                    kseg = np.zeros(BN, segs.dtype)
                    kseg[:n] = segs[b, k0:k0 + BN]
                    keep &= segs[b][:, None] == kseg[None, :]
                s = np.where(keep, s, MASK)
                s = np.where(cols < Sk, s, -np.inf).astype(np.float32)
                m_new = np.maximum(m, s.max(axis=1, keepdims=True))
                alpha = np.exp2(m - m_new)
                p = np.exp2(s - m_new)
                l = alpha * l + p.sum(axis=1, keepdims=True, dtype=np.float32)
                acc = acc * alpha + pv(p, vt)
                m = m_new
            out[b, h] = acc * np.where(l == 0, np.float32(1), 1 / l)
    return out


CASES = ["causal", "full", "segments", "gqa_causal", "cross", "ragged"]


def _case(rng, case, D):
    """B 2, H 4 at S 128-256: a group of two query heads per kv head
    (gqa_causal), Sk 256 against Sq 128 (cross), and lengths 200 and 137
    inside S 200 (ragged: not a whole kv tile; the rows past each length
    are another segment and are not compared)."""
    B, H = 2, 4
    Hkv = 2 if case == "gqa_causal" else 4
    S = {"cross": 128, "ragged": 200}.get(case, 256 if case == "full" else 128)
    Sk = 256 if case == "cross" else S
    q = bf16(rng.normal(size=(B, H, S, D)))
    k = bf16(rng.normal(size=(B, Hkv, Sk, D)))
    v = bf16(rng.normal(size=(B, Hkv, Sk, D)))
    segs, lengths = None, None
    if case == "segments":
        segs = np.sort(rng.integers(0, 3, (B, S)), axis=1).astype(np.int32)
    if case == "ragged":
        lengths = [200, 137]
        segs = (np.arange(S)[None] >= np.array(lengths)[:, None]).astype(np.int32)
    causal = case in ("causal", "gqa_causal", "ragged")
    return q, k, v, segs, causal, lengths


def _pallas(q, k, v, segs, causal, dtype=jnp.float32):
    """The Pallas kernel on the bf16-valued inputs in `dtype`: it computes in
    float32 either way and stores its output in `dtype`."""
    rep = q.shape[1] // k.shape[1]
    seg = None if segs is None else jnp.asarray(segs)
    out = jax_flash(
        jnp.asarray(q, dtype), jnp.asarray(np.repeat(k, rep, 1), dtype),
        jnp.asarray(np.repeat(v, rep, 1), dtype), seg, seg, causal=causal,
        block_q=64, block_k=64, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _excess(got, want, v, lengths):
    """max over the compared rows of |got - want| / tolerance (<= 1 passes)."""
    tol = REL * np.abs(want) + ABS * float(np.abs(v).max())
    r = np.abs(got - want) / tol
    if lengths is not None:
        r = np.concatenate([r[b, :, :n] for b, n in enumerate(lengths)], axis=1)
    return float(r.max())


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("case", CASES)
def test_wgmma_route_matches_pallas(rng, case, D):
    """The arithmetic before the store within a tenth of the tolerance of
    the Pallas kernel's float32 result (these cases: 0.005-0.024 of it)."""
    q, k, v, segs, causal, lengths = _case(rng, case, D)
    want = _pallas(q, k, v, segs, causal)
    got = emulate(q, k, v, segs, causal)
    assert _excess(got, want, v, lengths) <= 0.1, case


@pytest.mark.parametrize("D", [64, 128, 256])
def test_bf16_stores_match_pallas_in_bf16(rng, D):
    """Both outputs rounded to bf16, as the kernel and the Pallas kernel on
    bf16 inputs store them (what the card's check compares): one bf16 ulp
    apart at most, within the tolerance."""
    q, k, v, segs, causal, lengths = _case(rng, "causal", D)
    want = _pallas(q, k, v, segs, causal, jnp.bfloat16)
    got = bf16(emulate(q, k, v, segs, causal))
    assert _excess(got, want, v, lengths) <= 1.0


def test_single_bf16_p_misses_the_tolerance(rng):
    """P rounded to bf16 once, on the same inputs at D 128: its error
    exceeds the route's tolerance, the hi + lo split's does not."""
    q, k, v, segs, causal, lengths = _case(rng, "causal", 128)
    want = _pallas(q, k, v, segs, causal)
    single = _excess(emulate(q, k, v, segs, causal, single_pv), want, v, lengths)
    split = _excess(emulate(q, k, v, segs, causal), want, v, lengths)
    assert split <= 1.0 < single, (split, single)


def test_p_split_keeps_sixteen_bits():
    """hi + lo is P within 2^-16 of |P| (each half rounded to 8 significant
    bits, lo about 2^-8 of hi); hi alone only within 2^-8."""
    p = np.random.default_rng(0).uniform(0, 1, 4096).astype(np.float32)
    hi = bf16(p)
    lo = bf16(p - hi)
    assert np.all(np.abs(p - hi) <= p * 2.0 ** -8)
    assert np.all(np.abs(p - (hi + lo)) <= p * 2.0 ** -16)
    np.testing.assert_array_equal(bf16(np.float32([1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8])),
                                  np.float32([1, 1 + 2 * 2.0 ** -7]))
