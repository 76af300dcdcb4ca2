"""The arithmetic of the port's float32 `matmul_w4` routes (`csrc/matmul_w4.cu`:
`w4_small` on TF32 mma.sync, M <= 16, and `w4_wgmma_tf32`, M > 16),
emulated in numpy, against the Pallas kernel in interpret mode; and the
half-chunk index map that lets the tensor-core routes take every group
that is a multiple of 32.  The CUDA kernels run only on the card; this
file holds their numerics and their indexing to the JAX kernel on the CPU.

What is emulated, as the kernels do it:
  * TF32 as the tensor core reads a float32 register: its low 13 bits
    ignored (truncation);
  * x_hi = x rounded to TF32 as `cvt.rna.tf32.f32` rounds (split_tf32 adds
    2^12 to the bits), x_lo = x - x_hi, read truncated;
  * the weight's signed nibble as the A operand, exact in TF32;
  * per half-chunk (16 packed rows, one group): acc_g = q x_hi + q x_lo in
    float32, then acc = fma(s, acc_g, acc) with the group's scale.

Tolerance: the check the card holds every `matmul_w4` row to
(`chip_smoke.py::check_w4`), |d| <= 2 K 2^-24 (|x| @ |W|), W the plain
version's dequantized weights.  One TF32 pass instead of the split misses
it at K 2048, which is why the routes pay two products.
"""

import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from anakin_tpu.kernels.matmul_w4 import matmul_w4 as jax_matmul_w4
from anakin_tpu.quant.quantize import _w4_group_quantize
from anakin_tpu_torch.kernels import _build
from anakin_tpu_torch.kernels.matmul_w4 import unpack_w4

HALF_CHUNK = 16  # packed rows


def _bits(x):
    return np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)


def tf32(x):
    """float32 -> TF32 (10 mantissa bits) as cvt.rna rounds, on the bits."""
    return ((_bits(x) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_read(x):
    """A float32 register as the tensor core reads it: TF32, truncated."""
    return (_bits(x) & np.uint32(0xFFFFE000)).view(np.float32)


def nibbles(packed):
    """(low, high) signed nibbles of packed [K/2, N] int8, as float32."""
    p = packed.astype(np.int32)
    return (((p & 0xF) ^ 8) - 8).astype(np.float32), (p >> 4).astype(np.float32)


def half_chunks(K, G):
    """The half-chunk map: for each half-chunk of packed rows 16 hc ..
    16 hc + 15, (its first packed row, its group, the k of x at its low
    nibbles, the k at its high nibbles), each run 16 long; None where a
    half-chunk straddles two groups (G % 32 != 0)."""
    half = G // 2
    out = []
    for hc in range(-(-(K // 2) // HALF_CHUNK)):
        prow = HALF_CHUNK * hc
        grp = prow // half
        if (prow + HALF_CHUNK - 1) // half != grp:
            return None
        klo = grp * G + prow - grp * half
        out.append((prow, grp, klo, klo + half))
    return out


def emulate(x, packed, scales, G, single=False):
    """x [M, K] @ dequant(packed, scales) as the float32 routes compute it
    (`single`: one TF32 product of x instead of the split)."""
    M, K = x.shape
    lo_q, hi_q = nibbles(packed)
    if single:
        parts = [tf32(x)]
    else:
        xh = tf32(x)
        parts = [xh, tf32_read(x - xh)]
    s = scales.astype(np.float32).astype(np.float64)
    acc = np.zeros((M, packed.shape[1]), np.float32)
    for prow, grp, klo, khi in half_chunks(K, G):
        rows = slice(prow, prow + HALF_CHUNK)
        accg = np.zeros_like(acc)
        for xp in parts:
            accg += xp[:, klo:klo + HALF_CHUNK] @ lo_q[rows]
            accg += xp[:, khi:khi + HALF_CHUNK] @ hi_q[rows]
        acc = (s[grp] * accg + acc).astype(np.float32)  # one rounding: an FMA
    return acc


def _pallas(x, packed, scales, G, variant):
    return np.asarray(jax_matmul_w4(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales), group=G,
        block_n=256, block_k=256, variant=variant, interpret=True))


def _bound(x, packed, scales, G):
    """check_w4's tolerance: 2 K 2^-24 (|x| @ |W|)."""
    w = unpack_w4(torch.from_numpy(packed), torch.from_numpy(scales), G,
                  torch.float32).numpy().astype(np.float64)
    K = x.shape[1]
    return 2 * K * 2.0 ** -24 * (np.abs(x.astype(np.float64)) @ np.abs(w))


@pytest.mark.parametrize("variant", ["v1", "v2"])
@pytest.mark.parametrize("M", [5, 17])
@pytest.mark.parametrize("G,K", [(32, 256), (64, 256), (96, 288), (128, 384)])
def test_tf32_split_matches_pallas(rng, variant, M, G, K):
    """Float32 x on the TF32 routes against the Pallas kernel: G 32 (two
    groups a chunk), 64, 96 (a chunk straddles a group at its half, K / 2
    an odd number of half-chunks), 128; M <= 16 and M > 16 share the
    arithmetic."""
    N = 136
    packed, scales, g = _w4_group_quantize(
        rng.normal(0.0, K ** -0.5, (K, N)).astype(np.float32), G)
    x = rng.normal(size=(M, K)).astype(np.float32)
    want = _pallas(x, packed, scales, g, variant)
    got = emulate(x, packed, scales, g)
    d = np.abs(got.astype(np.float64) - want)
    assert (d <= _bound(x, packed, scales, g)).all(), float(d.max())


def test_single_pass_tf32_misses_the_tolerance():
    """One TF32 product of x, at K 2048 on inputs whose roundings all go
    one way (x just under a TF32 tie, rounded down by ~2^-11 of itself;
    positive nibbles): its error exceeds 2 K 2^-24 (|x| @ |W|) = 2^-12
    of it, the split's does not."""
    K, N, M, G = 2048, 128, 5, 128
    rng = np.random.default_rng(3)
    w = rng.uniform(0.5, 1.0, (K, N)).astype(np.float32)
    packed, scales, g = _w4_group_quantize(w, G)
    x = np.full((M, K), 1 + 2.0 ** -11 - 2.0 ** -22, np.float32)
    x *= rng.choice([1.0, 2.0, 4.0], (M, K)).astype(np.float32)
    want = _pallas(x, packed, scales, g, "v1").astype(np.float64)
    tol = _bound(x, packed, scales, g)
    split = np.abs(emulate(x, packed, scales, g) - want)
    single = np.abs(emulate(x, packed, scales, g, single=True) - want)
    assert (split <= tol).all(), float((split / tol).max())
    assert (single > tol).any(), float((single / tol).max())


def test_split_keeps_21_bits():
    """x_hi + x_lo, x_lo read truncated, is x within 2^-21 of it; x_hi
    alone only within 2^-11."""
    y = np.random.default_rng(0).normal(size=4096).astype(np.float32)
    hi = tf32(y)
    lo = tf32_read(y - hi)
    assert np.all(np.abs(y - hi) <= np.abs(y) * 2.0 ** -11)
    assert np.all(np.abs(y - (hi + lo)) <= np.abs(y) * 2.0 ** -21)


@pytest.mark.parametrize("G,K", [(32, 256), (64, 256), (96, 288), (128, 384),
                                 (160, 320), (32, 32), (96, 96)])
def test_half_chunk_map_is_unpack_w4(rng, G, K):
    """The tensor-core routes' index map (each half-chunk's group, scale
    row and its low and high runs of x) rebuilds unpack_w4's [K, N]
    exactly for every G % 32 == 0, K = G and K / 2 an odd number of
    half-chunks included; every k of x is read once."""
    N = 24
    packed, scales, g = _w4_group_quantize(
        rng.normal(size=(K, N)).astype(np.float32), G)
    lo_q, hi_q = nibbles(packed)
    w = np.full((K, N), np.nan, np.float32)
    for prow, grp, klo, khi in half_chunks(K, g):
        rows = slice(prow, prow + HALF_CHUNK)
        for k0, q in ((klo, lo_q), (khi, hi_q)):
            assert np.isnan(w[k0:k0 + HALF_CHUNK]).all()
            w[k0:k0 + HALF_CHUNK] = q[rows] * scales[grp]
    want = unpack_w4(torch.from_numpy(packed), torch.from_numpy(scales), g,
                     torch.float32).numpy()
    np.testing.assert_array_equal(w, want)


@pytest.mark.parametrize("G,K", [(6, 96), (48, 96), (16, 64), (100, 100)])
def test_other_groups_take_the_rows_route(G, K):
    """A group that is not a multiple of 32 has a half-chunk across two
    groups, so the chunked routes cannot take it: the kernel's route_of
    sends it to w4_rows, the one route that indexes the group per row."""
    assert half_chunks(K, G) is None
    with open(f"{_build.CSRC}/matmul_w4.cu") as f:
        src = f.read()
    body = re.search(r"int route_of\(int M, int G, int bf16\) \{(.*?)\n\}", src,
                     re.S).group(1)
    first = body.strip().splitlines()[0].strip()
    assert first == "if (G % 32 != 0) return ROUTE_ROWS;", first
