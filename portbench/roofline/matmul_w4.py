"""`matmul_w4`: x [M, K] @ the int4 weight [K/2, N] packed two to a byte,
one scale a group of G rows a column, float32 output.  bf16 x at the bf16
tensor-core rate; float32 x with G % 32 == 0 as its routes compute it, two
TF32 products a product; any other float32 group on the CUDA cores."""

WRAP = ("anakin_tpu_torch.kernels.matmul_w4", "_matmul_w4")
MAIN = (r"w4_small", r"w4_wgmma", r"w4_rows")
AUX = (r"sum_splits",)


def key(x, packed, scales, *, group, **_):
    """(M, K, N, G, x bytes an element, scale bytes an element)."""
    M, K = x.shape
    return (int(M), int(K), int(packed.shape[1]), int(group),
            int(x.element_size()), int(scales.element_size()))


def cost(key):
    M, K, N, G, xb, sb = key
    nbytes = K // 2 * N + (K // G) * N * sb + M * K * xb + M * N * 4
    ops = 2 * M * N * K
    if xb == 2:
        return ops, nbytes, "bf16"
    if G % 32 == 0:
        return 2 * ops, nbytes, "tf32"
    return ops, nbytes, "fp32"
