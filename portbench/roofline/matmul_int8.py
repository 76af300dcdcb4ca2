"""`matmul_int8`: a [M, K] int8 x b [K, N] int8 with the fused epilogue
(scale row, bias, residual, activation, requant or a float output)."""

WRAP = ("anakin_tpu_torch.kernels.matmul_int8", "_matmul_int8")
MAIN = (r"igemm_s8<false", r"igemm_s8ILb0E")
AUX = ()

_ESIZE = {"torch.int8": 1, "torch.bfloat16": 2, "torch.float32": 4}


def key(a, b, w_scale, bias, residual, *, out_scale, out_dtype, **_):
    """(M, K, N, bias, residual bytes an element, output bytes an element)."""
    M, K = a.shape
    N = b.n if hasattr(b, "n") else b.shape[1]
    res = 0 if residual is None else _ESIZE[str(residual.dtype)]
    out = 1 if out_scale is not None else _ESIZE[str(out_dtype)]
    return (int(M), int(K), int(N), bias is not None, res, out)


def cost(key):
    M, K, N, bias, res, out = key
    nbytes = (M * K + K * N + 4 * N * (2 if bias else 1)
              + M * N * res + M * N * out)
    return 2 * M * N * K, nbytes, "int8"
