"""`conv3x3_int8`: a 3x3 stride-1 pad-1 int8 conv, x [N, H, W, C], with
the fused epilogue of `matmul_int8`."""

WRAP = ("anakin_tpu_torch.kernels.conv_int8", "_conv3x3_int8")
MAIN = (r"igemm_s8<true", r"igemm_s8ILb1E")
AUX = ()

_ESIZE = {"torch.int8": 1, "torch.bfloat16": 2, "torch.float32": 4}


def key(x, w, w_scale, bias, residual, *, out_scale, out_dtype, **_):
    """(N, H, W, C, O, bias, residual bytes an element, output bytes)."""
    N, H, W, C = x.shape
    O = w.n if hasattr(w, "n") else w.shape[3]
    res = 0 if residual is None else _ESIZE[str(residual.dtype)]
    out = 1 if out_scale is not None else _ESIZE[str(out_dtype)]
    return (int(N), int(H), int(W), int(C), int(O), bias is not None, res,
            out)


def cost(key):
    N, H, W, C, O, bias, res, out = key
    m, k = N * H * W, 9 * C
    nbytes = (m * C + k * O + 4 * O * (2 if bias else 1)
              + m * O * res + m * O * out)
    return 2 * m * O * k, nbytes, "int8"
