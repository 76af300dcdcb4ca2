"""Plain PyTorch references of the benchmark's configurations: float32
(TF32 off), exact integer products where the configuration states int8,
no kernels, no cache, no batching.  They import nothing of the program and
take nothing it made: weights, scales and inputs come from the benchmark
(`portbench.inputs`, the configuration's files)."""

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """Float32 products in full float32 inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
