"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  A card set to a
lower power limit runs below them; the run prints the card's limit beside
every share it reports."""

PEAK_OPS = {
    "int8": 1979e12,   # int8 tensor cores, op/s
    "bf16": 989e12,    # bf16 tensor cores, flop/s
    "tf32": 495e12,    # TF32 tensor cores, flop/s
    "fp32": 67e12,     # float32 outside the tensor cores, flop/s
}
HBM_BYTES_PER_S = 3.35e12  # HBM3, bytes/s


def bound_s(ops: float, nbytes: float, peak: str) -> float:
    """The least seconds the chip could take: the larger of the bytes over
    HBM bandwidth and the operations over the peak of their type."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[peak])
