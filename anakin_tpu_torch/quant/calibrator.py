"""Scale-table IO: the "name scale" text sidecar of the reference's
calibrator (`anakin_tpu/quant/calibrator.py:296-311`).

Calibration itself (`calibrate`, KL and max) is not ported yet; graphs are
quantized here from a table written by either package.
"""

from __future__ import annotations

from typing import Dict

__all__ = ["read_scale_table", "write_scale_table"]


def write_scale_table(scales: Dict[str, float], path: str) -> None:
    """Text "name scale" lines — same sidecar format as the reference."""
    with open(path, "w") as f:
        for k in sorted(scales):
            f.write(f"{k} {scales[k]:f}\n")


def read_scale_table(path: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out[parts[0]] = float(parts[1])
    return out
