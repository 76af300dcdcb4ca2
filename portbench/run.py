"""Run one benchmark cell once on this machine's GPU and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Sets up the cell (weights and inputs from
the seed, the program built and warmed on every shape the cell's traffic
uses), measures for `--seconds` seconds, checks what the timed path
produced against the plain reference, and prints one JSON object as the
last line of standard output: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics), `device`, with `--trace 1` `breakdown`, and last
`checks`, each number compared beside its limit.  The same numbers are the
last lines of standard error.  Exits non-zero, printing no result, without
CUDA or with fewer GPUs than the cell asks for, or if the JAX package or
JAX was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "anakin_tpu")


def _fixed_caches() -> None:
    """Every build and kernel cache a library might keep goes to a fixed
    directory inside the checkout (the port's own kernels build into
    `build/anakin_tpu_torch/` there already)."""
    cache = os.path.join(spec.OUT, "cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ.setdefault("USE_FLAX", "0")


def _loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _fixed_caches()
    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _log(f"{args.workload} needs {cell.chips} CUDA device(s); "
             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    from .harness import run_cell
    from .roofline.peaks import HBM_BYTES_PER_S, PEAK_OPS

    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   cell=cell, log=_log)
    _log(f"card: {_power_limit()}; published peaks (H100 SXM, 700 W): "
         + ", ".join(f"{k} {v / 1e12:g} T/s" for k, v in PEAK_OPS.items())
         + f", HBM {HBM_BYTES_PER_S / 1e12:g} TB/s")
    bad = _loaded_forbidden()
    if bad:
        _log(f"refusing to report: {', '.join(bad)} loaded in this process")
        return 3
    _log(f"correct {out['correct']}")
    for name, c in out["checks"].items():
        _log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
