"""The readings that the limits of `checks/<cell>.json` are set from:
for each seed, one run of the cell (set-up, a window, the check) and the
lower-precision control in the program's place, read on the same sample
and judged by the same limits, in one process.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--fault-seeds 4,5]

Prints one JSON line a seed: the program's numbers and `correct`, and the
control's.  `--fault-seeds`: then, in the same process, plants a fault in
the program (each request's third token altered where it is produced)
and reads its numbers on those seeds.  Exits 1 if a control or a planted
fault came out correct, or a sound run did not.  Not run by the
benchmark's own runs."""

from __future__ import annotations

import argparse
import json
import sys

from .run import _fixed_caches


def _plant_token_fault() -> None:
    from anakin_tpu_torch.runtime.decode_scheduler import DecodeScheduler

    real = DecodeScheduler._emit

    def altered(self, slot, tok):
        if slot.generated == 2:
            tok = (tok + 1) % self.cfg.vocab
        return real(self, slot, tok)

    DecodeScheduler._emit = altered


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--no-control", action="store_true")
    p.add_argument("--fault-seeds", default="",
                   help="seeds read with each request's third token "
                        "altered where the scheduler emits it")
    args = p.parse_args(argv)
    _fixed_caches()
    from .harness import run_cell

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    wrong, planted = 0, False
    runs = [(s, None) for s in _seeds(args.seeds)] + \
        [(s, "token") for s in _seeds(args.fault_seeds)]
    for s, fault in runs:
        if fault and not planted:
            _plant_token_fault()
            planted = True
        out = run_cell(args.workload, s, args.seconds, False,
                       control=not args.no_control and fault is None,
                       log=log)
        ctl = out.get("control")
        wrong += out["correct"] != (fault is None)
        wrong += bool(ctl and ctl["correct"])
        print(json.dumps({"seed": s, "fault": fault,
                          "correct": out["correct"],
                          "metrics": out["metrics"],
                          "checks": out["checks"], "control": ctl}),
              flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
