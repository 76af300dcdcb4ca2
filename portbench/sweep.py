"""The knee of an open-loop cell: one set-up, then a window at each offered
rate, each drained before the next.

    python3 -m portbench.sweep --workload <cell> --seed <n> \
        --seconds <s> --rates 1,2,3

Prints one JSON line a rate: requests sent and completed a second, the
backlog (sent, not yet admitted) a third into the window and at its close,
the time to first token by thirds of the window, and the cell's end-to-end
metrics.  The knee is the highest rate whose backlog does not grow over
the window.  Not run by the benchmark's own runs."""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _backlog(sent, t):
    return sum(1 for r in sent if r.sent <= t) - sum(
        1 for r in sent if r.times and r.times[0] <= t)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    from .run import _fixed_caches

    _fixed_caches()
    import torch

    from . import loads, spec
    from .harness import Context
    from .models.decoder_w4 import Runner

    cell = spec.load_cell(args.workload)
    ctx = Context(cell, args.seed, args.seconds, False,
                  torch.device("cuda", 0))
    run = Runner(ctx)
    run.setup()
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        run.traffic = dict(cell.traffic, rate_per_s=rate)
        run.pool = loads.plan_requests(run.traffic, args.seed + i,
                                       cell.config["vocab_size"])
        run.window()
        sent, t0, t1 = run.sent, run.t_open, run.t_close
        thirds = [[1e3 * (r.times[0] - r.due) for r in sent if r.times
                   and t0 + k * (t1 - t0) / 3 <= r.due
                   < t0 + (k + 1) * (t1 - t0) / 3] for k in range(3)]
        done = [r for r in sent if r.tokens is not None]
        print(json.dumps({
            "rate": rate, "sent_per_s": len(sent) / (t1 - t0),
            "admitted_in_window_per_s": sum(
                1 for r in sent if r.times and r.times[0] <= t1) / (t1 - t0),
            "backlog_third": _backlog(sent, t0 + (t1 - t0) / 3),
            "backlog_close": _backlog(sent, t1),
            "ttft_ms_median_by_third": [float(np.median(x)) if x else None
                                        for x in thirds],
            "completed": len(done), "failed": len(sent) - len(done),
            "metrics": run.end_to_end()}), flush=True)
    run.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
