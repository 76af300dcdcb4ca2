"""The p90 of a request's queue wait in ms: from its submission to the
start of the admission dispatch that carried it, over the requests whose
dispatch started in the spans' part of the window (the scheduler's
`request` records, `sched.spans`); None without a recorder."""

import numpy as np

from . import in_span


def read(run, name):
    rec = getattr(run.sched, "spans", None)
    if rec is None:
        return None
    waits = [1e-6 * (s.attrs["dispatch"] - s.t0) for s in rec.snapshot()
             if s.name == "request" and s.attrs.get("dispatch") is not None
             and in_span(run, s.attrs["dispatch"] * 1e-9)]
    return float(np.percentile(waits, 90)) if waits else None
