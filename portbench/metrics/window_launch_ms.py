"""The executor's host ms to launch a decode window: the mean duration of
the `window.launch` spans (the feed's copies into the captured graph's
inputs and the replay call returning) of the `window` spans begun in the
spans' part of the window, those that build left out.  Read from the
scheduler's span recorder (`sched.spans`); None without one."""

from . import in_span


def read(run, name):
    rec = getattr(run.sched, "spans", None)
    if rec is None:
        return None
    spans = rec.snapshot()
    wins = {s.id for s in spans if s.name == "window"
            and in_span(run, s.t0 * 1e-9)}
    wins -= {s.parent for s in spans if s.name == "window.build"}
    launch = [s.t1 - s.t0 for s in spans
              if s.name == "window.launch" and s.parent in wins]
    return 1e-6 * sum(launch) / len(launch) if launch else None
