"""The scheduler's admission ms per thousand real prompt tokens:
Δ `phase_seconds["prefill"]` over the window ÷ the prompt tokens of the
requests admitted in it."""

from . import admitted


def read(run, name):
    toks = sum(len(r.prompt) for r in admitted(run))
    secs = run.delta.get("prefill_s")
    if not toks or not secs:
        return None
    return 1e3 * secs / (toks / 1e3)
