"""The share of an admission's rows that are padding, in %: 100 ×
Σ(rows_launched − rows_real) ÷ Σ rows_launched over the `admission` spans
(rows_launched = slots × the bucket's length, rows_real = the admitted
prompts' tokens) begun in the spans' part of the window, those that build
left out.  Read from the scheduler's span recorder (`sched.spans`); None
without one."""

from . import in_span


def read(run, name):
    rec = getattr(run.sched, "spans", None)
    if rec is None:
        return None
    spans = rec.snapshot()
    built = {s.parent for s in spans if s.name == "admission.build"}
    adm = [s.attrs for s in spans if s.name == "admission"
           and s.id not in built and in_span(run, s.t0 * 1e-9)]
    launched = sum(a["rows_launched"] for a in adm)
    if not launched:
        return None
    return 100.0 * sum(a["rows_launched"] - a["rows_real"]
                       for a in adm) / launched
