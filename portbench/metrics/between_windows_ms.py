"""The scheduler's host ms between two decode windows with nothing queued
on the card: the mean, over consecutive `window` spans with no other
dispatch (`admission`, `step`, `chunk`) between them, both begun in the
spans' part of the window and neither building, of (start of the second's
`window.launch` − end of the first's `window.readback`).  Read from the
scheduler's span recorder (`sched.spans`); None without one."""

from . import in_span

DISPATCH = ("window", "admission", "step", "chunk")


def read(run, name):
    rec = getattr(run.sched, "spans", None)
    if rec is None:
        return None
    spans = rec.snapshot()
    kids, built = {}, set()
    for s in spans:
        if s.parent is not None:
            kids.setdefault(s.parent, {})[s.name] = s
            if s.name.endswith(".build"):
                built.add(s.parent)
    top = sorted((s for s in spans if s.parent is None
                  and s.name in DISPATCH), key=lambda s: s.t0)
    gaps = []
    for a, b in zip(top, top[1:]):
        if (a.name == b.name == "window" and not {a.id, b.id} & built
                and in_span(run, a.t0 * 1e-9) and in_span(run, b.t0 * 1e-9)
                and "window.readback" in kids.get(a.id, {})
                and "window.launch" in kids.get(b.id, {})):
            gaps.append(kids[b.id]["window.launch"].t0
                        - kids[a.id]["window.readback"].t1)
    return 1e-6 * sum(gaps) / len(gaps) if gaps else None
