"""The admissions' share of the chip's peak, in %: the operations of the
real prompts admitted in the spans' part of the window (`work/decoder.py`:
each prompt scored once, no bucket padding, no idle slot) ÷ Δ
`phase_seconds["prefill"]` ÷ the peak of the configuration's precision."""

from . import admitted
from ..roofline.peaks import PEAK_OPS
from ..work.decoder import Flops


def read(run, name):
    flops = Flops(run.cfg)
    ops = sum(flops.prompt(len(r.prompt)) for r in admitted(run))
    secs = run.delta.get("prefill_s")
    if not ops or not secs:
        return None
    return 100.0 * ops / secs / PEAK_OPS[run.cfg["precision"]]
