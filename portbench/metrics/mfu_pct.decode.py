"""The decode windows' share of the chip's peak, in %: the operations of
the tokens decoded in the spans' part of the window (each token's linear
layers, head and attention over its real context; `work/decoder.py`) ÷ Δ
`phase_seconds["window"]` ÷ the peak of the configuration's precision."""

from . import in_span
from ..roofline.peaks import PEAK_OPS
from ..work.decoder import Flops


def read(run, name):
    flops = Flops(run.cfg)
    ops = sum(flops.decode_token(len(r.prompt) + j)
              for r in run.sent for j, t in enumerate(r.times)
              if j > 0 and in_span(run, t))
    secs = run.delta.get("window_s")
    if not ops or not secs:
        return None
    return 100.0 * ops / secs / PEAK_OPS[run.cfg["precision"]]
