"""`matmul_w4`'s share of its roofline: Σ bound ÷ Σ device time over its
launches in the traced window.  `.decode`: the launches of the captured
decode windows' replays (each replay counted whole, its launches' shapes
recorded when the window was captured); any other tag: the launches made
from Python (the bucket admissions), matched to their shapes."""

from . import kernel_share, tag


def read(run, name):
    return kernel_share(run, "matmul_w4",
                        "graph" if tag(name) == "decode" else "eager")
