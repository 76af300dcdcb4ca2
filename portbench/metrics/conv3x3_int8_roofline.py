"""`conv3x3_int8`'s share of its roofline: Σ over its launches in the traced
window of the bound (`roofline/conv3x3_int8.py`, published peaks) ÷ Σ of their
device time, the launches made from Python and matched to their shapes."""

from . import kernel_share


def read(run, name):
    return kernel_share(run, "conv3x3_int8", "eager")
