"""`flash_attention`'s share of its roofline: Σ over its launches in the traced
window of the bound (`roofline/flash_attention.py`, published peaks) ÷ Σ of their
device time, the launches made from Python and matched to their shapes."""

from . import kernel_share


def read(run, name):
    return kernel_share(run, "flash_attention", "eager")
