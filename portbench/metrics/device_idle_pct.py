"""The share of the traced window in which no operation ran on the
device, in %."""


def read(run, name):
    td = run.trace
    if td is None or td.window_s <= 0:
        return None
    return 100.0 * (1.0 - td.busy_s / td.window_s)
