"""Device ms a step in kernels that are not an int8 kernel's
(`matmul_int8`, `conv3x3_int8`): the float and layout ops around them,
from the device trace, over the steps traced whole (`Net` calls)."""

INT8 = ("matmul_int8", "conv3x3_int8")


def read(run, name):
    td = run.trace
    if td is None or not td.units:
        return None
    ms = [1e3 * sum(t for k, t in step.items() if k not in INT8)
          for step in td.units]
    return sum(ms) / len(ms)
