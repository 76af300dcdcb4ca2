"""The offline step's share of the chip's peak, in %: Σ over an image's
nodes of their operations at their type's peak (`work/resnet.py`) × the
batch ÷ the step time of the untraced part of the window (`clean`: steps,
seconds, closed by a sync)."""

from ..work.resnet import peak_seconds_per_image


def read(run, name):
    steps, secs = run.clean or (0, 0.0)
    if not steps or not secs:
        return None
    return 100.0 * run.batch * peak_seconds_per_image(
        run.cfg, run.size) * steps / secs
