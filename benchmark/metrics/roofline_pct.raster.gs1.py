"""``raster``'s bound (counts/raster.py) over the device time launched inside
its calls, summed over the traced stage-1 training steps, in percent."""

from benchmark.metrics_common import roofline


def read(run):
    return roofline(run, "raster")
