"""``uvtex_fused``'s bound (counts/uvtex_fused.py) over the device time launched
inside its calls, summed over the traced frames, in percent."""

from benchmark.metrics_common import roofline


def read(run):
    return roofline(run, "uvtex_fused")
