"""``hash_encode``'s bound (counts/hash_encode.py) over the device time
launched inside its calls (kernel K5'), summed over the traced stage-2
training steps, in percent."""

from benchmark.metrics_common import roofline


def read(run):
    return roofline(run, "hash_encode")
