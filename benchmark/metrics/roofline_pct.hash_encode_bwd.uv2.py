"""``hash_encode_bwd``'s bound (counts/hash_encode_bwd.py) over the device
time launched inside its calls (kernel K5'' and its table gradient's
fill), summed over the traced stage-2 training steps, in percent."""

from benchmark.metrics_common import roofline


def read(run):
    return roofline(run, "hash_encode_bwd")
