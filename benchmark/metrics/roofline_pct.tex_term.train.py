"""``tex_term``'s bound (counts/tex_term.py) over the device time launched
inside its calls, summed over the traced training steps, in percent."""

from benchmark.metrics_common import roofline


def read(run):
    return roofline(run, "tex_term")
