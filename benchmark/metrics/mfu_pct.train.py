"""The traced steps' FLOPs (counts/stage3_step.py, pairs from the
benchmark's binning of each step's inputs) over the traced window and the
H100's float32 peak, in percent."""

from benchmark.metrics_common import mfu


def read(run):
    return mfu(run, "stage3_step")
