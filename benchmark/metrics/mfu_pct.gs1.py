"""The traced stage-1 steps' FLOPs (counts/stage1_step.py, pairs from the
benchmark's binning of each step's inputs) over the traced window and the
H100's float32 peak, in percent."""

from benchmark.metrics_common import mfu


def read(run):
    return mfu(run, "stage1_step")
