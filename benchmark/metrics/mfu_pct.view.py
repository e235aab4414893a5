"""The traced frames' FLOPs (counts/view_frame.py, pairs from the
benchmark's binning of each frame's inputs) over the traced window and
the H100's float32 peak, in percent."""

from benchmark.metrics_common import mfu


def read(run):
    return mfu(run, "view_frame")
