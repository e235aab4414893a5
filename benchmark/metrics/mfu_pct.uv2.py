"""The traced stage-2 steps' FLOPs (counts/stage2_step.py, each step's
inverse points counted from the reference's render of its view) over the
traced window and the H100's float32 peak, in percent."""

from benchmark.metrics_common import mfu


def read(run):
    return mfu(run, "stage2_step")
