"""Device kernels launched while the ``adam`` phase is open, per traced
stage-1 step (benchmark/spans.py's reduction)."""

from benchmark.metrics_spans import phase_per_step


def read(run):
    return phase_per_step(run, "adam", "launches")
