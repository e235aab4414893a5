"""Device idle time while the ``backward`` phase is open, in ms per traced
stage-1 step (benchmark/spans.py's reduction)."""

from benchmark.metrics_spans import phase_per_step


def read(run):
    return phase_per_step(run, "backward", "idle_s", 1e3)
