"""Host syncs (stream, device and event synchronisations) in the traced
window, per stage-2 step (benchmark/spans.py's reduction)."""

from benchmark.metrics_spans import syncs_per_step as read  # noqa: F401
