"""Device kernels launched in the traced window, per stage-2 training
step."""

from benchmark.metrics_common import launches as read  # noqa: F401
