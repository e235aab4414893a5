"""Device kernels launched in the traced window, per frame."""

from benchmark.metrics_common import launches as read  # noqa: F401
