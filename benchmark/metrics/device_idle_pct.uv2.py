"""The share of the traced stage-2 training window that no device work
covers."""

from benchmark.metrics_common import idle_pct as read  # noqa: F401
