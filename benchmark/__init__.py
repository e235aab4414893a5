"""The benchmark of texgs_torch on one H100: ``python -m benchmark.run``.

BENCHMARK.json at the repository root names its cells, configurations
and metrics; this package finds each one's files by name (harness.py).
"""
