"""The per-layer readers of the program's spans: a driver that reduces its
traced window with ``benchmark.spans.reduce`` puts the reduction under
``run["trace"]["spans"]``.  Each reader returns None where the trace has
no reduction, no ``step`` span or not the phase: a program without the
spans reads nothing."""

from __future__ import annotations


def _steps(run: dict):
    red = run["trace"].get("spans")
    return (red, red["steps"]) if red and red["steps"] else (None, 0)


def phase_per_step(run: dict, phase: str, key: str, scale: float = 1.0):
    """A phase's ``key`` (``launches``, ``idle_s`` or ``syncs``) times
    ``scale``, per ``step`` span of the window."""
    red, steps = _steps(run)
    if red is None or phase not in red["phases"]:
        return None
    return red["phases"][phase][key] * scale / steps


def syncs_per_step(run: dict):
    """The window's host syncs per ``step`` span."""
    red, steps = _steps(run)
    return None if red is None else red["syncs"] / steps
