"""The arithmetic the per-layer readers share.  A reader gets ``run``: the
reduced trace (``trace``), the steps or frames traced (``steps``), the
kernel functions called in order (``calls``) and each step's counted
quantities (``per_step``).  It returns None where it finds nothing to
read."""

from __future__ import annotations

import sys

from benchmark import harness, peaks


def _count(name):
    return harness.load_module("counts", name).count


def mfu(run: dict, counts: str):
    count = _count(counts)
    flops = sum(count(c)[1] for c in run["per_step"])
    return 100.0 * flops / run["trace"]["window_s"] / peaks.F32_FLOPS


def idle_pct(run: dict):
    t = run["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def launches(run: dict):
    return run["trace"]["kernels"] / run["steps"]


def roofline(run: dict, fn: str):
    """Sum over the traced calls of ``fn`` of its bound, over the device
    time launched inside those calls.  One call a step is what lets each
    call take its step's counts; otherwise nothing is read."""
    n_calls = run["calls"].count(fn)
    device_s = run["trace"]["fn_device_s"].get(fn, 0.0)
    if n_calls == 0 or device_s <= 0.0:
        return None
    if n_calls != len(run["per_step"]):
        sys.stderr.write(f"roofline {fn}: {n_calls} calls in "
                         f"{len(run['per_step'])} steps; not read\n")
        return None
    count = _count(fn)
    return 100.0 * sum(peaks.bound_s(*count(c)) for c in run["per_step"]) \
        / device_s
