"""The stage-1 cell cut to a size the CPU runs in seconds: the same files,
with the Gaussian count and the views shrunk (``tiny.py``'s sizes; a
stage-1 configuration has no cubemap)."""

from __future__ import annotations

import copy

from benchmark import harness
from benchmark.tests.tiny import TINY

CELL = "gs1-dtu-train"


def tiny_gs1_cell() -> dict:
    cell = copy.deepcopy(harness.cell(CELL))
    cfg = cell["config"]
    cfg["assumed"]["n_gaussians"] = TINY["n_gaussians"]
    cfg["assumed"]["views"].update(n=TINY["views"], width=TINY["width"],
                                   height=TINY["height"])
    cell["work"]["traffic_params"].update(warmup_steps=1, trace_steps=2)
    return cell
