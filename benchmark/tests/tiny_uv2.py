"""The stage-2 cell cut to a size the CPU runs in seconds: the same files,
with the Gaussian count, the views and the cloud shrunk (``tiny.py``'s
sizes; the nets, the table and the sphere samples keep their widths)."""

from __future__ import annotations

import copy

from benchmark import harness
from benchmark.tests.tiny import TINY

CELL = "uv2-dtu-train"
PCD_POINTS = 128


def tiny_uv2_cell() -> dict:
    cell = copy.deepcopy(harness.cell(CELL))
    a = cell["config"]["assumed"]
    a["n_gaussians"] = TINY["n_gaussians"]
    a["pcd_points"] = PCD_POINTS
    a["views"].update(n=TINY["views"], width=TINY["width"],
                      height=TINY["height"])
    cell["work"]["traffic_params"].update(warmup_steps=1, trace_steps=2)
    return cell
