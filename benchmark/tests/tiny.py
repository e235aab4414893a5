"""The cells cut to a size the CPU runs in seconds: the same files, with
the Gaussian count, the views, the frames and the cubemap shrunk."""

from __future__ import annotations

import copy

from benchmark import harness

TINY = {"n_gaussians": 400, "width": 64, "height": 48, "views": 4,
        "tex_res": 16}


def tiny_cell(name: str) -> dict:
    cell = copy.deepcopy(harness.cell(name))
    cfg = cell["config"]
    cfg["assumed"]["n_gaussians"] = TINY["n_gaussians"]
    cfg["model_cfg"]["tex_cfg"]["resolution"] = TINY["tex_res"]
    if "views" in cfg["assumed"]:
        cfg["assumed"]["views"].update(n=TINY["views"], width=TINY["width"],
                                       height=TINY["height"])
    tp = cell["work"]["traffic_params"]
    if "width" in tp:
        tp.update(width=TINY["width"], height=TINY["width"], warmup_frames=1,
                  sample_frames=3, trace_frames=2)
    else:
        tp.update(warmup_steps=1, trace_steps=2)
    return cell


def cpu_ctx(cell: dict, seed: int = 7, seconds: float = 0.5):
    import time
    from types import SimpleNamespace

    import torch
    return SimpleNamespace(torch=torch, device="cpu", cell=cell, seed=seed,
                           seconds=seconds, trace=False,
                           t0=time.perf_counter())
