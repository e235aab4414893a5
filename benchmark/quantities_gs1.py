"""What the stage-1 step's kernel functions had to move and do: the
quantities ``counts/{raster,raster_bwd,stage1_step}.py`` read, reckoned
by the reference's own projection, binning and blend of the step's
inputs, never read from the port."""

from __future__ import annotations

import torch

from benchmark.reference import render as R
from benchmark.reference import stage1 as ref1


def of_call(snap: dict, cam, cfg: dict) -> dict:
    """The quantities of one step from a copy of its geometry leaves
    (``xyz``, ``opacity``, ``scaling``, ``rotation``): the Gaussians, the
    tiles, the pairs and the (pixel, pair) entries the blend evaluated,
    which the colours do not change."""
    n = int(snap["xyz"].shape[0])
    with torch.no_grad():
        opacity, scaling, rot = ref1.geometry(snap)
        proj = R.project(snap["xyz"], scaling, rot, opacity, cam)
        table = R.gauss_table(proj, torch.zeros_like(snap["xyz"]))
        pairs = R.build_pairs(proj.means2d, proj.depths, proj.radii,
                              cam.height, cam.width)
        _, _, n_eval = ref1.blend(table, pairs,
                                  R.grid_shape(cam.height, cam.width)[1])
    return {"n": n, "n_f": ref1.N_F,
            "n_tiles": int(pairs.tile_counts.shape[0]),
            "n_pairs": int(pairs.pair_gauss.numel()),
            "n_eval": int(n_eval.sum()),
            "height": cam.height, "width": cam.width,
            "sh_degree": int(cfg["model_cfg"]["sh_degree"])}
