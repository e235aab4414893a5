"""What the stage-2 step's kernel functions had to move and do: the
quantities ``counts/{hash_encode,hash_encode_bwd,stage2_step}.py`` read.
The inverse loss's point count of a view comes from the reference's own
frozen render of it (``reference/stage2.py``), never from the port; the
rest from the configuration."""

from __future__ import annotations

import torch

from benchmark.reference import stage2 as ref2


def mlp_layers(d_in: int, d_out: int, mc: dict) -> list:
    """[(in, out)] of an MLP of ``mc``'s hidden layers."""
    dims = [d_in] + [int(mc["n_neurons"])] * int(mc["n_hidden_layers"]) \
        + [d_out]
    return list(zip(dims[:-1], dims[1:]))


def masked_pixels(gauss: dict, cam, bg) -> int:
    """The view's pixels with alpha > 0.5 in the reference's render."""
    with torch.no_grad():
        return int((ref2.frozen_render(gauss, cam, bg)["alpha"] > 0.5).sum())


def of_call(n_points: int, cfg: dict) -> dict:
    """The quantities of one step on a view of ``n_points`` masked pixels:
    the encode's queries (the points and the sphere samples, one batch),
    the nets' layers, the table and the chamfer's two clouds."""
    mc = cfg["model_cfg"]
    uc, ic = mc["uv_net_cfg"], mc["inv_uv_net_cfg"]
    hg = ic["pre_mlp_cfg"]["hash_grid_cfg"]
    n_levels, n_feat = int(hg["n_levels"]), int(hg["n_features_per_level"])
    n_samples = int(ic["n_sample_points"])
    return {"n_points": int(n_points), "n_samples": n_samples,
            "n_enc": int(n_points) + n_samples,
            "n_pcd": int(cfg["assumed"]["pcd_points"]),
            "n_levels": n_levels, "n_features": n_feat,
            "table_size": 2 ** int(hg["max_hashmap"]),
            "uv_layers": (mlp_layers(3, int(uc["emb_dim"]), uc["pre_mlp_cfg"])
                          + mlp_layers(int(uc["emb_dim"]), 3, uc["mlp_cfg"])),
            "inv_layers": (mlp_layers(n_levels * n_feat, int(ic["emb_dim"]),
                                      ic["pre_mlp_cfg"])
                           + mlp_layers(int(ic["emb_dim"]), 3, ic["mlp_cfg"]))}
