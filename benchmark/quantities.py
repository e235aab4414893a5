"""What a kernel function's call had to move and do: the quantities the
counts (``counts/<function>.py``) read, reckoned by the benchmark's own
plain binning and blend of the call's inputs, never read from the port."""

from __future__ import annotations

import torch

from benchmark.reference import render as R
from benchmark.reference.stage3 import uv_net_with_jac


def of_call(snap: dict, cam, cfg, m, sh_degree: int) -> dict:
    """What each kernel function of one step had to move and do: the
    quantities the counts read, reckoned by the reference's binning and
    blend of the step's inputs."""
    mc, keep = cfg["model_cfg"], {}
    res = int(mc["tex_cfg"]["resolution"])
    n = int(snap["xyz"].shape[0])
    dev = snap["xyz"].device
    n_rest = (int(mc["tex_cfg"]["max_sh_degree"]) + 1) ** 2 - 1
    with torch.no_grad():
        rot = snap["rotation"] / (torch.linalg.norm(
            snap["rotation"], dim=-1, keepdim=True) + 1e-12)
        uvs, jac = uv_net_with_jac(snap, snap["xyz"])
        R.render(cam, snap["xyz"], torch.sigmoid(snap["opacity"]),
                 torch.exp(snap["scaling"]), rot, uvs, jac,
                 torch.zeros(6, res, res, 3, device=dev),
                 torch.zeros(n, n_rest, 3, device=dev), sh_degree,
                 torch.zeros(3, device=dev), m, True, keep)
    mlist = keep["mlist"]
    inverse = bool(cfg["loss_cfg"].get("lambda_inverse"))
    return {"n": n, "n_f": int(keep["n_f"]), "m": m,
            "n_tiles": int(mlist.shape[0]),
            "n_pairs": int(keep["pairs"].pair_gauss.numel()),
            "n_eval": int(keep["n_eval"].sum()),
            "live": int((mlist[..., 0] != 0).sum()),
            "texels": R.texels_touched(mlist, res), "tex_res": res,
            "height": cam.height, "width": cam.width,
            "sh_degree": int(mc["tex_cfg"]["max_sh_degree"]),
            "mlp_width": int(mc["uv_net_cfg"]["mlp_cfg"]["n_neurons"]),
            "n_inv": int(mc.get("max_inverse_points", 0)) if inverse else 0}
