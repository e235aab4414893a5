"""UVNet: the S^2 UV-mapping network (port of texgs/nets/uv_net.py:32-131).

  pre_mlp(3 -> emb) -> relu(x + geo_emb) -> mlp(emb -> 3) -> L2-normalize

MLP-only: the stage-3 path applies this net with its Jacobian through a
hand-rolled forward-mode pass, which texgs supports for the MLP-only net
alone.  The hash-grid UV net and the inverse UV net are not applied on
the render path.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from texgs_torch.config import Cfg
from texgs_torch.nets.mlp import MLP


class UVNet(nn.Module):
    def __init__(self, cfg: Cfg, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if cfg.pre_mlp_cfg.hash_grid_cfg:
            raise ValueError("texgs_torch's UVNet is MLP-only (no "
                             "pre_mlp_cfg.hash_grid_cfg)")
        emb = int(cfg.emb_dim)
        self.pre_mlp = MLP(3, emb, int(cfg.pre_mlp_cfg.n_hidden_layers),
                           int(cfg.pre_mlp_cfg.n_neurons), generator, device)
        self.mlp = MLP(emb, 3, int(cfg.mlp_cfg.n_hidden_layers),
                       int(cfg.mlp_cfg.n_neurons), generator, device)
        self.xyz_offset = self.xyz_scale = None
        if cfg.xyz_offset and cfg.xyz_scale:
            self.xyz_offset = torch.tensor(cfg.xyz_offset, dtype=torch.float32,
                                           device=device)
            self.xyz_scale = torch.tensor(cfg.xyz_scale, dtype=torch.float32,
                                          device=device)

    def _normalize_input(self, xyz):
        if self.xyz_offset is None:
            return xyz
        return (xyz - self.xyz_offset) / self.xyz_scale

    def forward(self, xyz: torch.Tensor, geo_emb: torch.Tensor) -> torch.Tensor:
        """xyz: (N, 3) world -> (N, 3) unit-sphere UV."""
        h = self.pre_mlp(self._normalize_input(xyz))
        out = self.mlp(torch.relu(h + geo_emb[None, :]))
        return out / (torch.linalg.norm(out, dim=-1, keepdim=True) + 1e-12)

    def forward_with_jac(self, xyz: torch.Tensor, geo_emb: torch.Tensor):
        """One pass -> (uvs (N, 3), duv/dxyz (N, 3, 3)).

        Forward mode through the MLP chain with 3 explicit tangent columns
        (texgs apply_uv_net_with_jac).  ``uvs`` stays differentiable; the
        Jacobian sees detached weights and masks and is returned detached.
        The ReLU tangent mask is ``h > 0``."""
        n = xyz.shape[0]
        x = self._normalize_input(xyz)
        tang = torch.eye(3, device=xyz.device)[:, None, :].expand(3, n, 3)
        if self.xyz_scale is not None:
            tang = tang / self.xyz_scale

        h, tang = _mlp_with_tangents(self.pre_mlp, x, tang)
        pre = h + geo_emb[None, :]
        h = torch.relu(pre)
        tang = tang * (pre > 0).to(h.dtype).detach()[None]
        o, t_o = _mlp_with_tangents(self.mlp, h, tang)

        norm = torch.linalg.norm(o, dim=-1, keepdim=True)
        uvs = o / (norm + 1e-12)
        o_sg, n_sg = o.detach(), norm.detach()
        d_sg = n_sg + 1e-12
        # d(o / (|o| + eps)) t = t/denom - o (o.t) / (|o| denom^2)
        ot = (o_sg[None] * t_o).sum(-1, keepdim=True)
        t_uv = (t_o / d_sg[None] - o_sg[None] * ot
                / (torch.clamp(n_sg, min=1e-12) * d_sg * d_sg)[None])
        return uvs, t_uv.permute(1, 2, 0).detach()       # (N, out, in)

    def load_jax_params(self, params: dict) -> None:
        """Copy texgs UV-net params {"pre_mlp": ..., "mlp": ...}."""
        self.pre_mlp.load_jax_params(params["pre_mlp"])
        self.mlp.load_jax_params(params["mlp"])


def _mlp_with_tangents(mlp: MLP, h: torch.Tensor, tang: torch.Tensor):
    n = len(mlp.layers)
    for i, lin in enumerate(mlp.layers):
        h = lin(h)
        tang = tang @ lin.weight.detach().T
        if i < n - 1:
            tang = tang * (h > 0).to(h.dtype).detach()[None]
            h = torch.relu(h)
    return h, tang
