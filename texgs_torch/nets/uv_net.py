"""UVNet / InvUVNet: the S^2 UV-mapping networks (port of
texgs/nets/uv_net.py).

  UVNet:    pre_mlp(3 -> emb) -> relu(x + geo_emb) -> mlp(emb -> 3)
            -> L2-normalize
  InvUVNet: [hashgrid(uv/2 + 0.5) ->] pre_mlp -> relu(x + geo_emb)
            -> mlp(emb -> 3), optional xyz scale/offset denormalisation

The UVNet is MLP-only: the stage-3 path applies it with its Jacobian
through a hand-rolled forward-mode pass, which texgs supports for the
MLP-only net alone.  The InvUVNet may carry a hash grid (nets/hashgrid.py).
``sample_sphere`` and ``patch_sample_sphere`` draw stage 2's sphere samples
from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from texgs_torch.config import Cfg
from texgs_torch.nets.hashgrid import HashGrid
from texgs_torch.nets.mlp import MLP


class _EmbeddedMLPs(nn.Module):
    """pre_mlp (pre_in -> emb), relu(. + geo_emb), mlp (emb -> 3), and the
    optional xyz scale/offset of ``cfg``: the part UVNet and InvUVNet
    share."""

    def __init__(self, cfg: Cfg, pre_in: int,
                 generator: Optional[torch.Generator], device):
        super().__init__()
        emb = int(cfg.emb_dim)
        self.pre_mlp = MLP(pre_in, emb, int(cfg.pre_mlp_cfg.n_hidden_layers),
                           int(cfg.pre_mlp_cfg.n_neurons), generator, device)
        self.mlp = MLP(emb, 3, int(cfg.mlp_cfg.n_hidden_layers),
                       int(cfg.mlp_cfg.n_neurons), generator, device)
        self.xyz_offset = self.xyz_scale = None
        if cfg.xyz_offset and cfg.xyz_scale:
            self.xyz_offset = torch.tensor(cfg.xyz_offset, dtype=torch.float32,
                                           device=device)
            self.xyz_scale = torch.tensor(cfg.xyz_scale, dtype=torch.float32,
                                          device=device)

    def _mlps(self, x: torch.Tensor, geo_emb: torch.Tensor) -> torch.Tensor:
        return self.mlp(torch.relu(self.pre_mlp(x) + geo_emb[None, :]))


class UVNet(_EmbeddedMLPs):
    def __init__(self, cfg: Cfg, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        if cfg.pre_mlp_cfg.hash_grid_cfg:
            raise ValueError("texgs_torch's UVNet is MLP-only (no "
                             "pre_mlp_cfg.hash_grid_cfg)")
        super().__init__(cfg, 3, generator, device)

    def _normalize_input(self, xyz):
        if self.xyz_offset is None:
            return xyz
        return (xyz - self.xyz_offset) / self.xyz_scale

    def forward(self, xyz: torch.Tensor, geo_emb: torch.Tensor) -> torch.Tensor:
        """xyz: (N, 3) world -> (N, 3) unit-sphere UV."""
        out = self._mlps(self._normalize_input(xyz), geo_emb)
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

    def jax_params(self) -> dict:
        """These weights in texgs's layout (``load_jax_params``'s input)."""
        return {"pre_mlp": self.pre_mlp.jax_params(),
                "mlp": self.mlp.jax_params()}


class InvUVNet(_EmbeddedMLPs):
    """uv (N, 3) on the unit sphere -> (N, 3) world xyz (texgs
    ``init_inv_uv_net`` / ``apply_inv_uv_net``)."""

    def __init__(self, cfg: Cfg, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        hg = cfg.pre_mlp_cfg.hash_grid_cfg
        # the hash table takes its values from the generator before the MLPs
        hashgrid = (HashGrid(int(hg.n_levels), int(hg.n_features_per_level),
                             int(hg.max_hashmap), generator, device)
                    if hg else None)
        super().__init__(cfg, hashgrid.out_dim if hashgrid else 3, generator,
                         device)
        self.hashgrid = hashgrid

    def forward(self, uv: torch.Tensor, geo_emb: torch.Tensor) -> torch.Tensor:
        h = self.hashgrid(uv / 2.0 + 0.5) if self.hashgrid is not None else uv
        out = self._mlps(h, geo_emb)
        if self.xyz_scale is not None:
            out = out * self.xyz_scale + self.xyz_offset
        return out

    def load_jax_params(self, params: dict) -> None:
        """Copy texgs inverse-net params {["hashgrid": ...,] "pre_mlp": ...,
        "mlp": ...}."""
        if (self.hashgrid is not None) != ("hashgrid" in params):
            raise ValueError("inv_uv_net: the hash grid of the config and of "
                             "the params disagree")
        if self.hashgrid is not None:
            self.hashgrid.load_jax_params(params["hashgrid"])
        self.pre_mlp.load_jax_params(params["pre_mlp"])
        self.mlp.load_jax_params(params["mlp"])

    def jax_params(self) -> dict:
        out = {"pre_mlp": self.pre_mlp.jax_params(),
               "mlp": self.mlp.jax_params()}
        if self.hashgrid is not None:
            out["hashgrid"] = self.hashgrid.jax_params()
        return out


def _mlp_with_tangents(mlp: MLP, h: torch.Tensor, tang: torch.Tensor):
    n = len(mlp.layers)
    for i, lin in enumerate(mlp.layers):
        h = lin(h)
        tang = tang @ lin.weight.detach().T
        if i < n - 1:
            tang = tang * (h > 0).to(h.dtype).detach()[None]
            h = torch.relu(h)
    return h, tang


def sample_sphere(generator: torch.Generator, n: int) -> torch.Tensor:
    """(n, 3) uniform unit-sphere samples, on the generator's device."""
    p = torch.randn((n, 3), generator=generator, device=generator.device)
    return p / (torch.linalg.norm(p, dim=-1, keepdim=True) + 1e-12)


def patch_sample_sphere(generator: torch.Generator, n: int,
                        patch_scale: int) -> torch.Tensor:
    """Directional-cap samples: of n * patch_scale sphere samples, the n
    most aligned with a random direction."""
    direction = torch.randn(3, generator=generator, device=generator.device)
    direction = direction / (torch.linalg.norm(direction) + 1e-12)
    points = sample_sphere(generator, n * patch_scale)
    return points[torch.topk(points @ direction, n).indices]
