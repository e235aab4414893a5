"""Stage-3 model: textured Gaussians, inference half (port of
texgs/train/texture_gaussian3d.py).

Stage-1 Gaussians + the stage-2 UV net + a (6, R, R, 3) cubemap texture in
SH0 space + optional per-Gaussian residual SH (degrees >= 1; the DC term
comes from the texture).  This module renders (``visual_step``) and edits
the texture (``change_texture``); the optimiser state, the losses and
``compute_loss`` belong to training and are not ported yet.

texgs keeps the Gaussians at a fixed capacity with dead slots masked
through the opacity; the port holds exactly the ``n_alive`` live ones, so
``load_state_dict`` slices the capacity padding off.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from texgs_torch.config import Cfg
from texgs_torch.core.camera import Camera
from texgs_torch.kernels.cubemap import (cross_to_faces, cubemap_to_latlong,
                                         faces_to_cross)
from texgs_torch.nets.uv_net import UVNet
from texgs_torch.render.uv_tex_render import uv_tex_render
from texgs_torch.utils.sh import C0


def rgb2sh0(rgb):
    return (rgb - 0.5) / C0


def sh02rgb(sh0):
    return torch.clamp(C0 * sh0 + 0.5, 0.0, 1.0)


class TextureGaussian3D:
    """Stage-3 model with the render and retexture API of texgs's."""

    def __init__(self, cfg: Cfg, device="cuda",
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.active_sh_degree = 0
        self.max_sh_degree = int(cfg.tex_cfg.max_sh_degree)
        self.tex_res = int(cfg.tex_cfg.resolution)
        # the UV Jacobian is a hand-rolled forward-mode pass through the MLP
        # chain, so stage 3 takes an MLP-only UV net
        if cfg.uv_net_cfg.pre_mlp_cfg.get_or("hash_grid_cfg", None):
            raise ValueError(
                "TextureGaussian3D requires an MLP-only uv_net_cfg (no "
                "pre_mlp_cfg.hash_grid_cfg): the stage-3 UV Jacobian is a "
                "hand-rolled forward-mode pass through the MLP chain.")
        if generator is None:
            generator = torch.Generator(device="cpu").manual_seed(
                int(cfg.get_or("seed", 2)))
        self.uv_net = UVNet(cfg.uv_net_cfg, generator, self.device)
        self.geo_emb = torch.randn(int(cfg.geo_emb_dim),
                                   generator=generator).to(self.device)
        self.gauss: Optional[dict] = None  # xyz, opacity, scaling, rotation, shs
        self.texture = torch.zeros((6, self.tex_res, self.tex_res, 3),
                                   device=self.device)
        self.bg = torch.zeros(3, device=self.device)

    def bind_train_cfg(self, train_cfg_unused: Optional[Cfg], bg) -> None:
        """The caller hands over train_cfg and the dataset's background
        once, as texgs's tools do; ``visual_step`` renders on ``bg``.  Only
        training reads train_cfg, and the port does not train yet."""
        self.bg = torch.as_tensor(bg, dtype=torch.float32, device=self.device)

    # ----------------------------------------------------------- helpers
    def _activated(self):
        gp = self.gauss
        rot = gp["rotation"] / (torch.linalg.norm(
            gp["rotation"], dim=-1, keepdim=True) + 1e-12)
        return dict(xyz=gp["xyz"], scaling=torch.exp(gp["scaling"]),
                    rotation=rot, opacity=torch.sigmoid(gp["opacity"]),
                    shs=gp.get("shs"))

    def _uvs_and_jac(self, xyz):
        uvs, jac = self.uv_net.forward_with_jac(xyz, self.geo_emb)
        return uvs, jac.reshape(-1, 9)

    # ---------------------------------------------------------- eval path
    @torch.no_grad()
    def render(self, camera: Camera) -> dict:
        """uv_tex_render of the current model, no-SH image included."""
        act = self._activated()
        uvs, jac = self._uvs_and_jac(act["xyz"])
        return uv_tex_render(
            camera, xyz=act["xyz"], opacity=act["opacity"],
            scaling=act["scaling"], rotation=act["rotation"], uvs=uvs,
            grad_uvs=jac, texture=self.texture, shs=act["shs"],
            active_sh_degree=self.active_sh_degree, bg_color=self.bg,
            m=int(self.cfg.get_or("uvtex_m", 32)),
            filter_mode=self.cfg.tex_cfg.get_or("filter_mode", "bilinear"),
            with_no_sh=True,
            m_tail=bool(self.cfg.get_or("uvtex_m_tail", False)))

    @torch.no_grad()
    def visual_step(self, cur_iter: int, total_iter: int, viewpoint: Camera,
                    render_unused=None) -> dict:
        out = self.render(viewpoint)
        return dict(image=out["render"], image_no_sh=out["render_no_sh"],
                    depth=out["depth"], norm=out["norm"], alpha=out["alpha"],
                    envmap=self.sphere_map((512, 1024)).permute(2, 0, 1),
                    cubemap=self.cube_map().permute(2, 0, 1))

    @property
    def n_points(self) -> int:
        return 0 if self.gauss is None else self.gauss["xyz"].shape[0]

    # ----------------------------------------------------- texture tools
    @torch.no_grad()
    def sphere_map(self, resolution=(512, 1024)) -> torch.Tensor:
        return cubemap_to_latlong(sh02rgb(self.texture), resolution)

    @torch.no_grad()
    def cube_map(self) -> torch.Tensor:
        """Cross-layout (3R, 4R, 3) rgb image of the texture."""
        return faces_to_cross(sh02rgb(self.texture))

    @torch.no_grad()
    def change_texture(self, cubemap_image, mode: int = 0):
        """Texture swap with blend modes.

        cubemap_image: (3R, 4R, 3) rgb cross layout in [0, 1] (numpy array
        or tensor).
        mode -1: replace; 0: luminance-modulated; 1: multiply; 2: divide;
        3: masked additive blend.
        """
        img = torch.as_tensor(cubemap_image, dtype=torch.float32,
                              device=self.device)
        new_tex = cross_to_faces(img)
        ori_tex = sh02rgb(self.texture)
        if ori_tex.shape != new_tex.shape:
            raise ValueError(f"texture resolution mismatch: "
                             f"{tuple(ori_tex.shape)} vs {tuple(new_tex.shape)}")
        if mode == 0:
            ori = torch.clamp(ori_tex * 3, 0, 1)
            new_tex = new_tex * ori.mean(dim=-1, keepdim=True)
        elif mode == 1:
            new_tex = new_tex * ori_tex
        elif mode == 2:
            new_tex = ori_tex / torch.clamp(new_tex, min=1e-6)
        elif mode == 3:
            mask = (new_tex.sum(-1) > 0.01)[..., None]
            blended = 2 * ori_tex.mean(-1, keepdim=True) * new_tex
            new_tex = new_tex + torch.where(mask, blended, ori_tex)
        elif mode != -1:
            raise ValueError(f"unknown texture blend mode {mode}")
        self.texture = rgb2sh0(new_tex).contiguous()

    # --------------------------------------------------------------- io
    def load_state_dict(self, sd: dict) -> None:
        """Load ``params`` and ``net_state`` of a texgs-schema state dict
        (``texgs.io.checkpoint.load`` or ``TextureGaussian3D.state_dict()``
        of texgs): the capacity padding is sliced to ``n_alive``, MLP
        weights are transposed into ``nn.Linear`` layout, ``geo_emb`` and
        the (6, R, R, 3) texture are kept as they are."""
        p = sd["params"]
        n = int(np.asarray(p["n_alive"]))

        def live(a):
            return torch.as_tensor(np.array(a, np.float32)[:n],
                                   device=self.device).contiguous()

        self.gauss = {k: live(p[k]) for k in
                      ("xyz", "opacity", "scaling", "rotation")}
        if "shs" in p and p["shs"] is not None:
            self.gauss["shs"] = live(p["shs"])
        texture = torch.as_tensor(np.array(p["texture"], np.float32),
                                  device=self.device)
        if texture.shape != self.texture.shape:
            raise ValueError(f"texture {tuple(texture.shape)} does not match "
                             f"tex_cfg.resolution {self.tex_res}")
        self.texture = texture.contiguous()
        net = sd["net_state"]
        self.uv_net.load_jax_params(net["uv_net"])
        self.geo_emb = torch.as_tensor(np.array(net["geo_emb"], np.float32),
                                       device=self.device)
        hp = sd.get("hyperparams") or {}
        if "active_sh_degree" in hp:
            self.active_sh_degree = int(hp["active_sh_degree"])


def cfg_from_state(sd: dict) -> Cfg:
    """A model config that fits a texgs-schema state dict: texture
    resolution from the texture, SH degree from ``shs``, UV-net widths
    from its weights."""
    p, net = sd["params"], sd["net_state"]["uv_net"]

    def mlp_cfg(params):
        ws = params["w"]
        return {"n_hidden_layers": len(ws) - 1,
                "n_neurons": int(np.asarray(ws[0]).shape[1])}

    n_sh = 1 + (np.asarray(p["shs"]).shape[1] if p.get("shs") is not None
                else 0)
    return Cfg({
        "uv_net_cfg": {"emb_dim": int(np.asarray(net["mlp"]["w"][0]).shape[0]),
                       "pre_mlp_cfg": mlp_cfg(net["pre_mlp"]),
                       "mlp_cfg": mlp_cfg(net["mlp"])},
        "tex_cfg": {"resolution": int(np.asarray(p["texture"]).shape[1]),
                    "max_sh_degree": int(round(n_sh ** 0.5)) - 1},
        "geo_emb_dim": int(np.asarray(sd["net_state"]["geo_emb"]).shape[0]),
    })


def from_jax_state(sd: dict, cfg: Optional[Cfg] = None,
                   device="cuda") -> TextureGaussian3D:
    """The port's model from the numpy state dict that
    ``texgs.io.checkpoint.load`` returns or ``TextureGaussian3D.state_dict()``
    builds in texgs.  ``cfg`` is the stage's ``model_cfg``; without one,
    the widths come from the state (``cfg_from_state``)."""
    model = TextureGaussian3D(cfg if cfg is not None else cfg_from_state(sd),
                              device=device)
    model.load_state_dict(sd)
    return model
