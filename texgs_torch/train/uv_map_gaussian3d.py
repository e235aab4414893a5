"""Stage 2: UV-mapping networks over frozen stage-1 Gaussians (port of
texgs/train/uv_map_gaussian3d.py:58-325).

The Gaussians come frozen from the stage-1 checkpoint ``cfg.init_from``;
the trainables are the UVNet, the InvUVNet and the geometry embedding.
Per iteration, four gated losses (texgs :154-211):
  Linv     -- cycle |x - inv(uv(x))|^2 on depth-unprojected surface points
              (alpha > 0.5): at ``max_inverse_points`` 0 (the published
              loss) exactly the masked pixels, at a positive count a
              random top-k subset of them;
  Lchamfer -- bidirectional chamfer of inverse-mapped sphere samples
              against the pseudo ground-truth cloud ``cfg.pcd_load_from``;
  Lpatch   -- one-directional chamfer of a directional cap's samples;
  Linv2    -- sphere cycle |uv(inv(s)) - s|^2.
The Gaussians are frozen, so each camera's depth and alpha are rendered
once (kernel 1; the dense oracle with ``model_cfg.backend: reference``)
and cached by (uid, image_name); at ``max_inverse_points`` 0 the masked
world points are a constant of the view too, compacted on its first use
and cached beside them, so a step runs no ``depth2world``.  The step
takes its random draws as arguments (``draws``): ``compute_loss`` draws
them from the model's generator where texgs derives them from
``jax.random`` keys, so a test can hand the port texgs's draws.  Every
inverse-net input of a step goes through the net in one batch, so its
hash grid gathers (kernel K5) once a step.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from texgs_torch.config import Cfg, in_range
from texgs_torch.core.camera import Camera
from texgs_torch.kernels.chamfer import chamfer_distance
from texgs_torch.nets.uv_net import (InvUVNet, UVNet, patch_sample_sphere,
                                     sample_sphere)
from texgs_torch.train import optim
from texgs_torch.utils.schedules import warmup_multistep
from texgs_torch.utils.spans import span, spanned

LAMBDAS = ("inverse", "chamfer", "patch_chamfer", "inverse2")


def depth2world(depth: torch.Tensor, full_proj, zfar: float,
                znear: float) -> torch.Tensor:
    """(H, W) view-z depth -> (H, W, 3) world points:
    clip = [ndc_x d, ndc_y d, zclip(d), d], world = clip @ inv(full_proj)
    (row-vector convention)."""
    h, w = depth.shape
    dev, dt = depth.device, depth.dtype
    ndc_x = (torch.arange(w, dtype=dt, device=dev) * 2 + 1) / w - 1.0
    ndc_y = (torch.arange(h, dtype=dt, device=dev) * 2 + 1) / h - 1.0
    ndc_y, ndc_x = torch.meshgrid(ndc_y, ndc_x, indexing="ij")
    zclip = zfar * depth / (zfar - znear) - zfar * znear / (zfar - znear)
    clip = torch.stack([ndc_x * depth, ndc_y * depth, zclip, depth],
                       dim=-1).reshape(-1, 4)
    fp = torch.as_tensor(full_proj, dtype=dt, device=dev)
    world = clip @ torch.linalg.inv(fp)
    return world[:, :3].reshape(h, w, 3)


def net_leaves(uv_net: UVNet, inv_uv_net: Optional[InvUVNet],
               geo_emb: torch.Tensor) -> dict:
    """The UV nets' and the embedding's trainable leaves, named by their
    path in texgs's parameter trees ("uv_net.mlp.w.0"), so an Adam over
    them converts to and from texgs's state."""
    nets = {"uv_net": uv_net}
    if inv_uv_net is not None:
        nets["inv_uv_net"] = inv_uv_net
    out = {}
    for name, net in nets.items():
        if getattr(net, "hashgrid", None) is not None:
            out[f"{name}.hashgrid.table"] = net.hashgrid.table
        for part in ("pre_mlp", "mlp"):
            for i, lin in enumerate(getattr(net, part).layers):
                out[f"{name}.{part}.w.{i}"] = lin.weight
                out[f"{name}.{part}.b.{i}"] = lin.bias
    out["geo_emb"] = geo_emb
    return out


def inverse_world_points(depth, alpha, camera: Camera,
                         score: Optional[torch.Tensor], n_points: int):
    """The inverse loss's surface points and mask: depth unprojected to
    world space, mask alpha > 0.5; with ``n_points`` below the pixel count,
    the n_points pixels of the highest ``score`` among the masked ones (a
    uniform draw per pixel, as texgs's top_k of jax.random.uniform)."""
    world = depth2world(depth[0].detach(), camera.full_proj, camera.zfar,
                        camera.znear).reshape(-1, 3)
    wmask = (alpha.detach().reshape(-1) > 0.5).to(torch.float32)
    if n_points and n_points < world.shape[0]:
        sel = torch.topk(torch.where(wmask > 0, score, -1.0), n_points).indices
        world, wmask = world[sel], wmask[sel]
    return world, wmask


def masked_cycle_loss(world, wmask, inv):
    """texgs's sum(err * mask) / (sum(mask) + 1e-6); with ``wmask`` None
    every row is a masked point and the count is the row count."""
    err = ((world - inv) ** 2).sum(-1)
    if wmask is None:
        return err.sum() / (err.shape[0] + 1e-6)
    return (err * wmask).sum() / (wmask.sum() + 1e-6)


class UVMapGaussian3D:
    """Stage-2 model with texgs's driver-facing API."""

    def __init__(self, cfg: Cfg, device="cuda",
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        seed = int(cfg.get_or("seed", 1))
        if generator is None:
            generator = torch.Generator(device="cpu").manual_seed(seed)
        self.uv_net = UVNet(cfg.uv_net_cfg, generator, self.device)
        self.inv_uv_net = InvUVNet(cfg.inv_uv_net_cfg, generator, self.device)
        self.geo_emb = torch.randn(int(cfg.geo_emb_dim),
                                   generator=generator).to(self.device)
        # the per-step draws: inverse-loss pixels and sphere samples
        self.rng = torch.Generator(device=self.device).manual_seed(seed)
        self.adam: Optional[optim.Adam] = None
        self.optim_cfg: Optional[Cfg] = None
        self.train_cfg: Optional[Cfg] = None
        self.gauss: Optional[dict] = None   # frozen stage-1 Gaussians
        self.pcd: Optional[torch.Tensor] = None  # (M, 3) pseudo ground truth
        self.bg = torch.zeros(3, device=self.device)
        self._depth_alpha_cache: dict = {}
        self._points_cache: dict = {}      # masked world points, by view
        self._step_count = 0

    def bind_train_cfg(self, train_cfg: Optional[Cfg], bg) -> None:
        self.train_cfg = train_cfg
        self.bg = torch.as_tensor(bg, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------- setup
    def initialize(self, pcd_unused=None, spatial_lr_scale_unused=None) -> None:
        """The frozen Gaussians of the stage-1 checkpoint ``cfg.init_from``
        (capacity padding sliced off) and the cloud ``cfg.pcd_load_from``."""
        from texgs_torch.io import checkpoint as ckpt

        p = ckpt.load(self.cfg.init_from)[0]["params"]
        n = int(np.asarray(p["n_alive"]))
        self.gauss = {k: torch.as_tensor(np.array(p[k], np.float32)[:n],
                                         device=self.device)
                      for k in ("xyz", "scaling", "rotation", "opacity")}
        self._depth_alpha_cache, self._points_cache = {}, {}
        if self.cfg.pcd_load_from:
            self.pcd = torch.as_tensor(np.load(self.cfg.pcd_load_from),
                                       dtype=torch.float32, device=self.device)

    def setup_optim(self, optim_cfg: Cfg) -> None:
        oc = self.optim_cfg = optim_cfg
        leaves = self._leaves()
        self.adam = optim.Adam(leaves, {k for k in leaves if ".w." in k})
        self.uv_lr_fn = warmup_multistep(oc.uv_net_lr, oc.uv_net_milestones,
                                         oc.uv_net_gamma)
        self.inv_uv_lr_fn = warmup_multistep(oc.inv_uv_net_lr,
                                             oc.uv_net_milestones,
                                             oc.uv_net_gamma)

    def _leaves(self) -> dict:
        return net_leaves(self.uv_net, self.inv_uv_net, self.geo_emb)

    def _lrs(self, leaves) -> dict:
        uv_lr = self.uv_lr_fn(self._step_count)
        inv_lr = self.inv_uv_lr_fn(self._step_count)
        return {k: inv_lr if k.startswith("inv_uv_net.") else uv_lr
                for k in leaves}

    # -------------------------------------------------- frozen renders
    @torch.no_grad()
    def depth_alpha(self, camera: Camera):
        """(depth, alpha, norm, image) of the frozen Gaussians from
        ``camera``, rendered once per (uid, image_name)."""
        from texgs_torch.render.render import render

        key = (camera.uid, camera.image_name)
        if key not in self._depth_alpha_cache:
            g = self.gauss
            with span("render"):
                rot = g["rotation"] / (torch.linalg.norm(
                    g["rotation"], dim=-1, keepdim=True) + 1e-12)
                out = render(camera, xyz=g["xyz"],
                             opacity=torch.sigmoid(g["opacity"]),
                             scaling=torch.exp(g["scaling"]), rotation=rot,
                             override_color=torch.zeros_like(g["xyz"]),
                             bg_color=self.bg,
                             backend=self.cfg.get_or("backend", "auto"))
            self._depth_alpha_cache[key] = (out["depth"], out["alpha"],
                                            out["norm"], out["render"])
        return self._depth_alpha_cache[key]

    @torch.no_grad()
    def inverse_points(self, camera: Camera) -> torch.Tensor:
        """The published inverse loss's surface points: the cached depth
        unprojected to world space at exactly the pixels with alpha > 0.5,
        (M, 3) in pixel order, compacted on the view's first use and cached
        by (uid, image_name)."""
        key = (camera.uid, camera.image_name)
        if key not in self._points_cache:
            depth, alpha, _, _ = self.depth_alpha(camera)
            world = depth2world(depth[0], camera.full_proj, camera.zfar,
                                camera.znear).reshape(-1, 3)
            self._points_cache[key] = world[alpha.reshape(-1) > 0.5]
        return self._points_cache[key]

    # ---------------------------------------------------------- training
    def _flags(self, cur_iter: int, lc: Cfg) -> tuple:
        return (
            bool(lc.lambda_inverse) and in_range(cur_iter, lc.inverse_range),
            bool(lc.lambda_chamfer) and in_range(cur_iter, lc.chamfer_range)
            and self.pcd is not None,
            bool(lc.lambda_patch_chamfer)
            and in_range(cur_iter, lc.patch_chamfer_range)
            and self.pcd is not None,
            bool(lc.lambda_inverse2) and in_range(cur_iter, lc.inverse_range2),
        )

    def draws(self, n_pixels: int, flags: tuple) -> dict:
        """The step's random draws from the model's generator: a uniform
        score per pixel for the inverse loss's top-k, the sphere samples
        and the directional-cap samples, each where its loss is on."""
        use_inv, use_chamfer, use_patch, use_inv2 = flags
        n_sample = int(self.cfg.inv_uv_net_cfg.n_sample_points)
        n_points = int(self.cfg.get_or("max_inverse_points", 0))
        d = {}
        if use_inv and n_points and n_points < n_pixels:
            d["score"] = torch.rand(n_pixels, generator=self.rng,
                                    device=self.device)
        if use_chamfer or use_inv2:
            d["sample_uvs"] = sample_sphere(self.rng, n_sample)
        if use_patch:
            d["patch_uvs"] = patch_sample_sphere(
                self.rng, n_sample, int(self.cfg.inv_uv_net_cfg.patch_scale))
        return d

    def loss_terms(self, depth, alpha, camera: Camera, draws: dict,
                   flags: tuple, lambdas: dict):
        """The gated stage-2 losses (texgs ``_train_step``'s ``loss_fn``)
        for the given draws.  Returns (loss, stats).  At
        ``max_inverse_points`` 0 the inverse loss takes ``camera``'s cached
        ``inverse_points`` (``depth`` and ``alpha`` are the cached ones)."""
        use_inv, use_chamfer, use_patch, use_inv2 = flags
        geo = self.geo_emb
        # every inverse-net input in one batch: one hash-grid gather
        inv_in, stats = [], {}
        if use_inv:
            n_points = int(self.cfg.get_or("max_inverse_points", 0))
            with span("uv2.points"):
                if n_points:
                    world, wmask = inverse_world_points(
                        depth, alpha, camera, draws.get("score"), n_points)
                else:
                    world, wmask = self.inverse_points(camera), None
            with span("uv2.uv_net"):
                inv_in.append(self.uv_net(world, geo))
        if use_chamfer or use_inv2:
            inv_in.append(draws["sample_uvs"])
        if use_patch:
            inv_in.append(draws["patch_uvs"])
        with span("uv2.inv_uv_net"):
            outs = (list(torch.split(self.inv_uv_net(torch.cat(inv_in), geo),
                                     [len(x) for x in inv_in]))
                    if inv_in else [])

        loss = torch.zeros((), device=self.device)
        if use_inv:
            linv = masked_cycle_loss(world, wmask, outs.pop(0))
            loss = loss + lambdas["inverse"] * linv
            stats["Linv"] = linv
        if use_chamfer or use_inv2:
            sample_inv = outs.pop(0)
        if use_chamfer:
            with span("uv2.chamfer"):
                lch = chamfer_distance(sample_inv, self.pcd)
            loss = loss + lambdas["chamfer"] * lch
            stats["Lchamfer"] = lch
        if use_patch:
            with span("uv2.chamfer"):
                lpch = chamfer_distance(outs.pop(0), self.pcd,
                                        single_directional=True)
            loss = loss + lambdas["patch_chamfer"] * lpch
            stats["Lpatch_chamfer"] = lpch
        if use_inv2:
            with span("uv2.uv_net"):
                inv_uvs = self.uv_net(sample_inv, geo)
            linv2 = ((inv_uvs - draws["sample_uvs"]) ** 2).sum(-1).mean()
            loss = loss + lambdas["inverse2"] * linv2
            stats["Linv2"] = linv2
        stats["total_loss"] = loss
        return loss, stats

    @spanned("step")
    def compute_loss(self, cur_iter: int, total_iter: int, viewpoint: Camera,
                     render_unused, loss_cfg: Cfg, draws: Optional[dict] = None):
        """One training step on ``viewpoint``: the cached depth and alpha,
        the gated losses, their gradients and the Adam step.  ``draws``
        (default: drawn from the model's generator) are the step's random
        numbers.  Returns (total loss, stats, {})."""
        flags = self._flags(cur_iter, loss_cfg)
        lambdas = {k: float(loss_cfg.get_or(f"lambda_{k}", 0.0))
                   for k in LAMBDAS}
        depth, alpha, _, _ = self.depth_alpha(viewpoint)
        if draws is None:
            draws = self.draws(depth.shape[-2] * depth.shape[-1], flags)
        leaves = self._leaves()
        for p in leaves.values():
            p.requires_grad_(True)
            p.grad = None
        with torch.enable_grad():
            with span("loss"):
                loss, stats = self.loss_terms(depth, alpha, viewpoint, draws,
                                              flags, lambdas)
            with span("backward"):
                if loss.requires_grad:
                    loss.backward()
        with span("adam"):
            self.adam.step(leaves, self._lrs(leaves))
        stats = {k: v.detach() for k, v in stats.items()}
        return stats["total_loss"], stats, {}

    def optimize_step(self, cur_iter: int, total_iter: int, train_cfg: Cfg,
                      extra_info=None) -> None:
        # the learning-rate schedule's epoch (the reference steps it after
        # its optimizer step)
        self._step_count += 1

    # ---------------------------------------------------------- eval / io
    @torch.no_grad()
    def _chess_image(self, depth, alpha, camera: Camera) -> torch.Tensor:
        from texgs_torch.kernels.cubemap import (chessboard_cubemap,
                                                 sample_cubemap)

        world = depth2world(depth[0], camera.full_proj, camera.zfar,
                            camera.znear).reshape(-1, 3)
        a = alpha.reshape(-1)
        mask = (a > 0.5).to(torch.float32)
        rgb = sample_cubemap(chessboard_cubemap(device=self.device),
                             self.uv_net(world, self.geo_emb))
        img = rgb * (a * mask)[:, None] + self.bg[None, :] * (1 - a)[:, None]
        h, w = depth.shape[-2:]
        return img.reshape(h, w, 3).permute(2, 0, 1)

    @torch.no_grad()
    def visual_step(self, cur_iter: int, total_iter: int, viewpoint: Camera,
                    render_unused=None) -> dict:
        depth, alpha, norm, image = self.depth_alpha(viewpoint)
        return dict(image=image,
                    chess_image=self._chess_image(depth, alpha, viewpoint),
                    depth=depth, norm=norm, alpha=alpha)

    @torch.no_grad()
    def save_point_cloud(self, path: str) -> None:
        from texgs_torch.io.ply import write_ply_xyz

        gen = torch.Generator(device=self.device).manual_seed(12345)
        xyz = self.inv_uv_net(sample_sphere(gen, 8192), self.geo_emb)
        write_ply_xyz(path, xyz.cpu().numpy())

    def state_dict(self) -> dict:
        """texgs's stage-2 schema: ``net_state`` and ``optim_state`` (Adam
        trees + ``step_count``) as numpy trees."""
        sd = dict(net_state={"uv_net": self.uv_net.jax_params(),
                             "inv_uv_net": self.inv_uv_net.jax_params(),
                             "geo_emb": self.geo_emb.detach().cpu().numpy().copy()})
        if self.adam is not None:
            sd["optim_state"] = dict(self.adam.to_jax(),
                                     step_count=self._step_count)
        return sd

    def load_state_dict(self, sd: dict, optim_cfg: Optional[Cfg] = None) -> None:
        """Load a texgs-schema stage-2 state (the frozen Gaussians and the
        cloud come from the config's paths, as texgs's do).  With
        ``optim_cfg`` the Adam is set up and takes the state's moments."""
        if self.cfg.init_from:
            self.initialize()
        net = sd["net_state"]
        self.uv_net.load_jax_params(net["uv_net"])
        self.inv_uv_net.load_jax_params(net["inv_uv_net"])
        self.geo_emb = torch.as_tensor(np.array(net["geo_emb"], np.float32),
                                       device=self.device)
        if optim_cfg is None:
            return
        self.setup_optim(optim_cfg)
        os_ = sd.get("optim_state")
        if os_ is not None:
            self.adam.load_jax(os_)
            self._step_count = int(os_["step_count"])


def from_jax_state(sd: dict, cfg: Cfg, device="cuda",
                   optim_cfg: Optional[Cfg] = None) -> UVMapGaussian3D:
    """The port's stage-2 model from a texgs-schema state dict; ``cfg`` is
    the stage's ``model_cfg`` (its ``init_from`` and ``pcd_load_from`` are
    read as texgs reads them)."""
    model = UVMapGaussian3D(cfg, device=device)
    model.load_state_dict(sd, optim_cfg)
    return model
