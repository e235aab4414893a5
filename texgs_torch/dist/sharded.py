"""The production stage-1 and stage-3 training steps across ranks (port of
texgs/dist/sharded.py).

* cameras over the ``data`` axis, one a rank (``rank_camera``);
* the render work of each camera over the ``tile`` axis: row bands
  (``shard_mode="tile"``), depth slices folded with the over operator
  (``"gauss"``, where the ``tile`` axis carries the slices, as in texgs),
  or both on a (data, tile, gauss) mesh (``"tile+gauss"``: each rank one
  band of one slice, folded over ``gauss``, gathered over ``tile``);
* the bands are gathered (``collectives.all_gather``) and the whole
  image's loss, the same ``stage1_loss_terms``/``stage3_loss_terms`` as
  the single-card steps, is computed on every rank; the gather's backward
  hands each band its own pixels' cotangents;
* the gradients are summed over ``tile`` (and ``gauss``), the texture
  cubemap's included (each band's texel scatter is partial), and averaged
  over ``data``, in one flat buffer a reduction; then every rank takes the
  same Adam steps, so the replicas stay identical.

Loss terms that touch parameters directly (the opacity regulariser; in
stage 3 the inverse term on the UV nets) take ``grad_scale(., 1/n_repl)``,
so the sum over the render axes counts them once.  The steps take the
port's model objects and update them in place, as ``compute_loss`` does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from texgs_torch.core.camera import Camera, ground_truth
from texgs_torch.core.state import GaussianState
from texgs_torch.dist.collectives import (all_gather, axis_index, axis_size,
                                          flat_grads, grad_scale, pmax_,
                                          pmean_, psum_, set_grads)
from texgs_torch.dist.data_parallel import _train_leaves, rank_camera
from texgs_torch.dist.gauss_sharded import (gauss_sharded_render,
                                            gauss_sharded_uv_tex_render)
from texgs_torch.dist.tile_parallel import band_height, stitch_bands
from texgs_torch.render.render import render
from texgs_torch.render.uv_tex_render import uv_tex_render
from texgs_torch.train import densify
from texgs_torch.train.gaussian3d import stage1_loss_terms
from texgs_torch.train.optim import Adam
from texgs_torch.train.texture_gaussian3d import stage3_loss_terms

SHARD_MODES = ("tile", "gauss", "tile+gauss")


def gather_bands(channels: torch.Tensor, mesh, tile_axis: str,
                 height: int) -> torch.Tensor:
    """(C, band_h, W) on each rank -> the whole (C, H, W) on every rank.
    The 1/n rescale before the gather makes the later sum of the parameter
    gradients over ``tile`` count every pixel once."""
    n = axis_size(mesh, tile_axis)
    g = all_gather(grad_scale(channels, 1.0 / n), mesh, tile_axis)
    return stitch_bands(g, height)


class _Layout:
    """Where this rank sits: its camera, the render axes and its band."""

    def __init__(self, mesh, camera_batch, shard_mode, data_axis, tile_axis):
        if shard_mode not in SHARD_MODES:
            raise ValueError(f"shard_mode {shard_mode!r}; one of "
                             f"{SHARD_MODES}")
        self.gauss_axis = "gauss" if shard_mode == "tile+gauss" else None
        self.render_axes = [tile_axis, self.gauss_axis]
        self.cam = rank_camera(mesh, camera_batch, data_axis)
        self.height = self.cam.height
        n_bands = axis_size(mesh, tile_axis)
        self.n_repl = n_bands * axis_size(mesh, self.gauss_axis)
        self.band_h = band_height(self.height, n_bands)
        self.row0 = axis_index(mesh, tile_axis) * self.band_h


def _reduce(mesh, lay: _Layout, data_axis: str, grads: torch.Tensor,
            loss: torch.Tensor, stats: dict):
    """Gradients summed over the render axes, then gradients, loss and the
    stats averaged over ``data`` in one collective."""
    psum_(grads, mesh, lay.render_axes)
    names = list(stats)
    buf = torch.cat([grads, loss.detach().reshape(1).float(),
                     torch.stack([stats[k].detach().float() for k in names])])
    pmean_(buf, mesh, data_axis)
    n = grads.numel()
    return (buf[:n], buf[n],
            {k: buf[n + 1 + i] for i, k in enumerate(names)})


def stage1_sharded_step(mesh, state: GaussianState, adam: Adam,
                        stats: densify.DensifyStats,
                        camera_batch: Sequence[Camera], lrs: dict,
                        lambdas: dict, apply_adam: bool, flags: tuple,
                        active_sh_degree: int, backend: str = "scan",
                        data_axis: str = "data", tile_axis: str = "tile",
                        shard_mode: str = "tile"):
    """Sharded twin of ``Gaussian3D.compute_loss``'s step (texgs
    ``stage1_sharded_step``).  camera_batch: one camera (with its ground
    truth) per ``data`` rank; lambdas: the loss weights and ``bg``; flags:
    stage1_loss_terms's, the last one tracking the densify stats.

    ``state`` and ``adam`` change in place (Adam only with ``apply_adam``).
    Returns (loss, stats, densify stats): the loss and its terms averaged
    over the cameras, ``n_pairs`` summed over the render axes and maxed
    over ``data``; the densify stats with this step's NDC-gradient norms
    (summed over the render axes) and visibility summed over the cameras
    and max radii maxed over them, or ``stats`` as given when flags[6] is
    off."""
    lay = _Layout(mesh, camera_batch, shard_mode, data_axis, tile_axis)
    cam, dev = lay.cam, state.xyz.device
    gt_image, gt_alpha = ground_truth(cam, dev)
    params = _train_leaves(state)
    ndc = torch.zeros((state.n_alive, 2), device=dev, requires_grad=True)
    bg = torch.as_tensor(lambdas["bg"], dtype=torch.float32, device=dev)
    with torch.enable_grad():
        opacity = state.get_opacity()
        kw = dict(xyz=state.xyz, opacity=opacity, scaling=state.get_scaling(),
                  rotation=state.get_rotation(),
                  features=state.get_features(),
                  active_sh_degree=active_sh_degree, bg_color=bg,
                  ndc_offset=ndc, backend=backend)
        if shard_mode == "gauss":
            out = gauss_sharded_render(cam, mesh=mesh, axis_name=tile_axis,
                                       **kw)
        elif shard_mode == "tile+gauss":
            out = gauss_sharded_render(cam, mesh=mesh,
                                       axis_name=lay.gauss_axis,
                                       row_offset=lay.row0,
                                       band_height=lay.band_h, **kw)
        else:
            out = render(cam, row_offset=lay.row0, band_height=lay.band_h,
                         **kw)
        full = torch.cat([out["render"], out["depth"], out["norm"],
                          out["alpha"]], dim=0)
        if shard_mode != "gauss":
            full = gather_bands(full, mesh, tile_axis, lay.height)
        loss, stats_d = stage1_loss_terms(
            full[0:3], full[3:4], full[4:7], full[7:8], cam, gt_image,
            gt_alpha, grad_scale(opacity, 1.0 / lay.n_repl), flags, lambdas)
        loss.backward()

    leaves = list(params.values())
    grads, loss, stats_d = _reduce(mesh, lay, data_axis, flat_grads(leaves),
                                   loss, stats_d)
    n_pairs = psum_(out["n_pairs"].reshape(1).clone(), mesh, lay.render_axes)
    stats_d["n_pairs"] = pmax_(n_pairs, mesh, [data_axis])[0]
    stats_d["pair_overflow"] = torch.zeros((), dtype=torch.bool, device=dev)

    new_stats = stats
    if flags[6]:
        # densify stats: a camera's NDC gradient summed over the render
        # axes; visibility counts summed and radii maxed over the cameras
        vs_grad = psum_(ndc.grad.contiguous(), mesh, lay.render_axes)
        visible = (out["radii"] > 0)[:, None]
        gnorm = torch.linalg.norm(vs_grad, dim=-1, keepdim=True)
        acc = psum_(torch.cat([torch.where(visible, gnorm, 0.0),
                               visible.to(torch.float32)], dim=1),
                    mesh, [data_axis])
        r_max = pmax_(torch.where(visible[:, 0],
                                  out["radii"].to(torch.float32), 0.0),
                      mesh, [data_axis])
        new_stats = densify.DensifyStats(
            xyz_gradient_accum=stats.xyz_gradient_accum + acc[:, :1],
            denom=stats.denom + acc[:, 1:],
            max_radii2d=torch.maximum(stats.max_radii2d, r_max))
    if apply_adam:
        set_grads(leaves, grads)
        adam.step(params, lrs)
    return loss, stats_d, new_stats


def stage3_sharded_step(mesh, model, camera_batch: Sequence[Camera],
                        lrs: dict, lambdas: dict, apply_flags: tuple,
                        flags: tuple, active_sh_degree: int,
                        n_inv_points: int, m: int = 32,
                        backend: str = "scan", tex_backend: str = "xla",
                        filter_mode: str = "bilinear",
                        generator: Optional[torch.Generator] = None,
                        data_axis: str = "data", tile_axis: str = "tile",
                        shard_mode: str = "tile"):
    """Sharded twin of ``TextureGaussian3D.compute_loss``'s step (texgs
    ``stage3_sharded_step``) on a ``TextureGaussian3D`` whose Adams are set
    up.  lrs: xyz, opacity, scaling, rotation, shs, uv_net (the UV net and
    the geometry embedding), inv_uv_net and tex; apply_flags: the Gaussian,
    UV and texture Adams; flags and lambdas (with ``bg``):
    stage3_loss_terms's.  ``generator`` draws the inverse term's pixels
    (default the model's): seed it alike on every rank, as texgs hands
    every chip the same key, so the replicated loss is the same on each.

    The model's parameters and Adams change in place.  Returns (loss,
    stats) averaged over the cameras, ``n_pairs`` summed over the render
    axes."""
    lay = _Layout(mesh, camera_batch, shard_mode, data_axis, tile_axis)
    cam, dev = lay.cam, model.device
    use_no_sh = flags[7]
    gt_image, gt_alpha = ground_truth(cam, dev)
    groups = (model._gauss_leaves(), model._uv_leaves(), model._tex_leaves())
    for leaves in groups:
        for p in leaves.values():
            p.requires_grad_(True)
            p.grad = None
    bg = torch.as_tensor(lambdas["bg"], dtype=torch.float32, device=dev)
    with torch.enable_grad():
        act = model._activated()
        uvs, jac = model._uvs_and_jac(act["xyz"])
        kw = dict(xyz=act["xyz"], opacity=act["opacity"],
                  scaling=act["scaling"], rotation=act["rotation"], uvs=uvs,
                  grad_uvs=jac, texture=model.texture, shs=act["shs"],
                  active_sh_degree=active_sh_degree, bg_color=bg, m=m,
                  filter_mode=filter_mode, backend=backend,
                  tex_backend=tex_backend, with_no_sh=use_no_sh)
        if shard_mode == "tile":
            out = uv_tex_render(cam, row_offset=lay.row0,
                                band_height=lay.band_h, **kw)
        else:
            band = ({"row_offset": lay.row0, "band_height": lay.band_h}
                    if lay.gauss_axis else {})
            out = gauss_sharded_uv_tex_render(
                cam, mesh=mesh, axis_name=lay.gauss_axis or tile_axis,
                **band, **kw)
        parts = [out["render"], out["depth"], out["norm"], out["alpha"]]
        if use_no_sh:
            parts.append(out["render_no_sh"])
        full = torch.cat(parts, dim=0)
        if shard_mode != "gauss":
            full = gather_bands(full, mesh, tile_axis, lay.height)
        s = 1.0 / lay.n_repl
        loss, stats = stage3_loss_terms(
            full[0:3], full[3:4], full[4:7], full[7:8],
            full[8:11] if use_no_sh else None, cam, gt_image, gt_alpha,
            grad_scale(act["opacity"], s), model.uv_net, model.inv_uv_net,
            model.geo_emb, model.rng if generator is None else generator,
            n_inv_points, flags, lambdas, inverse_grad_scale=s)
        loss.backward()

    leaves = [p for g in groups for p in g.values()]
    n_pairs = psum_(out["n_pairs"].reshape(1).clone(), mesh, lay.render_axes)
    stats["n_pairs"] = n_pairs[0]
    grads, loss, stats = _reduce(mesh, lay, data_axis, flat_grads(leaves),
                                 loss, stats)
    stats["pair_overflow"] = torch.zeros((), dtype=torch.bool, device=dev)
    set_grads(leaves, grads)

    gl, ul, tl = groups
    g_lrs = {k: lrs[k] for k in gl}
    uv_lrs = {k: lrs["inv_uv_net"] if k.startswith("inv_uv_net.")
              else lrs["uv_net"] for k in ul}
    for adam, leaves_, lr, on in ((model.adam_g, gl, g_lrs, apply_flags[0]),
                                  (model.adam_uv, ul, uv_lrs, apply_flags[1]),
                                  (model.adam_tex, tl, {"texture": lrs["tex"]},
                                   apply_flags[2])):
        if on:
            adam.step(leaves_, lr)
    return loss, stats
