"""Adaptive density control (port of texgs/train/densify.py).

Densify (clone + split), prune, opacity prune and the opacity and min-scale
resets, on the port's dynamic-size Gaussians.  The resets change their
leaf in place; densify and prune return a new ``GaussianState`` of fresh
tensors and the stats of its rows.  Each op rewrites the per-leaf Adam
moments to match (new rows get zero moments; the step counts are kept).

Rows come out in texgs's order: ``_compact``'s stable sort over the
candidate groups [originals, clones, split child 1, split child 2]
(:98-112), each group in index order, so a state compares row by row with
texgs's first ``n_alive`` rows.  texgs pads every array to a fixed
capacity and only grows it (``grow_capacity``, ``required_capacity``)
because the TPU needs static shapes; PyTorch holds dynamic shapes, so
those two have no counterpart here.
"""

from __future__ import annotations

import dataclasses

import torch

from texgs_torch.core.state import GaussianState, inverse_sigmoid
from texgs_torch.train.optim import Adam
from texgs_torch.utils.transforms import rotation_channels

SPLIT_N = 2                  # children per split
SPLIT_SCALE_SHRINK = 0.8     # child scale divisor is 0.8 * N


@dataclasses.dataclass
class DensifyStats:
    xyz_gradient_accum: torch.Tensor  # (N, 1) accumulated screen-space grad norms
    denom: torch.Tensor               # (N, 1) visibility counts
    max_radii2d: torch.Tensor         # (N,) max screen radius seen


def init_stats(n: int, device) -> DensifyStats:
    return DensifyStats(
        xyz_gradient_accum=torch.zeros((n, 1), device=device),
        denom=torch.zeros((n, 1), device=device),
        max_radii2d=torch.zeros((n,), device=device))


@torch.no_grad()
def add_stats(stats: DensifyStats, vs_grad: torch.Tensor,
              radii: torch.Tensor) -> DensifyStats:
    """Accumulate the screen-space positional gradients of the visible
    Gaussians.  vs_grad: (N, 2) gradient of the NDC offset, in texgs's
    NDC units (render's ``ndc_offset``)."""
    visible = (radii > 0)[:, None]
    gnorm = torch.linalg.norm(vs_grad[:, :2], dim=-1, keepdim=True)
    return DensifyStats(
        xyz_gradient_accum=stats.xyz_gradient_accum
        + torch.where(visible, gnorm, 0.0),
        denom=stats.denom + visible.to(torch.float32),
        max_radii2d=torch.maximum(
            stats.max_radii2d,
            torch.where(visible[:, 0], radii.to(torch.float32), 0.0)))


def avg_grads(stats: DensifyStats) -> torch.Tensor:
    """(N,) mean accumulated gradient (0 where never visible)."""
    d = stats.denom[:, 0]
    return torch.where(d > 0, stats.xyz_gradient_accum[:, 0]
                       / torch.clamp(d, min=1), 0.0)


@torch.no_grad()
def reset_opacity(state: GaussianState, adam: Adam) -> GaussianState:
    """Clamp opacities to <= 0.01, in place, and zero the opacity Adam
    moments."""
    state.opacity.copy_(inverse_sigmoid(torch.clamp(
        torch.sigmoid(state.opacity), max=0.01)))
    adam.zero_moments("opacity")
    return state


@torch.no_grad()
def reset_min_scale(state: GaussianState, adam: Adam,
                    value: float = -20.0) -> GaussianState:
    """Force each Gaussian's smallest log-scale to ``value`` (a flat
    disc), in place, and zero the scaling Adam moments."""
    s = state.scaling
    s.scatter_(1, torch.argmin(s, dim=1, keepdim=True), value)
    adam.zero_moments("scaling")
    return state


def _prune_mask(opacity_logit, scaling_log, radii2d, min_opacity: float,
                extent: float, max_screen_size):
    """Prune rule of densify_and_prune (texgs :130-139)."""
    mask = torch.sigmoid(opacity_logit[:, 0]) < min_opacity
    if max_screen_size:
        big_vs = radii2d > max_screen_size
        big_ws = torch.exp(scaling_log).max(dim=1).values > 0.1 * extent
        mask = mask | big_vs | big_ws
    return mask


def _select_moments(adam: Adam, keep_groups) -> None:
    """Rebuild each leaf's moments from (rows of the old moments or None
    for zeros, row mask) groups, concatenated in order."""
    for moments in (adam.mu, adam.nu):
        for k, m in moments.items():
            moments[k] = torch.cat([
                m[mask] if old else torch.zeros_like(m[mask])
                for old, mask in keep_groups], dim=0).contiguous()


@torch.no_grad()
def densify_and_prune(state: GaussianState, adam: Adam, stats: DensifyStats,
                      split_noise: torch.Tensor, *, max_grad: float,
                      min_opacity: float, extent: float, max_screen_size,
                      percent_dense: float):
    """Clone + split + prune (texgs :154-220).

    split_noise: (2, N, 3) standard normal draws of the two split
    children, which the caller draws from its generator (texgs draws them
    with ``jax.random.normal`` inside).  Returns (state, stats); ``adam``'s
    moments are rewritten in place, its counts kept."""
    grads = avg_grads(stats)
    scaling_act = torch.exp(state.scaling)
    maxscale = scaling_act.max(dim=1).values

    hot = grads >= max_grad
    clone_sel = hot & (maxscale <= percent_dense * extent)
    split_sel = hot & (maxscale > percent_dense * extent)

    orig = {k: v.detach() for k, v in state.params_dict().items()}
    n = orig["xyz"].shape[0]
    R = torch.stack(rotation_channels(orig["rotation"]), dim=-1).reshape(n, 3, 3)
    child_scaling = torch.log(scaling_act / (SPLIT_SCALE_SHRINK * SPLIT_N))

    def make_child(noise):
        child = dict(orig)
        child["xyz"] = (R @ (noise * scaling_act)[..., None])[..., 0] + orig["xyz"]
        child["scaling"] = child_scaling
        return child

    child1, child2 = make_child(split_noise[0]), make_child(split_noise[1])
    zero_r = torch.zeros_like(stats.max_radii2d)
    prune_orig = _prune_mask(orig["opacity"], orig["scaling"],
                             stats.max_radii2d, min_opacity, extent,
                             max_screen_size)
    prune_clone = _prune_mask(orig["opacity"], orig["scaling"], zero_r,
                              min_opacity, extent, max_screen_size)

    def prune_child(ch):
        return _prune_mask(ch["opacity"], ch["scaling"], zero_r, min_opacity,
                           extent, max_screen_size)

    groups = [orig, orig, child1, child2]
    valids = [~split_sel & ~prune_orig,
              clone_sel & ~prune_clone,
              split_sel & ~prune_child(child1),
              split_sel & ~prune_child(child2)]
    rows = {k: torch.cat([g[k][v] for g, v in zip(groups, valids)],
                         dim=0).contiguous() for k in orig}
    _select_moments(adam, [(True, valids[0])] + [(False, v) for v in valids[1:]])
    new_n = rows["xyz"].shape[0]
    return GaussianState.from_params(rows), init_stats(new_n, state.xyz.device)


@torch.no_grad()
def opacity_prune(state: GaussianState, adam: Adam, stats: DensifyStats,
                  min_opacity: float):
    """Standalone opacity prune (texgs :223-241); keeps the stats rows of
    the kept Gaussians.  Returns (state, stats)."""
    keep = torch.sigmoid(state.opacity[:, 0]) >= min_opacity
    rows = {k: v.detach()[keep].contiguous()
            for k, v in state.params_dict().items()}
    _select_moments(adam, [(True, keep)])
    return GaussianState.from_params(rows), DensifyStats(
        xyz_gradient_accum=stats.xyz_gradient_accum[keep],
        denom=stats.denom[keep], max_radii2d=stats.max_radii2d[keep])
