"""Plain PyTorch stage-1 model: the SH-coloured 3DGS render (rgb, depth,
normal and alpha), the gated stage-1 loss, its gradients by autograd, the
six-leaf Adam and the bookkeeping of the iterations after densification.

Follows texgs/train/gaussian3d.py (``stage1_loss_terms``,
``compute_loss``, ``optimize_step``) and texgs/render/render.py, through
the plain pieces of ``render.py`` (SH evaluation, projection, binning,
the tile frame) and the losses of ``stage3.py``.  Float32, TF32 off (the
caller's settings: ``benchmark.run`` turns TF32 off).  A state is a dict
of the six leaves named as the program's Adam names them: ``xyz``,
``f_dc`` (N, 1, 3), ``f_rest`` (N, 15, 3), ``opacity``, ``scaling``,
``rotation``.

Departures from texgs's stage 1, each also the port's:
  - every Gaussian is alive: texgs pads to a power-of-two capacity and
    masks the padding, so its opacity regulariser also averages over the
    dead rows; here it averages over the N Gaussians;
  - every pair is kept: texgs caps the pair list at max(4N, 2^14) and
    flags an overflow;
  - no one-step-lagged validation: each step's stats are its own;
  - the blend walks each tile's depth-ordered pairs CHUNK at a time, all
    tiles at once, with texgs's 3DGS stop rule (``R.chunk_weights``).
Not here: densification and the opacity prune (iterations up to
``densify_until_iter`` and multiples of ``opacity_prune_interval``
raise), the depth and normal-regulariser losses (their gates raise), the
densification statistics.  Nothing here imports the program.
"""

from __future__ import annotations

import torch

from benchmark.reference import render as R
from benchmark.reference import stage3 as S

LEAVES = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")
UNSUPPORTED = ("depth", "norm_reg")
N_F = 7                     # blend channels: rgb, depth, normal


# ------------------------------------------------------------ render
def blend(table, pairs: R.Pairs, gx: int):
    """The front-to-back blend of each tile's depth-ordered pairs: channels
    (T, PIX, 7), T_final (T, PIX) and the pairs each pixel evaluated (T,
    PIX), the one that stopped it included."""
    dev = table.device
    n_tiles = pairs.tile_counts.shape[0]
    tiles = torch.arange(n_tiles, device=dev)
    tile_x = ((tiles % gx) * R.TILE).to(table.dtype)[:, None]
    tile_y = ((tiles // gx) * R.TILE).to(table.dtype)[:, None]
    out = torch.zeros((n_tiles, R.PIX, N_F), device=dev)
    t_buf = torch.ones((n_tiles, R.PIX), device=dev)
    done = torch.zeros((n_tiles, R.PIX), dtype=torch.bool, device=dev)
    n_eval = torch.zeros((n_tiles, R.PIX), dtype=torch.int64, device=dev)
    counts, starts = pairs.tile_counts, pairs.tile_start
    n_pairs = pairs.pair_gauss.shape[0]
    max_count = int(counts.max()) if n_tiles and n_pairs else 0
    for k0 in range(0, max_count, R.CHUNK):
        k = torch.arange(k0, k0 + R.CHUNK, device=dev)
        live = k[None, :] < counts[:, None]
        g = pairs.pair_gauss[torch.clamp(starts[:, None] + k[None, :],
                                         max=n_pairs - 1)]
        rws = table.index_select(0, g.reshape(-1)).reshape(*g.shape, -1)
        quad = R.shift_to_tile(rws, tile_x, tile_y)
        quad = torch.cat([quad[..., :5], torch.where(
            live, quad[..., 5], R.NEG_INF)[..., None]], dim=-1)
        power = R.tile_power(quad)
        w, t_out, done_m, fail = R.chunk_weights(
            power, rws[..., R.ROW_LOGOP][:, None, :], t_buf, done)
        out = out + torch.bmm(w, rws[..., R.ROW_F0:R.COL_ANCHOR])
        fi = fail.to(torch.int64)
        stopped = done[..., None] | ((torch.cumsum(fi, -1) - fi) > 0)
        n_eval = n_eval + (live[:, None, :] & ~stopped).sum(-1)
        t_buf, done = t_out, done_m[..., -1]
    return out, t_buf, n_eval


def colors(state: dict, cam: R.Cam, sh_degree: int):
    """SH colours of degree ``sh_degree`` seen from the camera, +0.5 and
    clamped at 0."""
    xyz = state["xyz"]
    campos = torch.as_tensor(cam.campos, device=xyz.device, dtype=xyz.dtype)
    dirs = xyz - campos[None, :]
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    sh = torch.cat([state["f_dc"], state["f_rest"]], dim=1)
    return torch.clamp(R.eval_sh(sh_degree, sh.transpose(-1, -2), dirs) + 0.5,
                       min=0.0)


def geometry(state: dict):
    """(opacity, scaling, rotation) activated: sigmoid, exp, normalised."""
    rot = state["rotation"] / (torch.linalg.norm(
        state["rotation"], dim=-1, keepdim=True) + 1e-12)
    return torch.sigmoid(state["opacity"]), torch.exp(state["scaling"]), rot


def render_state(state: dict, cam: R.Cam, sh_degree: int, bg,
                 keep=None) -> dict:
    """image, depth (normalised by alpha), norm and alpha of ``cam`` from
    the raw leaves.  ``keep`` receives the pair list and the evaluated
    pairs, which the benchmark's counts read."""
    opacity, scaling, rot = geometry(state)
    proj = R.project(state["xyz"], scaling, rot, opacity, cam)
    table = R.gauss_table(proj, colors(state, cam, sh_degree))
    h, w = cam.height, cam.width
    pairs = R.build_pairs(proj.means2d, proj.depths, proj.radii, h, w)
    out, t_final, n_eval = blend(table, pairs, R.grid_shape(h, w)[1])
    if keep is not None:
        keep.update(pairs=pairs, n_eval=n_eval)
    img = R.tiles_to_image(out, h, w)
    t_fin = R.tiles_to_image(t_final[..., None], h, w)
    alpha = 1.0 - t_fin
    return dict(image=img[0:3] + t_fin * bg[:, None, None],
                depth=img[3:4] / torch.clamp(alpha, min=1e-6),
                norm=img[4:7], alpha=alpha)


# ------------------------------------------------------------ loss
def zero_one_loss(value, epsilon: float = 1e-3):
    """Mean of log(v) + log(1 - v), v clamped to [eps, 1 - eps]: pushes
    each opacity to 0 or 1."""
    v = torch.clamp(value, epsilon, 1 - epsilon)
    return (torch.log(v) + torch.log(1 - v)).mean()


def loss_flags(it: int, lc: dict, view: dict) -> dict:
    def on(name):
        return bool(lc.get(f"lambda_{name}")) and S.in_range(
            it, lc.get(f"{name}_range"))
    flags = {k: on(k) for k in ("alpha", "opacity_reg", "norm", "norm_smooth",
                                *UNSUPPORTED)}
    flags["norm"] = flags["norm"] and view.get("normal") is not None
    for k in UNSUPPORTED:
        if flags[k]:
            raise NotImplementedError(f"the reference has no {k} loss")
    return flags


def stage1_loss(out: dict, view: dict, opacity, lc: dict, flags: dict):
    """(1 - dssim) L1 + dssim (1 - SSIM), and the gated alpha, zero-one
    opacity, normal and bilateral-smoothness terms."""
    gt, gt_alpha = view["image"], view["alpha"]
    d = float(lc.get("lambda_dssim") or 0.0)
    loss = ((1.0 - d) * S.l1_loss(out["image"], gt)
            + d * (1.0 - S.ssim(out["image"], gt)))
    if flags["alpha"]:
        loss = loss + float(lc["lambda_alpha"]) * S.l1_loss(out["alpha"],
                                                            gt_alpha)
    if flags["opacity_reg"]:
        loss = loss + float(lc["lambda_opacity_reg"]) * zero_one_loss(opacity)
    if flags["norm"]:
        loss = loss + float(lc["lambda_norm"]) * S.norm_loss(
            out["norm"], view["normal"], gt_alpha)
    if flags["norm_smooth"]:
        loss = loss + float(lc["lambda_norm_smooth"]) * S.smooth_loss(
            gt, out["norm"], gt_alpha)
    return loss


# ------------------------------------------------------- the step
class Trainer:
    """The stage-1 training step after densification on a reference state,
    with the Adam's moments and counts (``opt``: leaf -> (mu, nu, count))."""

    def __init__(self, state: dict, opt: dict, hyper: dict, cfg: dict):
        self.state = {k: v.detach().clone() for k, v in state.items()}
        self.opt = {k: (mu.clone(), nu.clone(), c) for k, (mu, nu, c)
                    in opt.items()}
        self.active_sh = int(hyper["active_sh_degree"])
        self.extent = float(hyper["spatial_lr_scale"])
        self.cfg = cfg

    def lrs(self, it: int) -> dict:
        oc = self.cfg["optim_cfg"]
        return {"xyz": S.expon_lr(oc["position_lr_init"] * self.extent,
                                  oc["position_lr_final"] * self.extent,
                                  oc["position_lr_delay_mult"],
                                  oc["position_lr_max_steps"], it),
                "f_dc": oc["feature_lr"], "f_rest": oc["feature_lr"] / 20.0,
                "opacity": oc["opacity_lr"], "scaling": oc["scaling_lr"],
                "rotation": oc["rotation_lr"]}

    def surgery(self, it: int) -> bool:
        """Whether a min-scale reset follows the step (which then takes no
        Adam step); iterations of the other surgeries raise."""
        tc = self.cfg["train_cfg"]
        if it <= int(tc.get("densify_until_iter") or 0):
            raise NotImplementedError("the reference has no densification")
        pi = tc.get("opacity_prune_interval")
        if (pi and it % int(pi) == 0) or it in (tc.get("opacity_prune_iters")
                                                or ()):
            raise NotImplementedError("the reference has no opacity prune")
        ri = tc.get("min_scale_reset_interval")
        return bool(ri and it % int(ri) == 0)

    def step(self, it: int, view: dict, bg):
        """One iteration: SH degree, render, loss, gradients, Adam (unless
        a reset follows), the reset.  Returns the loss, the rendered
        outputs (detached) and each leaf's gradient."""
        if it % 1000 == 0:
            self.active_sh = min(self.active_sh + 1,
                                 int(self.cfg["model_cfg"]["sh_degree"]))
        lc = self.cfg["loss_cfg"]
        flags = loss_flags(it, lc, view)
        reset = self.surgery(it)
        leaves = {k: v.requires_grad_(True) for k, v in self.state.items()}
        with torch.enable_grad():
            out = render_state(leaves, view["cam"], self.active_sh, bg)
            loss = stage1_loss(out, view, torch.sigmoid(leaves["opacity"]),
                               lc, flags)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        lrs = self.lrs(it)
        with torch.no_grad():
            for (k, p), g in zip(leaves.items(), grads):
                p.requires_grad_(False)
                if reset:
                    continue
                g = torch.zeros_like(p) if g is None else g
                mu, nu, c = self.opt[k]
                c += 1
                mu.mul_(S.BETA1).add_((1 - S.BETA1) * g)
                nu.mul_(S.BETA2).add_((1 - S.BETA2) * (g * g))
                p.sub_(lrs[k] * (mu / (1 - S.BETA1 ** c))
                       / (torch.sqrt(nu / (1 - S.BETA2 ** c)) + S.EPS))
                self.opt[k] = (mu, nu, c)
            if reset:
                s = self.state["scaling"]
                s.scatter_(1, torch.argmin(s, dim=1, keepdim=True), -20.0)
                self.opt["scaling"][0].zero_()
                self.opt["scaling"][1].zero_()
        return loss.detach(), {k: v.detach() for k, v in out.items()}, grads
