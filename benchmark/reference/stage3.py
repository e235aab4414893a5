"""Plain PyTorch stage-3 model: the UV net with its Jacobian, the gated
stage-3 losses, the three Adams and the per-iteration bookkeeping.

Frozen copies of:
  texgs_torch/nets/uv_net.py             UVNet.forward_with_jac,
                                         _mlp_with_tangents
  texgs_torch/losses/{pixelwise,ssim,normal,smooth}.py
                                         l1_loss, ssim_loss, norm_loss,
                                         smooth_loss
  texgs_torch/train/texture_gaussian3d.py stage3_loss_terms,
                                         step_settings, compute_loss,
                                         optimize_step, _reset_min_scale
  texgs_torch/train/optim.py             Adam (eps 1e-15, betas 0.9,
                                         0.999, a count a leaf)
  texgs_torch/utils/schedules.py         expon_lr, warmup_multistep
  texgs_torch/config.py                  in_range
A state is a dict of tensors named as the program's optimisers name their
leaves ("xyz", "uv_net.mlp.w.0", "texture", ...), with the MLP weights in
(out, in) layout.  The losses this copy has are those of the two
configurations the benchmark runs; a gate on any other term raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import render as R

BETA1, BETA2, EPS = 0.9, 0.999, 1e-15
GAUSS_KEYS = ("xyz", "opacity", "scaling", "rotation", "shs")
UNSUPPORTED = ("depth", "norm_reg", "opacity_reg", "inverse")


# ----------------------------------------------------------- UV net
def _layers(state: dict, net: str, part: str):
    out, i = [], 0
    while f"{net}.{part}.w.{i}" in state:
        out.append((state[f"{net}.{part}.w.{i}"], state[f"{net}.{part}.b.{i}"]))
        i += 1
    return out


def _mlp_with_tangents(layers, h, tang):
    for i, (w, b) in enumerate(layers):
        h = h @ w.T + b
        tang = tang @ w.detach().T
        if i < len(layers) - 1:
            tang = tang * (h > 0).to(h.dtype).detach()[None]
            h = torch.relu(h)
    return h, tang


def uv_net_with_jac(state: dict, xyz):
    """(uvs (N, 3), duv/dxyz (N, 9) row-major): forward mode through the
    MLP chain with three tangent columns; the Jacobian is detached."""
    n = xyz.shape[0]
    tang = torch.eye(3, device=xyz.device)[:, None, :].expand(3, n, 3)
    h, tang = _mlp_with_tangents(_layers(state, "uv_net", "pre_mlp"), xyz, tang)
    pre = h + state["geo_emb"][None, :]
    h = torch.relu(pre)
    tang = tang * (pre > 0).to(h.dtype).detach()[None]
    o, t_o = _mlp_with_tangents(_layers(state, "uv_net", "mlp"), h, tang)
    norm = torch.linalg.norm(o, dim=-1, keepdim=True)
    uvs = o / (norm + 1e-12)
    o_sg, n_sg = o.detach(), norm.detach()
    d_sg = n_sg + 1e-12
    ot = (o_sg[None] * t_o).sum(-1, keepdim=True)
    t_uv = (t_o / d_sg[None] - o_sg[None] * ot
            / (torch.clamp(n_sg, min=1e-12) * d_sg * d_sg)[None])
    return uvs, t_uv.permute(1, 2, 0).detach().reshape(n, 9)


def render_state(state: dict, cam: R.Cam, active_sh_degree: int, bg, m: int,
                 with_no_sh: bool = True, keep=None) -> dict:
    """The model's render of ``cam`` from its raw leaves."""
    rot = state["rotation"] / (torch.linalg.norm(
        state["rotation"], dim=-1, keepdim=True) + 1e-12)
    uvs, jac = uv_net_with_jac(state, state["xyz"])
    return R.render(cam, state["xyz"], torch.sigmoid(state["opacity"]),
                    torch.exp(state["scaling"]), rot, uvs, jac,
                    state["texture"], state.get("shs"), active_sh_degree, bg,
                    m, with_no_sh, keep)


# ----------------------------------------------------------- losses
def l1_loss(pred, gt):
    return (pred - gt).abs().mean()


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5):
    xs = [math.exp(-((x - window_size // 2) ** 2) / (2 * sigma ** 2))
          for x in range(window_size)]
    window = torch.tensor([x / sum(xs) for x in xs], dtype=img1.dtype,
                          device=img1.device)
    c = img1.shape[0]
    pad = window_size // 2
    kh = window.reshape(1, 1, -1, 1).expand(c, 1, -1, 1)
    kw = window.reshape(1, 1, 1, -1).expand(c, 1, 1, -1)

    def blur(x):
        x = F.conv2d(x[None], kh, padding=(pad, 0), groups=c)
        return F.conv2d(x, kw, padding=(0, pad), groups=c)[0]

    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = blur(img1 * img1) - mu1_sq
    s2 = blur(img2 * img2) - mu2_sq
    s12 = blur(img1 * img2) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1_mu2 + c1) * (2 * s12 + c2))
            / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))).mean()


def norm_loss(pred, gt, mask):
    cos = (pred * gt).sum(dim=0, keepdim=True)
    return ((1.0 - cos) * mask).sum() / (mask.sum() + 1e-6)


def smooth_loss(rgb, value, mask, gamma: float = 0.1):
    def bilateral(x):
        return torch.exp(-x.abs().sum(0, keepdim=True) / gamma)

    w1 = bilateral(rgb[:, :, :-1] - rgb[:, :, 1:]) * mask[:, :, :-1] * mask[:, :, 1:]
    w2 = bilateral(rgb[:, :-1, :] - rgb[:, 1:, :]) * mask[:, :-1, :] * mask[:, 1:, :]
    w3 = (bilateral(rgb[:, :-1, :-1] - rgb[:, 1:, 1:])
          * mask[:, :-1, :-1] * mask[:, 1:, 1:])
    w4 = (bilateral(rgb[:, 1:, :-1] - rgb[:, :-1, 1:])
          * mask[:, 1:, :-1] * mask[:, :-1, 1:])
    l1 = (w1 * (value[:, :, :-1] - value[:, :, 1:])).abs().sum() / (w1.sum() + 1e-6)
    l2 = (w2 * (value[:, :-1, :] - value[:, 1:, :])).abs().sum() / (w2.sum() + 1e-6)
    l3 = ((w3 * (value[:, :-1, :-1] - value[:, 1:, 1:])).abs().sum()
          / (w3.sum() + 1e-6))
    l4 = ((w4 * (value[:, 1:, :-1] - value[:, :-1, 1:])).abs().sum()
          / (w4.sum() + 1e-6))
    return (l1 + l2 + l3 + l4) / 4


def in_range(iteration: int, iter_range) -> bool:
    """(start, end]; an absent range is always on."""
    if not iter_range or len(iter_range) != 2:
        return True
    start = 0 if iter_range[0] is None else iter_range[0]
    end = int(1e7) if iter_range[1] is None else iter_range[1]
    return start < iteration <= end


def loss_flags(it: int, lc: dict, view) -> dict:
    def on(name, rng):
        return bool(lc.get(f"lambda_{name}")) and in_range(it, lc.get(rng))
    flags = {"rgb": on("dssim", "rgb_range"), "alpha": on("alpha", "alpha_range"),
             "norm": on("norm", "norm_range") and view.get("normal") is not None,
             "norm_smooth": on("norm_smooth", "norm_smooth_range"),
             "no_sh": on("no_sh", "rgb_no_sh_range"),
             "depth": on("depth", "depth_range"),
             "norm_reg": on("norm_reg", "norm_reg_range"),
             "opacity_reg": on("opacity_reg", "opacity_reg_range"),
             "inverse": on("inverse", "inverse_range")}
    for k in UNSUPPORTED:
        if flags[k]:
            raise NotImplementedError(f"the reference has no {k} loss")
    return flags


def stage3_loss(out: dict, view: dict, lc: dict, flags: dict):
    gt, gt_alpha = view["image"], view["alpha"]
    d = float(lc.get("lambda_dssim") or 0.0)
    loss = torch.zeros((), device=gt.device)
    if flags["rgb"]:
        loss = loss + ((1.0 - d) * l1_loss(out["image"], gt)
                       + d * (1.0 - ssim(out["image"], gt)))
    if flags["alpha"]:
        loss = loss + float(lc["lambda_alpha"]) * l1_loss(out["alpha"], gt_alpha)
    if flags["norm"]:
        loss = loss + float(lc["lambda_norm"]) * norm_loss(
            out["norm"], view["normal"], gt_alpha)
    if flags["norm_smooth"]:
        loss = loss + float(lc["lambda_norm_smooth"]) * smooth_loss(
            gt, out["norm"], gt_alpha)
    if flags["no_sh"]:
        ns = out["image_no_sh"]
        loss = loss + float(lc["lambda_no_sh"]) * (
            (1.0 - d) * l1_loss(ns, gt) + d * (1.0 - ssim(ns, gt)))
    return loss


# -------------------------------------------------------- optimiser
def expon_lr(lr_init, lr_final, delay_mult, max_steps, step):
    if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
        return 0.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


def warmup_multistep(base_lr, milestones, gamma, step, warmup=100,
                     start_factor=0.01):
    warm = (start_factor + (1.0 - start_factor) * (step / warmup)
            if step < warmup else 1.0)
    return base_lr * warm * gamma ** sum(1 for m in milestones if step >= m)


class Trainer:
    """The stage-3 training step on a reference state, with the three
    Adams' moments and counts (``opt``: leaf -> (mu, nu, count))."""

    def __init__(self, state: dict, opt: dict, hyper: dict, cfg: dict):
        self.state = {k: v.detach().clone() for k, v in state.items()}
        self.opt = {k: (mu.clone(), nu.clone(), c) for k, (mu, nu, c)
                    in opt.items()}
        self.active_sh = int(hyper["active_sh_degree"])
        self.uv_steps = int(hyper["uv_step_count"])
        self.extent = float(hyper["spatial_lr_scale"])
        self.cfg = cfg
        self.bg = None

    def lrs(self, it: int):
        oc, tc = self.cfg["optim_cfg"], self.cfg["train_cfg"]
        r = oc.get("gaussian_optim_range")
        g0 = int(r[0]) if r and r[0] is not None else 0
        g_iter = max(it - g0, 0)
        gauss_on = bool(r) and in_range(it, r)
        reset = bool(gauss_on and tc.get("min_scale_reset_interval")
                     and g_iter % int(tc["min_scale_reset_interval"]) == 0)
        lr = {"xyz": expon_lr(oc["position_lr_init"] * self.extent,
                              oc["position_lr_final"] * self.extent,
                              oc["position_lr_delay_mult"],
                              oc["position_lr_max_steps"], g_iter),
              "opacity": oc["opacity_lr"],
              "scaling": 0.0 if reset else oc["scaling_lr"],
              "rotation": oc["rotation_lr"], "shs": oc["tex_lr"] / 20.0,
              "texture": oc["tex_lr"]}
        uv = warmup_multistep(oc["uv_net_lr"], oc["uv_net_milestones"],
                              oc["uv_net_gamma"], self.uv_steps)
        inv = warmup_multistep(oc["inv_uv_net_lr"], oc["uv_net_milestones"],
                               oc["uv_net_gamma"], self.uv_steps)
        uv_on = in_range(it, oc.get("uv_optim_range"))
        tex_on = in_range(it, oc.get("tex_optim_range"))
        out = {}
        for k in self.state:
            if k in GAUSS_KEYS:
                out[k] = lr[k] if gauss_on else None
            elif k == "texture":
                out[k] = lr[k] if tex_on else None
            else:
                out[k] = (inv if k.startswith("inv_uv_net.") else uv) \
                    if uv_on else None
        return out, gauss_on, g_iter

    def step(self, it: int, view: dict, bg, m: int):
        """One iteration: render, loss, backward, Adam, bookkeeping.
        Returns the loss and the rendered outputs (detached)."""
        lc = self.cfg["loss_cfg"]
        flags = loss_flags(it, lc, view)
        lrs, gauss_on, g_iter = self.lrs(it)
        leaves = {k: v.requires_grad_(True) for k, v in self.state.items()}
        with torch.enable_grad():
            out = render_state(leaves, view["cam"], self.active_sh, bg, m,
                               with_no_sh=flags["no_sh"])
            loss = stage3_loss(out, view, lc, flags)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        with torch.no_grad():
            for (k, p), g in zip(leaves.items(), grads):
                p.requires_grad_(False)
                if lrs[k] is None:
                    continue
                g = torch.zeros_like(p) if g is None else g
                mu, nu, c = self.opt[k]
                c += 1
                mu.mul_(BETA1).add_((1 - BETA1) * g)
                nu.mul_(BETA2).add_((1 - BETA2) * (g * g))
                p.sub_(lrs[k] * (mu / (1 - BETA1 ** c))
                       / (torch.sqrt(nu / (1 - BETA2 ** c)) + EPS))
                self.opt[k] = (mu, nu, c)
            tc = self.cfg["train_cfg"]
            if gauss_on:
                ri = tc.get("min_scale_reset_interval")
                if ri and g_iter % int(ri) == 0:
                    s = self.state["scaling"]
                    s.scatter_(1, torch.argmin(s, dim=1, keepdim=True), -20.0)
                    self.opt["scaling"][0].zero_()
                    self.opt["scaling"][1].zero_()
                if g_iter % 2000 == 0 and self.active_sh < 3:
                    self.active_sh += 1
            if in_range(it, self.cfg["optim_cfg"].get("uv_optim_range")):
                self.uv_steps += 1
        return loss.detach(), {k: v.detach() for k, v in out.items()}, grads
