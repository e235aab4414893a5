"""Plain PyTorch stage-2 model: the frozen Gaussians' depth and alpha, the
inverse loss's surface points, the UV net and the inverse net with its
multiresolution hash encode, the three published losses, their gradients
by autograd and the Adam step with the UV nets' schedule.

Follows Texture-GS's UV-mapping stage (Xu et al., "Texture-GS", ECCV
2024, arXiv 2403.10050; configs/uv_map.yaml) as the port documents it:
texgs_torch/train/uv_map_gaussian3d.py (``loss_terms``, ``compute_loss``),
texgs_torch/nets/uv_net.py, the equations of
texgs_torch/nets/hash_encode.py, texgs_torch/kernels/chamfer.py
(pytorch3d's chamfer semantics), texgs_torch/train/optim.py and
texgs_torch/utils/schedules.py.  The frozen render is the stage-1
reference's projection, binning and blend with zero colours.  Float32,
TF32 off (the caller's settings: ``benchmark.run`` turns TF32 off).  A
state is a dict of tensors named as the program's Adam names its leaves
("uv_net.mlp.w.0", "inv_uv_net.hashgrid.table", "geo_emb"), the MLP
weights in (out, in) layout.

Departures from the published model (each also the port's and texgs's):
  - the hash table is float32; tiny-cuda-nn's HashGrid keeps its
    parameters in float16;
  - every level is hashed; tiny-cuda-nn indexes a level densely where its
    grid has no more points than the table has rows (the coarsest level
    here: 16^3 = 4,096 rows), and hashes only the finer ones;
  - grid positions are x * resolution, with no half-cell offset, and the
    level resolutions floor(16 * 1.447^l);
  - the world points unproject the depth through the float32 inverse of
    the camera's full projection, as Texture-GS's ``depth2world`` does.
Not here: the directional-cap chamfer (its gate raises: the published
configuration gives it no weight).  Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import render as R
from benchmark.reference import stage1 as ref1
from benchmark.reference import stage3 as S

BASE_RESOLUTION, PER_LEVEL_SCALE = 16, 1.447
PRIMES = (1, 2654435761, 805459861)
U32 = 0xFFFFFFFF
CHAMFER_BLOCK = 256
ZNEAR, ZFAR = 0.01, 100.0   # the cameras' clip planes (benchmark/scene.py's)


# ------------------------------------------------------ frozen render
def frozen_render(gauss: dict, cam: R.Cam, bg) -> dict:
    """Depth (normalised by alpha) and alpha of the frozen Gaussians
    (``xyz``, ``opacity``, ``scaling``, ``rotation``, raw) from ``cam``."""
    opacity, scaling, rot = ref1.geometry(gauss)
    proj = R.project(gauss["xyz"], scaling, rot, opacity, cam)
    table = R.gauss_table(proj, torch.zeros_like(gauss["xyz"]))
    h, w = cam.height, cam.width
    pairs = R.build_pairs(proj.means2d, proj.depths, proj.radii, h, w)
    out, t_final, _ = ref1.blend(table, pairs, R.grid_shape(h, w)[1])
    img = R.tiles_to_image(out, h, w)
    alpha = 1.0 - R.tiles_to_image(t_final[..., None], h, w)
    return {"depth": img[3:4] / torch.clamp(alpha, min=1e-6), "alpha": alpha}


def depth2world(depth, cam: R.Cam):
    """(H, W) view-z depth -> (H * W, 3) world points: clip = [ndc_x d,
    ndc_y d, zclip(d), d] at each pixel centre, times the inverse of the
    row-vector full projection."""
    h, w = depth.shape
    dev = depth.device
    ndc_x = (torch.arange(w, device=dev, dtype=torch.float32) * 2 + 1) / w - 1
    ndc_y = (torch.arange(h, device=dev, dtype=torch.float32) * 2 + 1) / h - 1
    ndc_y, ndc_x = torch.meshgrid(ndc_y, ndc_x, indexing="ij")
    zf, zn = ZFAR, ZNEAR
    zclip = zf * depth / (zf - zn) - zf * zn / (zf - zn)
    clip = torch.stack([ndc_x * depth, ndc_y * depth, zclip, depth], -1)
    inv = torch.linalg.inv(torch.as_tensor(cam.full_proj, device=dev))
    return (clip.reshape(-1, 4) @ inv)[:, :3]


def view_points(gauss: dict, cam: R.Cam, bg):
    """(points (M, 3), mask (H * W,)): the world points of the pixels with
    alpha > 0.5, in pixel order, and that mask."""
    fr = frozen_render(gauss, cam, bg)
    mask = fr["alpha"].reshape(-1) > 0.5
    return depth2world(fr["depth"][0], cam)[mask], mask


# ------------------------------------------------------- hash encode
def level_resolution(level: int) -> int:
    return int(math.floor(BASE_RESOLUTION * PER_LEVEL_SCALE ** level))


def spatial_hash(ix, iy, iz, table_size: int):
    """(ix * 1 xor iy * 2654435761 xor iz * 805459861) mod 2^32 mod T, in
    int64: the grid indices here lie in [0, 2^31), so no product leaves
    int64 before its low 32 bits are kept."""
    h = ((ix * PRIMES[0]) & U32) ^ ((iy * PRIMES[1]) & U32) \
        ^ ((iz * PRIMES[2]) & U32)
    return h % table_size


def hash_encode(table, x):
    """(L, T, F) tables and points x (N, 3) in [0, 1] -> (N, L * F): at
    each level, the 8 corners of the point's grid cell hashed into the
    level's table and their rows summed with trilinear weights."""
    n_levels, table_size, n_feat = table.shape
    feats = []
    for level in range(n_levels):
        pos = x * level_resolution(level)
        cell = torch.floor(pos)
        frac = pos - cell
        ic = cell.to(torch.int64)
        acc = torch.zeros(x.shape[0], n_feat, device=x.device)
        for corner in range(8):
            bits = (corner & 1, (corner >> 1) & 1, (corner >> 2) & 1)
            idx = spatial_hash(*(ic[:, a] + bits[a] for a in range(3)),
                               table_size)
            w = torch.ones_like(frac[:, 0])
            for a in range(3):
                w = w * (frac[:, a] if bits[a] else 1 - frac[:, a])
            acc = acc + w[:, None] * table[level][idx]
        feats.append(acc)
    return torch.cat(feats, -1)


# -------------------------------------------------------------- nets
def mlp(state: dict, net: str, part: str, h):
    layers = S._layers(state, net, part)
    for i, (w, b) in enumerate(layers):
        h = h @ w.T + b
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def uv_net(state: dict, xyz):
    """World points -> unit-sphere uvs."""
    h = torch.relu(mlp(state, "uv_net", "pre_mlp", xyz) + state["geo_emb"])
    o = mlp(state, "uv_net", "mlp", h)
    return o / (torch.linalg.norm(o, dim=-1, keepdim=True) + 1e-12)


def inv_uv_net(state: dict, uv):
    """Unit-sphere uvs -> world points, through the hash grid of uv / 2 +
    0.5."""
    h = hash_encode(state["inv_uv_net.hashgrid.table"], uv / 2.0 + 0.5)
    h = torch.relu(mlp(state, "inv_uv_net", "pre_mlp", h) + state["geo_emb"])
    return mlp(state, "inv_uv_net", "mlp", h)


# ------------------------------------------------------------ losses
def _min_sq(a, b):
    """Per-point-in-a squared distance to its nearest neighbour in b, from
    the differences themselves, a block of a at a time."""
    return torch.cat([((q[:, None, :] - b[None, :, :]) ** 2).sum(-1)
                      .min(dim=1).values
                      for q in torch.split(a, CHAMFER_BLOCK)])


def chamfer(x, y):
    """pytorch3d's chamfer_distance of two clouds: the mean over x of the
    squared distance to the nearest y, plus the same from y to x."""
    return _min_sq(x, y).mean() + _min_sq(y, x).mean()


def loss_flags(it: int, lc: dict) -> dict:
    def on(name, rng):
        return bool(lc.get(f"lambda_{name}")) and S.in_range(it, lc.get(rng))
    flags = {"inverse": on("inverse", "inverse_range"),
             "chamfer": on("chamfer", "chamfer_range"),
             "inverse2": on("inverse2", "inverse_range2")}
    if on("patch_chamfer", "patch_chamfer_range"):
        raise NotImplementedError("the reference has no patch chamfer")
    return flags


def losses(state: dict, points, sample_uvs, pcd, lc: dict, flags: dict):
    """(total, {term: value}, {"uv", "inv"}: the nets' outputs on the
    points): Linv = sum |x - inv(uv(x))|^2 / (M + 1e-6) over the points,
    Lchamfer = chamfer(inv(s), cloud), Linv2 = mean |uv(inv(s)) - s|^2
    over the sphere samples s."""
    terms, outs = {}, {}
    total = torch.zeros((), device=points.device)
    if flags["inverse"]:
        outs["uv"] = uv_net(state, points)
        outs["inv"] = inv_uv_net(state, outs["uv"])
        terms["Linv"] = (((points - outs["inv"]) ** 2).sum(-1).sum()
                         / (points.shape[0] + 1e-6))
        total = total + float(lc["lambda_inverse"]) * terms["Linv"]
    if flags["chamfer"] or flags["inverse2"]:
        sample_inv = inv_uv_net(state, sample_uvs)
    if flags["chamfer"]:
        terms["Lchamfer"] = chamfer(sample_inv, pcd)
        total = total + float(lc["lambda_chamfer"]) * terms["Lchamfer"]
    if flags["inverse2"]:
        terms["Linv2"] = ((uv_net(state, sample_inv) - sample_uvs) ** 2
                          ).sum(-1).mean()
        total = total + float(lc["lambda_inverse2"]) * terms["Linv2"]
    return total, terms, outs


# ---------------------------------------------------------- the step
class Trainer:
    """The stage-2 training step on a reference state, with the Adam's
    moments and counts (``opt``: leaf -> (mu, nu, count)) and the
    schedule's step count."""

    def __init__(self, state: dict, opt: dict, hyper: dict, cfg: dict, pcd):
        self.state = {k: v.detach().clone() for k, v in state.items()}
        self.opt = {k: (mu.clone(), nu.clone(), c) for k, (mu, nu, c)
                    in opt.items()}
        self.step_count = int(hyper["step_count"])
        self.cfg, self.pcd = cfg, pcd

    def lrs(self) -> dict:
        oc = self.cfg["optim_cfg"]
        uv = S.warmup_multistep(oc["uv_net_lr"], oc["uv_net_milestones"],
                                oc["uv_net_gamma"], self.step_count)
        inv = S.warmup_multistep(oc["inv_uv_net_lr"], oc["uv_net_milestones"],
                                 oc["uv_net_gamma"], self.step_count)
        return {k: inv if k.startswith("inv_uv_net.") else uv
                for k in self.state}

    def step(self, it: int, points, sample_uvs):
        """One iteration on the view's masked ``points`` and the step's
        sphere samples.  Returns the loss, its terms and the nets' outputs
        on the points (detached), and each leaf's gradient."""
        lc = self.cfg["loss_cfg"]
        flags = loss_flags(it, lc)
        leaves = {k: v.requires_grad_(True) for k, v in self.state.items()}
        with torch.enable_grad():
            total, terms, outs = losses(leaves, points, sample_uvs, self.pcd,
                                        lc, flags)
            grads = torch.autograd.grad(total, list(leaves.values()),
                                        allow_unused=True)
        lrs = self.lrs()
        with torch.no_grad():
            for (k, p), g in zip(leaves.items(), grads):
                p.requires_grad_(False)
                g = torch.zeros_like(p) if g is None else g
                mu, nu, c = self.opt[k]
                c += 1
                mu.mul_(S.BETA1).add_((1 - S.BETA1) * g)
                nu.mul_(S.BETA2).add_((1 - S.BETA2) * (g * g))
                p.sub_(lrs[k] * (mu / (1 - S.BETA1 ** c))
                       / (torch.sqrt(nu / (1 - S.BETA2 ** c)) + S.EPS))
                self.opt[k] = (mu, nu, c)
        self.step_count += 1
        return (total.detach(), {k: v.detach() for k, v in terms.items()},
                {k: v.detach() for k, v in outs.items()}, grads)
