"""Procedural dataset: ground truth rendered from a known Gaussian scene
(port of texgs/data/synthetic_scene.py).

``data_root_dir: synthetic://blob?n=4096&views=16&size=128`` produces an
in-memory SceneInfo whose images, alpha masks and normals are renders of a
known Gaussian cloud.  texgs renders them with its dense oracle; the port
has no oracle and renders them with its own ``render`` (kernel 1 on the
card), so images agree with texgs's at the oracle-vs-tiled tolerance of
tests/test_rasterizer.py.
"""

from __future__ import annotations

from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from texgs_torch.core.state import init_from_pcd
from texgs_torch.data.readers import (CameraInfo, SceneInfo,
                                      _nerfpp_norm_from_infos)
from texgs_torch.data.synthetic import (blob_point_cloud, orbit_cameras,
                                        sphere_point_cloud)
from texgs_torch.render.render import render
from texgs_torch.utils.graphics import BasicPointCloud


@torch.no_grad()
def make_synthetic_scene_info(uri: str, cfg, debug: bool = False,
                              device="cuda") -> SceneInfo:
    parsed = urlparse(uri)
    kind = parsed.netloc or "blob"
    q = {k: v[0] for k, v in parse_qs(parsed.query).items()}
    n = int(q.get("n", 4096))
    views = int(q.get("views", 16))
    size = int(q.get("size", 128))
    seed = int(q.get("seed", 0))
    if debug:
        views = min(views, 6)

    pcd = (sphere_point_cloud(n, seed=seed) if kind == "sphere"
           else blob_point_cloud(n, seed=seed))
    gt = init_from_pcd(pcd.points, pcd.colors, max_sh_degree=0, device=device)
    # opacity logit 4 so the target object is solid
    gt.opacity = torch.full_like(gt.opacity, 4.0)
    bg = torch.as_tensor(cfg.get_or("background", [0, 0, 0]),
                         dtype=torch.float32, device=device)

    infos = []
    for cam in orbit_cameras(views, radius=3.5, width=size, height=size):
        out = render(cam, xyz=gt.xyz, opacity=gt.get_opacity(),
                     scaling=gt.get_scaling(), rotation=gt.get_rotation(),
                     features=gt.get_features(), active_sh_degree=0,
                     bg_color=bg)
        image = np.clip(out["render"].cpu().numpy().transpose(1, 2, 0), 0, 1)
        alpha = out["alpha"][0].cpu().numpy()
        normal = np.clip(0.5 * (out["norm"].cpu().numpy().transpose(1, 2, 0)
                                + 1), 0, 1)
        # (R, T) from the orbit camera's row-vector world_view
        w2c = np.asarray(cam.world_view).T
        infos.append(CameraInfo(
            uid=cam.uid, R=w2c[:3, :3].T, T=w2c[:3, 3],
            FovY=cam.fovy, FovX=cam.fovx, image=image,
            image_path=f"synthetic/{cam.image_name}",
            image_name=cam.image_name, width=cam.width, height=cam.height,
            alpha=(alpha > 0.5).astype(np.float32), normal=normal))

    n_test = max(1, views // 8)
    train, test = infos[n_test:], infos[:n_test]

    # init cloud: a noisy subsample of the true surface (the SfM cloud's role)
    rng = np.random.default_rng(seed + 1)
    sel = rng.choice(n, size=min(n, 1024), replace=False)
    noisy = pcd.points[sel] + rng.normal(scale=0.02, size=(len(sel), 3))
    init_pcd = BasicPointCloud(points=noisy.astype(np.float32),
                               colors=pcd.colors[sel],
                               normals=pcd.normals[sel])
    return SceneInfo(point_cloud=init_pcd, train_cameras=train,
                     test_cameras=test,
                     nerf_normalization=_nerfpp_norm_from_infos(train),
                     ply_path=None)
