"""Extract a pseudo ground-truth surface cloud from a stage-1 checkpoint
(port of texgs/tools/extract_pcd.py).

Loads the stage-1 Gaussians, farthest-point-samples their centres down to
``num_points`` (default 16384) and saves ``<out>.npy`` and ``<out>.ply``:
the chamfer target of stage 2.

    python -m texgs_torch.tools.extract_pcd <checkpoint> [--num_points N]
        [--out PATH] [--device cuda|cpu]
"""

from __future__ import annotations

import os

import numpy as np
import torch


def extract_pcd(ckpt_path: str, out_path: str, num_points: int = 16384,
                log=None, device="cuda") -> np.ndarray:
    from texgs_torch.io import checkpoint as ckpt
    from texgs_torch.io.ply import write_ply_xyz
    from texgs_torch.kernels.chamfer import farthest_point_sampling

    p = ckpt.load(ckpt_path)[0]["params"]
    n_alive = int(np.asarray(p["n_alive"]))
    xyz = torch.as_tensor(np.asarray(p["xyz"], np.float32)[:n_alive],
                          device=device)
    if log:
        log.info(f"FPS downsampling {n_alive} -> {num_points} points")
    idx = farthest_point_sampling(xyz, min(num_points, n_alive))
    pts = xyz[idx].cpu().numpy()

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    base = out_path[:-4] if out_path.endswith((".npy", ".ply")) else out_path
    np.save(base + ".npy", pts)
    write_ply_xyz(base + ".ply", pts)
    return pts


def main(argv=None):
    from argparse import ArgumentParser

    from texgs_torch.utils.logger import get_logger

    parser = ArgumentParser(description="Extract a pseudo ground-truth "
                            "point cloud from a stage-1 checkpoint")
    parser.add_argument("ckpt", help="stage-1 checkpoint path")
    parser.add_argument("--num_points", type=int, default=16384)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    out = args.out or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(args.ckpt))), "pcd")
    extract_pcd(args.ckpt, out, args.num_points, get_logger(), args.device)


if __name__ == "__main__":
    main()
