"""Write a procedural scene to disk in Blender (NeRF-synthetic), COLMAP or
NeILF (DTU) layout (port of scripts/make_synthetic_dataset.py):

    python -m texgs_torch.tools.make_dataset out_dir [--kind blob]
        [--n 4096] [--views 64] [--test_views 8] [--size 400]
        [--width W] [--height H] [--spiral] [--backend reference]
        [--format blender|colmap|neilf] [--seed 0] [--init_ply]
        [--device cuda|cpu]

The ground truth is rendered by the port's ``render``, one call a view, of
the kind's point cloud at opacity logit 4.0 and SH degree 0 on a black
background: ``--backend reference`` (the default) is the dense oracle,
``scan`` and ``pallas`` the tiled path (kernel 1 on the card).  The files
are those of the script: RGBA, ``_normal`` and ``_alpha`` PNGs with
``transforms_{train,test}.json``; COLMAP ``sparse/0`` binaries (PINHOLE)
with ``images/``; or NeILF's ``inputs/sfm_scene.json`` with ``images``,
``pmasks``, float32 TIFF ``depths`` and PFM ``normals``.  Images go
through PIL, PLYs through ``io/ply.py``.  It runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import json
import math
import os
from argparse import ArgumentParser

import numpy as np

KINDS = ("blob", "sphere", "checker")


def parse_args(argv=None):
    parser = ArgumentParser(description="texgs_torch: write a procedural "
                            "scene to disk")
    parser.add_argument("out_dir")
    parser.add_argument("--kind", default="blob", choices=list(KINDS))
    parser.add_argument("--n", type=int, default=4096)
    parser.add_argument("--views", type=int, default=64)
    parser.add_argument("--test_views", type=int, default=8)
    parser.add_argument("--size", type=int, default=400)
    parser.add_argument("--width", type=int, default=0,
                        help="image width (default: --size, square)")
    parser.add_argument("--height", type=int, default=0)
    parser.add_argument("--spiral", action="store_true",
                        help="spiral orbit (elevation sweep) instead of a "
                             "single ring")
    parser.add_argument("--backend", default="reference",
                        choices=["reference", "scan", "pallas"],
                        help="ground-truth renderer: 'reference' = the dense "
                             "oracle (small scenes); 'scan'/'pallas' = the "
                             "tiled path (production shapes)")
    parser.add_argument("--format", default="blender",
                        choices=["blender", "neilf", "colmap"],
                        help="on-disk layout; the NeILF test split is DTU's "
                             "fixed indexes [6, 13, 30, 35] when out_dir's "
                             "name holds 'dtu', COLMAP's every 8th image")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--init_ply", action="store_true",
                        help="also write the true cloud as points3d.ply "
                             "(else the Blender reader draws a random "
                             "100k-point one)")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def write_png(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(arr).save(path)


def write_pfm(path: str, data: np.ndarray) -> None:
    """Little-endian PFM, vertically flipped (``readers.load_pfm``)."""
    data = np.asarray(data, np.float32)
    color = data.ndim == 3 and data.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        data[::-1].astype("<f").tofile(f)


def write_tiff(path: str, depth: np.ndarray) -> None:
    """A float32 TIFF (PIL mode ``F``), as ``readers.load_depth`` reads."""
    from PIL import Image

    Image.fromarray(np.asarray(depth, np.float32)).save(path)


def intrinsics(cam):
    return (cam.width / (2 * math.tan(cam.fovx / 2)),
            cam.height / (2 * math.tan(cam.fovy / 2)))


def write_neilf(out_dir, cams, gt_view, pcd) -> None:
    """inputs/sfm_scene.json + images/ + depths/*.tiff + normals/*.pfm +
    pmasks/*.png + model/sparse.ply.  All views share one index space; the
    reader's DTU indexes pick the test views."""
    from texgs_torch.io import ply as plyio

    inputs = os.path.join(out_dir, "inputs")
    for sub in ("images", "depths", "normals", "pmasks", "model"):
        os.makedirs(os.path.join(inputs, sub), exist_ok=True)

    # diagonal 2: the reader's max/2 rule makes bbox_inv the identity (the
    # scene is unit-scale already), so depths and points pass unchanged
    bbox = {"transform": [2.0, 0, 0, 0, 0, 2.0, 0, 0,
                          0, 0, 2.0, 0, 0, 0, 0, 1.0]}
    file_paths, images_map = {}, {}
    for i, cam in enumerate(cams):
        out = gt_view(cam)
        name = f"{i:06d}"
        write_png(os.path.join(inputs, "images", name + ".png"),
                  (out["rgb"] * 255).astype(np.uint8))
        write_png(os.path.join(inputs, "pmasks", name + ".png"),
                  ((out["alpha"] > 0.5) * 255).astype(np.uint8))
        write_pfm(os.path.join(inputs, "normals", name + ".pfm"),
                  np.clip(out["norm"], -1, 1))
        write_tiff(os.path.join(inputs, "depths", name + ".tiff"),
                   out["depth"])

        w2c = np.asarray(cam.world_view, np.float64).T  # row-vector -> standard
        file_paths[str(i)] = f"images/{name}.png"
        images_map[str(i)] = {
            "flg": 2,
            "camera": {"extrinsic": w2c.reshape(-1).tolist(),
                       "intrinsic": {"focal": list(intrinsics(cam))}},
        }

    with open(os.path.join(inputs, "sfm_scene.json"), "w") as f:
        json.dump({"bbox": bbox,
                   "image_path": {"file_paths": file_paths},
                   "camera_track_map": {"images": images_map}}, f)
    plyio.write_ply_xyz(os.path.join(inputs, "model", "sparse.ply"),
                        pcd.points, colors=pcd.colors,
                        normals=np.zeros_like(pcd.points))


def write_colmap(out_dir, cams, gt_view, pcd) -> None:
    """sparse/0/{cameras,images,points3D}.bin (PINHOLE) + images/."""
    from texgs_torch.data import colmap as cm
    from texgs_torch.utils.graphics import rotmat2qvec

    sparse = os.path.join(out_dir, "sparse", "0")
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(img_dir, exist_ok=True)

    cameras, images = {}, {}
    for i, cam in enumerate(cams):
        name = f"{i:06d}.png"
        write_png(os.path.join(img_dir, name),
                  (gt_view(cam)["rgb"] * 255).astype(np.uint8))
        w2c = np.asarray(cam.world_view, np.float64).T  # row-vector -> standard
        fx, fy = intrinsics(cam)
        cameras[i + 1] = cm.ColmapCamera(
            id=i + 1, model="PINHOLE", width=cam.width, height=cam.height,
            params=np.array([fx, fy, cam.width / 2.0, cam.height / 2.0]))
        images[i + 1] = cm.ColmapImage(
            id=i + 1, qvec=rotmat2qvec(w2c[:3, :3]), tvec=w2c[:3, 3],
            camera_id=i + 1, name=name)

    cm.write_cameras_binary(os.path.join(sparse, "cameras.bin"), cameras)
    cm.write_images_binary(os.path.join(sparse, "images.bin"), images)
    cm.write_points3d_binary(os.path.join(sparse, "points3D.bin"),
                             pcd.points, np.clip(pcd.colors, 0, 1) * 255)


def write_blender(out_dir, cams, gt_view, n_train: int) -> None:
    """transforms_{train,test}.json + {train,test}/r_<i>[_normal|_alpha].png."""
    splits = {"train": cams[:n_train], "test": cams[n_train:]}
    os.makedirs(out_dir, exist_ok=True)
    for split, split_cams in splits.items():
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
        frames = []
        for i, cam in enumerate(split_cams):
            out = gt_view(cam)
            rgb, alpha = out["rgb"], out["alpha"]
            normal = np.clip(0.5 * (out["norm"] + 1), 0, 1)
            name = f"r_{i}"
            rgba = np.concatenate([rgb, alpha[..., None]], axis=-1)
            base = os.path.join(out_dir, split, name)
            write_png(base + ".png", (rgba * 255).astype(np.uint8))
            write_png(base + "_normal.png", (normal * 255).astype(np.uint8))
            write_png(base + "_alpha.png", ((alpha > 0.5)[..., None].repeat(
                3, -1) * 255).astype(np.uint8))

            # camera-to-world in the OpenGL/Blender convention (the reader
            # flips the Y and Z axes back)
            c2w = np.linalg.inv(np.asarray(cam.world_view).T)
            c2w[:3, 1:3] *= -1
            frames.append({"file_path": f"./{split}/{name}",
                           "transform_matrix": c2w.tolist()})

        with open(os.path.join(out_dir, f"transforms_{split}.json"),
                  "w") as f:
            json.dump({"camera_angle_x": cams[0].fovx, "frames": frames}, f,
                      indent=1)


def ground_truth(args):
    """The scene of ``args`` (``parse_args``): its cameras (train, then
    test), a function that renders one of them to float numpy arrays
    (``rgb``, ``alpha``, ``norm``, ``depth``, as they are written before
    8-bit quantisation) and the point cloud."""
    import torch

    from texgs_torch.core.state import init_from_pcd
    from texgs_torch.data.synthetic import (blob_point_cloud, orbit_cameras,
                                            sphere_point_cloud,
                                            textured_sphere_point_cloud)
    from texgs_torch.render.render import render

    makers = {"sphere": sphere_point_cloud,
              "checker": textured_sphere_point_cloud,
              "blob": blob_point_cloud}
    device = torch.device(args.device)
    pcd = makers[args.kind](args.n, seed=args.seed)
    gt = init_from_pcd(pcd.points, pcd.colors, 0, device=device)
    gt.opacity = torch.full_like(gt.opacity, 4.0)
    activated = dict(xyz=gt.xyz, opacity=gt.get_opacity(),
                     scaling=gt.get_scaling(), rotation=gt.get_rotation(),
                     features=gt.get_features())
    bg = torch.zeros(3, device=device)

    cams = orbit_cameras(args.views + args.test_views, radius=3.5, width=args.width or args.size,
                         height=args.height or args.size, spiral=args.spiral)

    @torch.no_grad()
    def gt_view(cam) -> dict:
        out = render(cam, **activated, active_sh_degree=0, bg_color=bg,
                     backend=args.backend)
        return dict(
            rgb=np.clip(out["render"].cpu().numpy().transpose(1, 2, 0), 0, 1),
            alpha=np.clip(out["alpha"][0].cpu().numpy(), 0, 1),
            norm=out["norm"].cpu().numpy().transpose(1, 2, 0),
            depth=out["depth"][0].cpu().numpy())

    return cams, gt_view, pcd


def make_dataset(args) -> int:
    """Render and write the scene of ``args`` (``parse_args``).  Returns
    the number of views written."""
    from texgs_torch.io import ply as plyio

    cams, gt_view, pcd = ground_truth(args)
    if args.format == "neilf":
        write_neilf(args.out_dir, cams, gt_view, pcd)
    elif args.format == "colmap":
        write_colmap(args.out_dir, cams, gt_view, pcd)
    else:
        write_blender(args.out_dir, cams, gt_view, args.views)
        if args.init_ply:
            plyio.write_ply_xyz(os.path.join(args.out_dir, "points3d.ply"),
                                pcd.points, colors=pcd.colors,
                                normals=np.zeros_like(pcd.points))
    return len(cams)


def main(argv=None) -> int:
    args = parse_args(argv)
    total = make_dataset(args)
    layout = {"neilf": " (NeILF format)", "colmap": " (COLMAP format)"}
    print(f"wrote {total} views to {args.out_dir}"
          f"{layout.get(args.format, '')}")
    return total


if __name__ == "__main__":
    main()
