"""Scene readers: COLMAP, Blender (NeRF-synthetic) and NeILF (DTU), and the
records they fill (port of texgs/data/readers.py).

Each reader returns a ``SceneInfo`` whose ``CameraInfo`` records hold float
numpy arrays (H, W, C) in [0, 1]; ``data/scene.py`` turns them into
cameras.  Images are decoded by PIL, which is what imageio's v2 reader
(texgs's) uses for 8-bit PNG and JPEG, so the arrays are texgs's bit for
bit; float32 TIFF depths read as PIL mode ``F``, PFM normals with numpy.
COLMAP binaries and PLY clouds go through the native library where it is
built (data/native.py), else through the Python parsers.
"""

from __future__ import annotations

import glob
import json
import os
import re
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

from texgs_torch.utils.graphics import (BasicPointCloud, focal2fov, fov2focal,
                                        get_nerf_pp_norm, get_world2view,
                                        qvec2rotmat)
from texgs_torch.utils.sh import C0


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray
    T: np.ndarray
    FovY: float
    FovX: float
    image: np.ndarray              # (H, W, 3) float in [0, 1]
    image_path: str
    image_name: str
    width: int
    height: int
    normal: Optional[np.ndarray] = None  # (H, W, 3) in [0, 1] (0.5*(n+1))
    alpha: Optional[np.ndarray] = None   # (H, W) float in [0, 1]
    depth: Optional[np.ndarray] = None   # (H, W) float


class SceneInfo(NamedTuple):
    point_cloud: Optional[BasicPointCloud]
    train_cameras: list
    test_cameras: list
    nerf_normalization: dict
    ply_path: Optional[str]


def _nerfpp_norm_from_infos(cam_infos) -> dict:
    centers = [np.linalg.inv(get_world2view(c.R, c.T))[:3, 3]
               for c in cam_infos]
    return get_nerf_pp_norm(np.stack(centers))


def load_img(path: str) -> np.ndarray:
    """LDR image -> float (H, W, C) in [0, 1].  A path without an extension
    takes the first file that starts with it."""
    from PIL import Image

    if "." not in os.path.basename(path):
        files = glob.glob(path + ".*")
        assert files, f"no image file found for {path}"
        path = files[0]
    with Image.open(path) as im:
        if im.mode == "P":
            # imageio's pillow reader expands a palette the same way
            im = im.convert("RGBA" if "transparency" in im.info else "RGB")
        img = np.asarray(im, np.float32)
    return img / 255.0


def load_mask(path: str) -> np.ndarray:
    """Binary mask of a grayscale PNG: raw values > 0.1."""
    from PIL import Image

    with Image.open(path) as im:
        m = np.asarray(im.convert("L"))
    return (m > 0.1).astype(np.float32)


def load_pfm(path: str) -> np.ndarray:
    """Portable float map (the DTU normals), vertically flipped."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError("not a PFM file")
        dims = re.match(rb"^(\d+)\s(\d+)\s*$", f.readline())
        if not dims:
            raise ValueError("malformed PFM header")
        width, height = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
        shape = (height, width, 3) if color else (height, width)
        data = data.reshape(shape)[::-1]
    return np.ascontiguousarray(data)


def load_depth(path: str) -> np.ndarray:
    """A float32 TIFF depth map (PIL mode ``F``)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im, np.float32)


# ----------------------------------------------------------------- COLMAP

def read_colmap_scene(path: str, images: Optional[str], eval_split: bool,
                      llffhold: int = 8, log=None, debug: bool = False
                      ) -> SceneInfo:
    """COLMAP sparse/0 (binary, else text) with an optional ../masks folder
    beside the images; with ``eval_split`` every ``llffhold``-th image (by
    name) is a test view."""
    from texgs_torch.data import colmap as cm
    from texgs_torch.data import native
    from texgs_torch.io import ply as plyio

    sparse = os.path.join(path, "sparse/0")
    extr = intr = None
    if os.path.exists(os.path.join(sparse, "images.bin")):
        extr = native.read_images_binary(os.path.join(sparse, "images.bin"))
        intr = native.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    if extr is None or intr is None:
        try:
            extr = cm.read_images_binary(os.path.join(sparse, "images.bin"))
            intr = cm.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
        except FileNotFoundError:
            extr = cm.read_images_text(os.path.join(sparse, "images.txt"))
            intr = cm.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    folder = os.path.join(path, images if images else "images")

    infos = []
    for key in extr:
        im = extr[key]
        cam = intr[im.camera_id]
        if cam.model == "SIMPLE_PINHOLE":
            fovx = focal2fov(cam.params[0], cam.width)
            fovy = focal2fov(cam.params[0], cam.height)
        elif cam.model == "PINHOLE":
            fovx = focal2fov(cam.params[0], cam.width)
            fovy = focal2fov(cam.params[1], cam.height)
        else:
            raise AssertionError(
                "only undistorted COLMAP models supported (SIMPLE_PINHOLE / "
                "PINHOLE)")
        R = qvec2rotmat(im.qvec).T
        T = np.array(im.tvec)
        image_path = os.path.join(folder, os.path.basename(im.name))
        image_name = os.path.basename(image_path).split(".")[0]
        img = load_img(image_path)[..., :3]
        mask_path = os.path.join(folder, "../masks", image_name + ".png")
        alpha = None
        if os.path.exists(mask_path):
            alpha = load_mask(mask_path)
            img = img * alpha[..., None]
        infos.append(CameraInfo(
            uid=cam.id, R=R, T=T, FovY=fovy, FovX=fovx, image=img,
            image_path=image_path, image_name=image_name,
            width=cam.width, height=cam.height, alpha=alpha))

    infos.sort(key=lambda c: c.image_name)
    if eval_split:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []
    if debug:
        train, test = train[:5], test[:5]

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = cm.read_points3d_binary(
                os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = cm.read_points3d_text(
                os.path.join(sparse, "points3D.txt"))
        plyio.write_ply_xyz(ply_path, xyz, colors=rgb,
                            normals=np.zeros_like(xyz))
    pcd = plyio.read_pcd(ply_path)

    return SceneInfo(point_cloud=pcd, train_cameras=train, test_cameras=test,
                     nerf_normalization=_nerfpp_norm_from_infos(train),
                     ply_path=ply_path)


# ---------------------------------------------------------------- Blender

def _read_transforms(path: str, transformsfile: str, background,
                     extension: str = ".png", debug: bool = False):
    """NeRF-synthetic cameras with their ``_normal`` and ``_alpha``
    companion images."""
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    bg = np.asarray(background, np.float32)

    infos = []
    for idx, frame in enumerate(contents["frames"]):
        if debug and idx > 5:
            break
        image_path = os.path.join(path, frame["file_path"] + extension)
        normal_path = os.path.join(path, frame["file_path"] + "_normal" + extension)
        alpha_path = os.path.join(path, frame["file_path"] + "_alpha" + extension)

        c2w = np.array(frame["transform_matrix"], np.float64)
        # OpenGL/Blender (Y up, Z back) -> COLMAP (Y down, Z forward)
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        R = w2c[:3, :3].T
        T = w2c[:3, 3]

        data = load_img(image_path)
        if data.shape[-1] == 4:
            rgb = data[..., :3] * data[..., 3:4] + bg * (1 - data[..., 3:4])
            file_alpha = data[..., 3]
        else:
            rgb, file_alpha = data[..., :3], None

        normal = load_img(normal_path)[..., :3] if os.path.exists(normal_path) else None
        if os.path.exists(alpha_path):
            alpha = (load_img(alpha_path)[..., 0] > 0).astype(np.float32)
        elif normal is not None:
            # alpha from the normal's length
            nd = normal * 2.0 - 1.0
            alpha = (np.linalg.norm(nd, axis=-1) > 0.5).astype(np.float32)
        elif file_alpha is not None:
            alpha = (file_alpha > 0).astype(np.float32)
        else:
            alpha = None

        h, w = rgb.shape[:2]
        fovy = focal2fov(fov2focal(fovx, w), h)
        infos.append(CameraInfo(
            uid=idx, R=R, T=T, FovY=fovy, FovX=fovx, image=rgb,
            image_path=image_path, image_name=Path(image_path).stem,
            width=w, height=h, normal=normal, alpha=alpha))
    return infos


def read_blender_scene(path: str, background, eval_split: bool,
                       extension: str = ".png", log=None,
                       debug: bool = False) -> SceneInfo:
    """transforms_train.json (and transforms_test.json); without a
    points3d.ply, a random 100k-point cloud from numpy's global RNG, drawn
    in texgs's order so one ``np.random.seed`` gives one cloud in both."""
    from texgs_torch.io import ply as plyio

    train = _read_transforms(path, "transforms_train.json", background,
                             extension, debug)
    test_file = os.path.join(path, "transforms_test.json")
    test = (_read_transforms(path, "transforms_test.json", background,
                             extension, debug)
            if os.path.exists(test_file) else [])
    if not eval_split:
        train = train + test
        test = []

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        if log:
            log.info(f"Generating random point cloud ({num_pts})...")
        xyz = np.random.random((num_pts, 3)) * 2.6 - 1.3
        colors = np.random.random((num_pts, 3)) / 255.0 * C0 + 0.5
        plyio.write_ply_xyz(ply_path, xyz, colors=colors,
                            normals=np.zeros_like(xyz))
    pcd = plyio.read_pcd(ply_path)

    return SceneInfo(point_cloud=pcd, train_cameras=train, test_cameras=test,
                     nerf_normalization=_nerfpp_norm_from_infos(train),
                     ply_path=ply_path)


# ------------------------------------------------------------------ NeILF

def read_neilf_scene(path: str, background, eval_split: bool, log=None,
                     debug: bool = False) -> SceneInfo:
    """NeILF/DTU: inputs/sfm_scene.json with per-view depth (TIFF), normal
    (PFM) and mask (PNG), rescaled into the bbox frame; the test views are
    DTU's fixed indexes [6, 13, 30, 35]."""
    from texgs_torch.io import ply as plyio

    validation_indexes = []
    if eval_split:
        if "dtu" in path.lower():
            validation_indexes = [6, 13, 30, 35]
        else:
            raise NotImplementedError("NeILF eval split only defined for DTU")

    inputs = os.path.join(path, "inputs")
    with open(os.path.join(inputs, "sfm_scene.json")) as f:
        sfm = json.load(f)

    bbox_transform = np.array(sfm["bbox"]["transform"]).reshape(4, 4).copy()
    diag = bbox_transform[[0, 1, 2], [0, 1, 2]]
    bbox_transform[[0, 1, 2], [0, 1, 2]] = diag.max() / 2
    bbox_inv = np.linalg.inv(bbox_transform)

    image_list = sfm["image_path"]["file_paths"]
    train, test = [], []
    for i, (index, cam_info) in enumerate(sfm["camera_track_map"]["images"].items()):
        if debug and i >= 5:
            break
        if cam_info["flg"] != 2:
            continue
        extrinsic = np.array(cam_info["camera"]["extrinsic"]).reshape(4, 4)
        c2w = np.linalg.inv(extrinsic)
        c2w[:3, 3] = (c2w[:4, 3] @ bbox_inv.T)[:3]
        extrinsic = np.linalg.inv(c2w)
        R = extrinsic[:3, :3].T
        T = extrinsic[:3, 3]
        focal = cam_info["camera"]["intrinsic"]["focal"]

        image_path = os.path.join(inputs, image_list[index])
        base = os.path.basename(image_list[index])
        ext = os.path.splitext(image_list[index])[-1]
        img = load_img(image_path)[..., :3]

        depth_path = os.path.join(inputs, "depths", base.replace(ext, ".tiff"))
        depth = load_depth(depth_path) * bbox_inv[0, 0] \
            if os.path.exists(depth_path) else None
        normal_path = os.path.join(inputs, "normals", base.replace(ext, ".pfm"))
        normal = load_pfm(normal_path) if os.path.exists(normal_path) else None
        mask_path = os.path.join(inputs, "pmasks", base.replace(ext, ".png"))
        mask = load_mask(mask_path) if os.path.exists(mask_path) \
            else np.ones(img.shape[:2], np.float32)

        img = img * mask[..., None]
        is_test = int(index) in validation_indexes
        if not is_test:
            if depth is not None:
                depth = depth * mask
            if normal is not None:
                normal = normal * mask[..., None]
        if normal is not None:
            normal = (normal + 1.0) / 2.0  # stored in [0, 1] like image files

        h, w = img.shape[:2]
        info = CameraInfo(
            uid=int(index), R=R, T=T,
            FovY=focal2fov(focal[1], h), FovX=focal2fov(focal[0], w),
            image=img, image_path=image_path, image_name=Path(image_path).stem,
            width=w, height=h, alpha=mask, normal=normal, depth=depth)
        (test if is_test else train).append(info)

    # the sparse cloud, rescaled into the bbox frame
    ply_path = os.path.join(inputs, "model", "sparse_bbx_scale.ply")
    if not os.path.exists(ply_path):
        org = plyio.read_pcd(os.path.join(inputs, "model", "sparse.ply"))
        pts = np.concatenate([org.points, np.ones_like(org.points[:, :1])],
                             axis=-1)
        xyz = (pts @ bbox_inv.T)[:, :3]
        plyio.write_ply_xyz(ply_path, xyz, colors=org.colors,
                            normals=org.normals)
    pcd = plyio.read_pcd(ply_path)

    return SceneInfo(point_cloud=pcd, train_cameras=train, test_cameras=test,
                     nerf_normalization=_nerfpp_norm_from_infos(train),
                     ply_path=ply_path)
