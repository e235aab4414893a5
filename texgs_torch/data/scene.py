"""Scene container: dataset detection, cameras, extents (port of
texgs/data/scene.py).

The data root picks the reader, as texgs's marker files do: a
``synthetic://`` URI is the procedural scene, ``sparse/`` a COLMAP scene,
``transforms_train.json`` a Blender one and ``inputs/sfm_scene.json`` a
NeILF one.  The scene copies the initial cloud to ``input.ply`` and dumps
the cameras as JSON, builds the cameras of each resolution scale with
texgs's resolution rules (-1 caps the width at 1600 px), shuffles them and
takes the NeRF++ extent.  Its uids are unique across the splits, and each
camera's ground truth is staged on the scene's device once.
"""

from __future__ import annotations

import json
import os
import random

import numpy as np
import torch

from texgs_torch.config import Cfg
from texgs_torch.core.camera import Camera, make_camera, with_ground_truth
from texgs_torch.data.readers import (CameraInfo, SceneInfo,
                                      read_blender_scene, read_colmap_scene,
                                      read_neilf_scene)
from texgs_torch.utils.graphics import fov2focal


def _resize(img: np.ndarray, resolution: tuple[int, int]) -> np.ndarray:
    """PIL resize of (H, W[, C]) float arrays to (W', H') (texgs _resize)."""
    w, h = resolution
    arr = np.asarray(img, np.float32)
    if arr.shape[1] == w and arr.shape[0] == h:
        return arr
    from PIL import Image

    if arr.ndim == 2:
        pil = Image.fromarray((arr * 255).astype(np.uint8), "L")
        return np.asarray(pil.resize((w, h)), np.float32) / 255.0
    chans = [Image.fromarray((arr[..., c] * 255).astype(np.uint8), "L")
             .resize((w, h)) for c in range(arr.shape[-1])]
    return np.stack([np.asarray(c, np.float32) / 255.0 for c in chans], -1)


def load_camera(cfg: Cfg, uid: int, info: CameraInfo,
                resolution_scale: float, device="cuda") -> Camera:
    """CameraInfo -> Camera with its ground truth, texgs's resolution rules
    (-1 caps the width at 1600 px).  The ground truth is staged on
    ``device`` once, so a training step copies no image."""
    orig_w, orig_h = info.width, info.height
    res_setting = cfg.get_or("resolution", -1)
    if res_setting in (1, 2, 4, 8):
        resolution = (round(orig_w / (resolution_scale * res_setting)),
                      round(orig_h / (resolution_scale * res_setting)))
    else:
        if res_setting == -1:
            global_down = orig_w / 1600 if orig_w > 1600 else 1
        else:
            global_down = orig_w / res_setting
        scale = float(global_down) * float(resolution_scale)
        resolution = (int(orig_w / scale), int(orig_h / scale))

    image = _resize(info.image, resolution).transpose(2, 0, 1)
    alpha = None
    if info.alpha is not None:
        alpha = (_resize(info.alpha, resolution) > 0).astype(np.float32)[None]
    elif info.image.shape[-1] == 4:
        alpha = _resize(info.image[..., 3], resolution)[None]
    normal = None
    if info.normal is not None:
        normal = _resize(info.normal, resolution).transpose(2, 0, 1) * 2.0 - 1.0
    depth = None
    if info.depth is not None and (resolution
                                   == (info.depth.shape[1], info.depth.shape[0])):
        depth = np.asarray(info.depth, np.float32)[None]
    cam = make_camera(info.R, info.T, info.FovX, info.FovY, resolution[0],
                      resolution[1], uid=uid, image_name=info.image_name)

    def staged(a):
        return None if a is None else torch.as_tensor(
            np.ascontiguousarray(a), dtype=torch.float32, device=device)

    return with_ground_truth(cam, staged(image[:3]), staged(alpha),
                             normal=staged(normal), depth=staged(depth))


def camera_to_json(uid: int, info: CameraInfo) -> dict:
    rt = np.zeros((4, 4))
    rt[:3, :3] = info.R.transpose()
    rt[:3, 3] = info.T
    rt[3, 3] = 1.0
    w2c = np.linalg.inv(rt)
    return {
        "id": uid, "img_name": info.image_name,
        "width": info.width, "height": info.height,
        "position": w2c[:3, 3].tolist(),
        "rotation": [r.tolist() for r in w2c[:3, :3]],
        "fy": fov2focal(info.FovY, info.height),
        "fx": fov2focal(info.FovX, info.width),
    }


class Scene:
    scene_info: SceneInfo

    def __init__(self, cfg: Cfg, log, work_dir: str, debug: bool = False,
                 device="cuda"):
        self.cfg = cfg
        self.log = log
        self.train_cameras: dict[float, list[Camera]] = {}
        self.test_cameras: dict[float, list[Camera]] = {}

        root = str(cfg.data_root_dir)
        if root.startswith("synthetic://"):
            from texgs_torch.data.synthetic_scene import \
                make_synthetic_scene_info
            scene_info = make_synthetic_scene_info(root, cfg, debug=debug,
                                                   device=device)
        elif os.path.exists(os.path.join(root, "sparse")):
            log.info("Found colmap folder, assuming Colmap data set!")
            scene_info = read_colmap_scene(root, cfg.get_or("image_path", None),
                                           cfg.eval, log=log, debug=debug)
        elif os.path.exists(os.path.join(root, "transforms_train.json")):
            log.info("Found transforms_train.json, assuming Blender data set!")
            scene_info = read_blender_scene(root, cfg.background, cfg.eval,
                                            log=log, debug=debug)
        elif os.path.exists(os.path.join(root, "inputs/sfm_scene.json")):
            log.info("Found sfm_scene.json, assuming NeILF data set!")
            scene_info = read_neilf_scene(root, cfg.background, cfg.eval,
                                          log=log, debug=debug)
        else:
            raise AssertionError(f"Could not recognize scene type at {root}")
        self.scene_info = scene_info

        if not debug and cfg.save_init_pcd and scene_info.ply_path \
                and os.path.exists(scene_info.ply_path):
            with open(scene_info.ply_path, "rb") as src, \
                    open(os.path.join(work_dir, "input.ply"), "wb") as dst:
                dst.write(src.read())

        if not debug and cfg.save_cameras:
            def dump(cams, filename):
                with open(os.path.join(work_dir, filename), "w") as f:
                    json.dump([camera_to_json(i, c)
                               for i, c in enumerate(cams)], f)
            all_cams = []
            if scene_info.test_cameras:
                dump(scene_info.test_cameras, "test_cameras.json")
                all_cams += scene_info.test_cameras
            if scene_info.train_cameras:
                dump(scene_info.train_cameras, "train_cameras.json")
                all_cams += scene_info.train_cameras
            dump(all_cams, "cameras.json")

        if cfg.shuffle:
            random.shuffle(scene_info.train_cameras)
            random.shuffle(scene_info.test_cameras)
        self.cameras_extent = scene_info.nerf_normalization["radius"]

        # uids unique across splits: stage 2 caches its renders by uid
        n_train = len(scene_info.train_cameras)
        for rs in (cfg.resolution_scales or [1.0]):
            log.info("Loading Training Cameras")
            self.train_cameras[rs] = [
                load_camera(cfg, i, c, rs, device)
                for i, c in enumerate(scene_info.train_cameras)]
            log.info("Loading Test Cameras")
            self.test_cameras[rs] = [
                load_camera(cfg, n_train + i, c, rs, device)
                for i, c in enumerate(scene_info.test_cameras)]

    def getTrainCameras(self, scale: float = 1.0) -> list[Camera]:
        return self.train_cameras[scale]

    def getTestCameras(self, scale: float = 1.0) -> list[Camera]:
        return self.test_cameras[scale]


def create_dataset(cfg: Cfg, log, work_dir: str, debug: bool = False,
                   device="cuda") -> Scene:
    if cfg.type != "scene":
        raise KeyError(f"unknown dataset type {cfg.type}")
    return Scene(cfg, log, work_dir, debug, device)
