"""Camera used by the renderers (port of texgs/core/camera.py).

Matrix convention is row-vector/transposed, identical to texgs:
``world_view`` = getWorld2View2(...)^T, ``full_proj`` = world_view @ proj^T,
``camera_center`` = inv(world_view)[3, :3].  The matrices stay host-side
numpy (float32); renderers move what they need to their device.

A training view also carries its ground truth, as texgs's Camera does:
``image`` (3, H, W) premultiplied by ``alpha_mask`` (1, H, W), and
optionally ``normal`` (3, H, W) and ``depth`` (1, H, W), as numpy arrays or
tensors (``with_ground_truth``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np

from texgs_torch.utils import graphics

ZNEAR = 0.01
ZFAR = 100.0


@dataclasses.dataclass(frozen=True)
class Camera:
    world_view: np.ndarray          # (4, 4) f32, row-vector world->view
    full_proj: np.ndarray           # (4, 4) f32, row-vector world->clip
    camera_center: np.ndarray       # (3,) f32 world-space camera position
    width: int
    height: int
    fovx: float
    fovy: float
    znear: float = ZNEAR
    zfar: float = ZFAR
    uid: int = 0
    image_name: str = ""
    image: Optional[Any] = None       # (3, H, W) f32 rgb, premultiplied
    alpha_mask: Optional[Any] = None  # (1, H, W) f32
    normal: Optional[Any] = None      # (3, H, W) f32 in [-1, 1]
    depth: Optional[Any] = None       # (1, H, W) f32 view-space z

    @property
    def tanfovx(self) -> float:
        return math.tan(self.fovx * 0.5)

    @property
    def tanfovy(self) -> float:
        return math.tan(self.fovy * 0.5)


def make_camera(R: np.ndarray, T: np.ndarray, fovx: float, fovy: float,
                width: int, height: int, znear: float = ZNEAR,
                zfar: float = ZFAR, uid: int = 0,
                image_name: str = "") -> Camera:
    """Build a Camera from COLMAP-style (R, T)."""
    w2v = graphics.get_world2view(R, T)
    proj = graphics.get_projection_matrix(znear, zfar, fovx, fovy)
    world_view = w2v.T.astype(np.float32)
    full_proj = (world_view @ proj.T).astype(np.float32)
    camera_center = np.linalg.inv(world_view)[3, :3].astype(np.float32)
    return Camera(world_view=world_view, full_proj=full_proj,
                  camera_center=camera_center,
                  width=int(width), height=int(height),
                  fovx=float(fovx), fovy=float(fovy),
                  znear=float(znear), zfar=float(zfar),
                  uid=int(uid), image_name=image_name)


def with_ground_truth(camera: Camera, image, alpha_mask=None, normal=None,
                      depth=None) -> Camera:
    """``camera`` with its ground truth attached.  ``image`` (3, H, W) is
    clipped to [0, 1] and premultiplied by ``alpha_mask`` (1, H, W) when one
    is given, as texgs's ``make_camera`` does.  Tensors stay tensors (on
    their device); anything else becomes a float32 numpy array."""
    def as_array(a):
        if a is None:
            return None
        if hasattr(a, "detach"):
            return a.detach().float()
        return np.asarray(a, np.float32)

    image, alpha_mask = as_array(image), as_array(alpha_mask)
    normal, depth = as_array(normal), as_array(depth)
    for name, a, c in (("image", image, 3), ("alpha_mask", alpha_mask, 1),
                       ("normal", normal, 3), ("depth", depth, 1)):
        if a is not None and tuple(a.shape) != (c, camera.height, camera.width):
            raise ValueError(f"{name} must be ({c}, {camera.height}, "
                             f"{camera.width}), got {tuple(a.shape)}")
    image = image.clip(0.0, 1.0)
    if alpha_mask is not None:
        image = image * alpha_mask
    return dataclasses.replace(camera, image=image, alpha_mask=alpha_mask,
                               normal=normal, depth=depth)


def ground_truth(camera: Camera, device):
    """(image, alpha) of a training view as float32 tensors on ``device``;
    alpha is ones where the view has no mask."""
    import torch

    image = torch.as_tensor(camera.image, dtype=torch.float32, device=device)
    if camera.alpha_mask is None:
        return image, torch.ones((1,) + tuple(image.shape[1:]), device=device)
    return image, torch.as_tensor(camera.alpha_mask, dtype=torch.float32,
                                  device=device)


def look_at_camera(eye: np.ndarray, target: np.ndarray, up: np.ndarray,
                   fovx: float, fovy: float, width: int, height: int,
                   **kwargs) -> Camera:
    """Camera at ``eye`` looking at ``target`` (synthetic scenes, tests)."""
    eye = np.asarray(eye, np.float64)
    forward = np.asarray(target, np.float64) - eye
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    down = np.cross(forward, right)
    # view rows: x->right, y->down (image y grows downward), z->forward
    R_w2c = np.stack([right, down, forward], axis=0)
    # COLMAP convention: R stored as cam-to-world rotation, T world->cam
    R = R_w2c.T
    T = -R_w2c @ eye
    return make_camera(R, T, fovx, fovy, width, height, **kwargs)
