"""Camera used by the renderers (port of texgs/core/camera.py).

Matrix convention is row-vector/transposed, identical to texgs:
``world_view`` = getWorld2View2(...)^T, ``full_proj`` = world_view @ proj^T,
``camera_center`` = inv(world_view)[3, :3].  The matrices stay host-side
numpy (float32); renderers move what they need to their device.
"""

from __future__ import annotations

import dataclasses
import math

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
