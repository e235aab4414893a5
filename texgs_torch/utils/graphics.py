"""Camera/projection matrices, 3DGS conventions (port of texgs/utils/graphics.py).

Row-vector convention: matrices are stored transposed relative to textbook
form and a homogeneous point transforms as ``p_row @ M``.  The projection
maps z to [0, 1] with ``P[3, 2] = 1`` so clip w equals view z.  Host-side
numpy, as in texgs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


class BasicPointCloud(NamedTuple):
    points: np.ndarray   # (N, 3) float
    colors: np.ndarray   # (N, 3) float in [0, 1]
    normals: np.ndarray  # (N, 3) float


def get_world2view(R: np.ndarray, t: np.ndarray,
                   translate: np.ndarray | None = None,
                   scale: float = 1.0) -> np.ndarray:
    """World->view 4x4 (textbook/column form, NOT yet transposed).

    ``R`` is the COLMAP camera-to-world rotation, ``t`` the world->view
    translation; ``translate``/``scale`` recentre the camera position.
    """
    if translate is None:
        translate = np.zeros(3)
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    c2w = np.linalg.inv(Rt)
    cam_center = (c2w[:3, 3] + translate) * scale
    c2w[:3, 3] = cam_center
    return np.linalg.inv(c2w).astype(np.float32)


def get_projection_matrix(znear: float, zfar: float,
                          fovx: float, fovy: float) -> np.ndarray:
    """Perspective projection, z mapped to [0,1], column form."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion -> rotation matrix."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> COLMAP (w, x, y, z) quaternion."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def get_nerf_pp_norm(cam_centers: np.ndarray) -> dict:
    """NeRF++-style scene normalisation: (N, 3) camera centres -> the
    translate vector and the radius (1.1 x the largest distance from their
    centroid), which becomes ``cameras_extent``."""
    center = cam_centers.mean(axis=0, keepdims=True)
    dist = np.linalg.norm(cam_centers - center, axis=1)
    return {"translate": -center[0], "radius": float(dist.max()) * 1.1}
