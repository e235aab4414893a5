"""Scene records (port of the part of texgs/data/readers.py that the
synthetic scene needs): ``CameraInfo``, ``SceneInfo`` and the NeRF++ extent
of a camera list.  The COLMAP, Blender and NeILF readers (readers.py,
colmap.py, native.py) are not ported yet; ROADMAP.md queue 1 lists them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from texgs_torch.utils.graphics import (BasicPointCloud, get_nerf_pp_norm,
                                        get_world2view)


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
