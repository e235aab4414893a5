"""Procedural synthetic scenes (port of texgs/data/synthetic.py).

Deterministic numpy point clouds and orbit cameras, identical to texgs's
for the same arguments.
"""

from __future__ import annotations

import math

import numpy as np

from texgs_torch.core.camera import Camera, look_at_camera
from texgs_torch.utils.graphics import BasicPointCloud


def textured_sphere_point_cloud(n: int = 2048, radius: float = 1.0,
                                seed: int = 0,
                                freq: float = 12.0) -> BasicPointCloud:
    """Points on a sphere with high-frequency procedural color, a stand-in
    for a textured object."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = v * radius
    bands = (np.sin(freq * pts[:, 0]) * np.sin(freq * pts[:, 1])
             * np.sin(freq * pts[:, 2]) > 0).astype(np.float32)
    colors = np.stack([
        0.15 + 0.7 * bands,
        0.5 + 0.3 * np.sin(2 * pts[:, 1]),
        0.85 - 0.7 * bands,
    ], axis=1)
    return BasicPointCloud(points=pts.astype(np.float32),
                           colors=np.clip(colors, 0, 1).astype(np.float32),
                           normals=v.astype(np.float32))


def orbit_cameras(n_cams: int = 8, radius: float = 4.0, fov_deg: float = 50.0,
                  width: int = 128, height: int = 128,
                  elevation_deg: float = 20.0,
                  spiral: bool = False) -> list[Camera]:
    """Ring of cameras looking at the origin; ``spiral=True`` sweeps the
    elevation over two turns for full-sphere coverage."""
    fovx = math.radians(fov_deg)
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    cams = []
    for i in range(n_cams):
        if spiral:
            az = 4 * math.pi * i / n_cams
            el = math.radians(elevation_deg) * (
                -1.0 + 3.0 * i / max(n_cams - 1, 1))
        else:
            az = 2 * math.pi * i / n_cams
            el = math.radians(elevation_deg)
        eye = np.array([radius * math.cos(az) * math.cos(el),
                        radius * math.sin(az) * math.cos(el),
                        radius * math.sin(el)])
        cams.append(look_at_camera(eye, np.zeros(3), np.array([0.0, 0.0, 1.0]),
                                   fovx, fovy, width, height, uid=i,
                                   image_name=f"orbit_{i:03d}"))
    return cams
