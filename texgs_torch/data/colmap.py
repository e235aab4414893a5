"""COLMAP sparse-reconstruction parsers (binary and text) and the binary
writers, in numpy (port of texgs/data/colmap.py).

The documented COLMAP export format: cameras, images and points3D in .bin
or .txt.  Only the undistorted models (SIMPLE_PINHOLE, PINHOLE) are read
downstream (data/readers.py).  The writers make the sparse/0 folder of
``tools/make_dataset`` and of the tests' fixtures.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray   # (4,) wxyz
    tvec: np.ndarray   # (3,)
    camera_id: int
    name: str


# model_id -> (name, num_params); COLMAP's camera model table.
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}


def _read(f, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cams[cam_id] = ColmapCamera(cam_id, name, int(width), int(height),
                                        params)
    return cams


def read_images_binary(path) -> dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            f.seek(24 * n_pts, 1)  # skip 2D points (x, y double + id int64)
            images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id,
                                           name.decode("utf-8"))
    return images


def read_points3d_binary(path):
    """Returns (xyz (N,3) f64, rgb (N,3) u8, err (N,1) f64)."""
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty((n, 1))
        for i in range(n):
            vals = _read(f, "<QdddBBBd")
            xyz[i] = vals[1:4]
            rgb[i] = vals[4:7]
            err[i] = vals[7]
            (track_len,) = _read(f, "<Q")
            f.seek(8 * track_len, 1)
    return xyz, rgb, err


def read_cameras_text(path) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            model = parts[1]
            cams[cam_id] = ColmapCamera(
                cam_id, model, int(parts[2]), int(parts[3]),
                np.array([float(p) for p in parts[4:]]))
    return cams


def read_images_text(path) -> dict[int, ColmapImage]:
    images = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.startswith("#")]
    # pairs of lines: meta line, then 2D-point line (skipped)
    for meta in lines[0::2]:
        parts = meta.split()
        image_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        camera_id = int(parts[8])
        name = parts[9]
        images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id, name)
    return images


def read_points3d_text(path):
    xyzs, rgbs, errs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyzs.append([float(p) for p in parts[1:4]])
            rgbs.append([int(p) for p in parts[4:7]])
            errs.append([float(parts[7])])
    return (np.array(xyzs), np.array(rgbs, np.uint8), np.array(errs))


# ------------------------------------------------------------------ writers

def write_cameras_binary(path, cams: dict[int, ColmapCamera]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid, n_params = MODEL_NAME_TO_ID[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack(f"<{n_params}d", *cam.params[:n_params]))


def write_images_binary(path, images: dict[int, ColmapImage]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec,
                                im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_binary(path, xyz, rgb, err=None):
    n = len(xyz)
    err = np.zeros((n, 1)) if err is None else err
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            f.write(struct.pack("<QdddBBBd", i + 1, *xyz[i],
                                *np.asarray(rgb[i], np.uint8), float(err[i, 0])))
            f.write(struct.pack("<Q", 0))
