"""ctypes binding of the native IO library, native/texgs_io.cpp (port of
texgs/data/native.py).

The library is compiled from the checkout's source on first use with

    g++ -O3 -std=c++17 -shared -fPIC

into ``build/texgs_torch/libtexgs_io-<hash>.so`` at the repository root,
the hash covering the source and the flags; a library already in
``native/`` is never loaded and nothing is written there.  The functions
are drop-in replacements for the Python parsers of ``data/colmap.py`` and
``io/ply.py``, which stay the behavioural reference: each returns None
where the library is unavailable (no C++ compiler) or the file's layout is
not one it reads, and the callers then parse in Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from texgs_torch._build import BUILD_DIR
from texgs_torch.data.colmap import CAMERA_MODELS, ColmapCamera, ColmapImage

SOURCE = Path(__file__).resolve().parents[2] / "native" / "texgs_io.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0"
                       + SOURCE.read_bytes())
    return BUILD_DIR / f"libtexgs_io-{h.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """Compile the library unless it is built already.  Returns its path,
    or None where there is no C++ compiler; a failed compile raises."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    so = build()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))

    c_long, c_char_p = ctypes.c_long, ctypes.c_char_p
    dp = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    int_p = ctypes.POINTER(ctypes.c_int)
    signatures = {
        "colmap_points3d_count": [c_char_p],
        "colmap_read_points3d": [c_char_p, dp, u8p, dp, c_long],
        "colmap_images_count": [c_char_p],
        "colmap_read_images": [c_char_p, i32p, i32p, dp, dp, u8p, c_long],
        "colmap_read_cameras": [c_char_p, i32p, i32p, i64p, i64p, dp, c_long],
        "ply_read_xyz": [c_char_p, fp, fp, fp, c_long, int_p, int_p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = c_long
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def read_points3d_binary(path):
    """Native counterpart of ``colmap.read_points3d_binary``."""
    lib = _load()
    if lib is None:
        return None
    n = lib.colmap_points3d_count(str(path).encode())
    if n < 0:
        return None
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty((n,), np.float64)
    if lib.colmap_read_points3d(str(path).encode(), xyz, rgb, err, n) != n:
        return None
    return xyz, rgb, err[:, None]


def read_images_binary(path):
    """Native counterpart of ``colmap.read_images_binary``."""
    lib = _load()
    if lib is None:
        return None
    n = lib.colmap_images_count(str(path).encode())
    if n < 0:
        return None
    ids = np.empty((n,), np.int32)
    cam_ids = np.empty((n,), np.int32)
    qvecs = np.empty((n, 4), np.float64)
    tvecs = np.empty((n, 3), np.float64)
    names = np.zeros((n, 256), np.uint8)
    if lib.colmap_read_images(str(path).encode(), ids, cam_ids, qvecs, tvecs,
                              names, n) != n:
        return None
    out = {}
    for i in range(n):
        name = bytes(names[i]).split(b"\0", 1)[0].decode("utf-8")
        out[int(ids[i])] = ColmapImage(int(ids[i]), qvecs[i].copy(),
                                       tvecs[i].copy(), int(cam_ids[i]), name)
    return out


def read_cameras_binary(path):
    """Native counterpart of ``colmap.read_cameras_binary``."""
    lib = _load()
    if lib is None:
        return None
    cap = 4096
    ids = np.empty((cap,), np.int32)
    model_ids = np.empty((cap,), np.int32)
    widths = np.empty((cap,), np.int64)
    heights = np.empty((cap,), np.int64)
    params = np.empty((cap, 8), np.float64)
    n = lib.colmap_read_cameras(str(path).encode(), ids, model_ids, widths,
                                heights, params, cap)
    if n < 0:
        return None
    out = {}
    for i in range(n):
        name, n_params = CAMERA_MODELS[int(model_ids[i])]
        out[int(ids[i])] = ColmapCamera(int(ids[i]), name, int(widths[i]),
                                        int(heights[i]),
                                        params[i, :n_params].copy())
    return out


def read_ply_xyz(path):
    """Binary float32 PLY clouds: (points, colors or None, normals or None),
    or None for a layout the library does not read."""
    lib = _load()
    if lib is None:
        return None
    # the vertex count, from the header
    n = None
    with open(path, "rb") as f:
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line == "end_header" or not line:
                break
    if not n:
        return None
    xyz = np.empty((n, 3), np.float32)
    colors = np.empty((n, 3), np.float32)
    normals = np.empty((n, 3), np.float32)
    has_rgb, has_normal = ctypes.c_int(0), ctypes.c_int(0)
    got = lib.ply_read_xyz(str(path).encode(), xyz, colors, normals, n,
                           ctypes.byref(has_rgb), ctypes.byref(has_normal))
    if got != n:
        return None
    return (xyz, colors if has_rgb.value else None,
            normals if has_normal.value else None)
