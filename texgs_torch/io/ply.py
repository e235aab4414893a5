"""Minimal PLY point-cloud IO (port of texgs/io/ply.py).

Binary-little-endian (and ascii, read only) vertex elements with float and
uchar properties: the point clouds of the datasets, ``save_point_cloud``
and ``extract_pcd``.  ``read_pcd`` first tries the native reader
(data/native.py), as texgs's does, and parses in numpy where that one
cannot.
"""

from __future__ import annotations

import numpy as np

_DTYPES = {
    "float": np.float32, "float32": np.float32,
    "double": np.float64, "float64": np.float64,
    "uchar": np.uint8, "uint8": np.uint8,
    "char": np.int8, "int8": np.int8,
    "short": np.int16, "ushort": np.uint16,
    "int": np.int32, "int32": np.int32,
    "uint": np.uint32, "uint32": np.uint32,
}
_NAMES = {np.dtype(np.float32): "float", np.dtype(np.float64): "double",
          np.dtype(np.uint8): "uchar", np.dtype(np.int32): "int",
          np.dtype(np.uint32): "uint"}


def write_ply(path, fields: dict[str, np.ndarray]):
    """fields: name -> (N,) arrays written as one 'vertex' element."""
    n = len(next(iter(fields.values())))
    cols = []
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    for name, arr in fields.items():
        arr = np.asarray(arr)
        assert arr.shape == (n,), f"field {name} must be (N,)"
        tname = _NAMES[arr.dtype]
        header.append(f"property {tname} {name}")
        cols.append((name, arr))
    header.append("end_header")
    rec_dtype = np.dtype([(name, arr.dtype) for name, arr in cols])
    rec = np.empty(n, dtype=rec_dtype)
    for name, arr in cols:
        rec[name] = arr
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        rec.tofile(f)


def write_ply_xyz(path, xyz: np.ndarray, colors: np.ndarray | None = None,
                  normals: np.ndarray | None = None):
    xyz = np.asarray(xyz, np.float32)
    fields = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2]}
    if normals is not None:
        normals = np.asarray(normals, np.float32)
        fields.update(nx=normals[:, 0], ny=normals[:, 1], nz=normals[:, 2])
    if colors is not None:
        c = np.asarray(colors)
        if c.dtype != np.uint8:
            c = (np.clip(c, 0, 1) * 255).astype(np.uint8)
        fields.update(red=c[:, 0], green=c[:, 1], blue=c[:, 2])
    write_ply(path, fields)


def read_ply(path) -> dict[str, np.ndarray]:
    """Read the 'vertex' element of a binary or ascii PLY."""
    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline().decode("ascii").strip()
            header_lines.append(line)
            if line == "end_header":
                break
        fmt = None
        n = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        for line in header_lines:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                if parts[1] == "list":
                    raise ValueError("list properties unsupported")
                props.append((parts[2], parts[1]))

        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n)
            if data.ndim == 1:
                data = data[None]
            return {name: data[:, i].astype(_DTYPES[t])
                    for i, (name, t) in enumerate(props)}

        assert fmt == "binary_little_endian", f"unsupported format {fmt}"
        dtype = np.dtype([(name, np.dtype(_DTYPES[t]).newbyteorder("<"))
                          for name, t in props])
        rec = np.fromfile(f, dtype=dtype, count=n)
        return {name: np.ascontiguousarray(rec[name]) for name, _ in props}


def read_pcd(path):
    """Read (points, colors, normals) as float arrays; colors in [0, 1]."""
    from texgs_torch.data import native
    from texgs_torch.utils.graphics import BasicPointCloud

    fast = native.read_ply_xyz(path)
    if fast is not None:
        pts, colors, normals = fast
        return BasicPointCloud(
            points=pts,
            colors=colors if colors is not None else np.ones_like(pts) * 0.5,
            normals=normals if normals is not None else np.zeros_like(pts))

    d = read_ply(path)
    pts = np.stack([d["x"], d["y"], d["z"]], axis=1).astype(np.float32)
    if "red" in d:
        colors = np.stack([d["red"], d["green"], d["blue"]], axis=1)
        colors = colors.astype(np.float32)
        if colors.max() > 1.001:
            colors = colors / 255.0
    else:
        colors = np.ones_like(pts) * 0.5
    if "nx" in d:
        normals = np.stack([d["nx"], d["ny"], d["nz"]], axis=1).astype(np.float32)
    else:
        normals = np.zeros_like(pts)
    return BasicPointCloud(points=pts, colors=colors, normals=normals)
