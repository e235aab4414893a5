"""The port's binding of the native IO library (native/texgs_io.cpp)
against the port's Python parsers and against texgs's binding, on the
cases of tests/test_native_io.py; the library is built from the source
into build/, never loaded from native/; and a COLMAP scene read through it
equals the one read through the Python parsers."""

import shutil

import numpy as np
import pytest

from texgs.data import native as jnative
from texgs_torch._build import BUILD_DIR
from texgs_torch.data import colmap as cm
from texgs_torch.data import native, readers
from texgs_torch.io import ply as plyio


@pytest.fixture(scope="module")
def built():
    if not native.available():
        pytest.skip("native library unavailable (no C++ compiler)")
    return True


def test_library_built_from_source_into_build(built):
    so = native.library_path()
    assert so.exists() and so.parent == BUILD_DIR
    assert so.name.startswith("libtexgs_io-")
    assert native.SOURCE.name == "texgs_io.cpp"
    assert native.build() == so          # built once, then reused


def test_points3d_parity(built, tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "points3D.bin"
    xyz = rng.normal(size=(500, 3))
    rgb = rng.integers(0, 255, (500, 3)).astype(np.uint8)
    err = rng.uniform(size=(500, 1))
    cm.write_points3d_binary(path, xyz, rgb, err)

    py = cm.read_points3d_binary(path)
    nat = native.read_points3d_binary(str(path))
    theirs = jnative.read_points3d_binary(str(path))
    assert nat is not None
    for got, want in ((nat, py), (nat, theirs)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])


def test_images_cameras_parity(built, tmp_path):
    rng = np.random.default_rng(1)
    ipath, cpath = tmp_path / "images.bin", tmp_path / "cameras.bin"
    images = {}
    for i in range(25):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        images[i + 1] = cm.ColmapImage(i + 1, q, rng.normal(size=3), 1,
                                       f"frame_{i:04d}.png")
    cams = {1: cm.ColmapCamera(1, "PINHOLE", 800, 600,
                               np.array([500.0, 510.0, 400.0, 300.0])),
            2: cm.ColmapCamera(2, "SIMPLE_PINHOLE", 640, 480,
                               np.array([450.0, 320.0, 240.0]))}
    cm.write_images_binary(ipath, images)
    cm.write_cameras_binary(cpath, cams)

    py_i = cm.read_images_binary(ipath)
    for na_i in (native.read_images_binary(str(ipath)),
                 jnative.read_images_binary(str(ipath))):
        assert na_i is not None and set(na_i) == set(py_i)
        for k in py_i:
            np.testing.assert_array_equal(na_i[k].qvec, py_i[k].qvec)
            np.testing.assert_array_equal(na_i[k].tvec, py_i[k].tvec)
            assert na_i[k].name == py_i[k].name
            assert na_i[k].camera_id == py_i[k].camera_id

    py_c = cm.read_cameras_binary(cpath)
    for na_c in (native.read_cameras_binary(str(cpath)),
                 jnative.read_cameras_binary(str(cpath))):
        assert na_c is not None and set(na_c) == set(py_c)
        for k in py_c:
            assert na_c[k].model == py_c[k].model
            assert (na_c[k].width, na_c[k].height) == (py_c[k].width,
                                                      py_c[k].height)
            np.testing.assert_array_equal(na_c[k].params, py_c[k].params)


@pytest.mark.parametrize("colors,normals", [(True, True), (True, False),
                                            (False, False)])
def test_ply_parity(built, tmp_path, colors, normals):
    rng = np.random.default_rng(2)
    path = tmp_path / "cloud.ply"
    pts = rng.normal(size=(333, 3)).astype(np.float32)
    rgb = rng.uniform(size=(333, 3)).astype(np.float32) if colors else None
    nrm = rng.normal(size=(333, 3)).astype(np.float32) if normals else None
    plyio.write_ply_xyz(path, pts, colors=rgb, normals=nrm)

    nat = native.read_ply_xyz(str(path))
    assert nat is not None
    np.testing.assert_array_equal(nat[0], pts)
    assert (nat[1] is None) != colors and (nat[2] is None) != normals
    theirs = jnative.read_ply_xyz(str(path))
    for got, want in zip(nat, theirs):
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
    # read_pcd (native) against the numpy parser of the same file
    d = plyio.read_ply(path)
    pcd = plyio.read_pcd(path)
    np.testing.assert_array_equal(pcd.points, np.stack(
        [d["x"], d["y"], d["z"]], 1))
    if colors:
        np.testing.assert_allclose(pcd.colors, np.stack(
            [d["red"], d["green"], d["blue"]], 1) / 255.0, rtol=1e-7)
    if normals:
        np.testing.assert_array_equal(pcd.normals, nrm)


def test_ascii_ply_falls_back_to_python(built, tmp_path):
    path = tmp_path / "ascii.ply"
    path.write_text("ply\nformat ascii 1.0\nelement vertex 2\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    "end_header\n0 1 2\n3 4 5\n")
    assert native.read_ply_xyz(str(path)) is None
    pcd = plyio.read_pcd(path)
    np.testing.assert_array_equal(pcd.points, [[0, 1, 2], [3, 4, 5]])


def test_colmap_scene_native_equals_python(built, tmp_path, monkeypatch):
    from tests.test_torch_data_readers import colmap_scene

    src = colmap_scene(tmp_path / "src")
    shutil.copytree(src, tmp_path / "py")
    fast = readers.read_colmap_scene(str(src), None, True)
    for name in ("read_images_binary", "read_cameras_binary"):
        monkeypatch.setattr(native, name, lambda path: None)
    slow = readers.read_colmap_scene(str(tmp_path / "py"), None, True)
    for a, b in zip(fast.train_cameras + fast.test_cameras,
                    slow.train_cameras + slow.test_cameras):
        assert a.image_name == b.image_name and a.uid == b.uid
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.T, b.T)
        assert (a.FovX, a.FovY) == (b.FovX, b.FovY)
    for k in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(fast.point_cloud, k),
                                      getattr(slow.point_cloud, k))
