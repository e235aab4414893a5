"""The port's dataset readers and ``Scene`` against texgs's, on small
Blender, COLMAP (binary and text, with ../masks) and NeILF (a ``dtu``
directory) scenes written here with numpy and PIL.

Each reader of each package reads its own copy of a fixture (the readers
write PLY files beside the data on first use).  Every ``CameraInfo`` field
must agree: images, masks, normals and depths bit for bit, R, T and the
fields of view to 1e-12; so must the point clouds (the Blender random
init under one ``np.random.seed``) and the NeRF++ normalisation.  Also the
resolution cap, the uids across splits, the ground-truth tensors of the
port's ``Scene`` against texgs's camera arrays, and the ``input.ply`` copy
and the three camera JSON dumps, byte for byte.
"""

import json
import logging
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from texgs.config import Cfg as JCfg
from texgs.data import readers as jreaders
from texgs.data.scene import Scene as JScene
from texgs.data.scene import load_camera as jax_load_camera
from texgs_torch.config import Cfg
from texgs_torch.data import colmap as cm
from texgs_torch.data import readers
from texgs_torch.data.scene import Scene, load_camera
from texgs_torch.io import ply as plyio
from texgs_torch.utils.graphics import qvec2rotmat
from tests.torch_threads import one_thread  # noqa: F401

LOG = logging.getLogger("texgs-torch-readers")
ARRAYS = ("image", "normal", "alpha", "depth")


def write_img(path, arr):
    Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8)).save(path)


def random_pose(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    if q[0] < 0:
        q = -q
    return q, rng.normal(size=3)


def colmap_scene(root, text=False, masks=True):
    rng = np.random.default_rng(0)
    (root / "sparse" / "0").mkdir(parents=True)
    (root / "images").mkdir()
    w, h = 40, 24
    cams = {1: cm.ColmapCamera(1, "PINHOLE", w, h,
                               np.array([30.0, 31.0, w / 2, h / 2])),
            2: cm.ColmapCamera(2, "SIMPLE_PINHOLE", w, h,
                               np.array([33.0, w / 2, h / 2]))}
    images = {}
    for i in range(10):
        q, t = random_pose(rng)
        name = f"img_{i:03d}.png"
        images[i + 1] = cm.ColmapImage(i + 1, q, t, 1 + i % 2, name)
        write_img(root / "images" / name, rng.uniform(size=(h, w, 3)))
    if masks:
        (root / "masks").mkdir()
        for i in range(0, 10, 3):
            write_img(root / "masks" / f"img_{i:03d}.png",
                      rng.uniform(size=(h, w)) > 0.4)
    xyz = rng.normal(size=(100, 3))
    rgb = rng.integers(0, 255, (100, 3)).astype(np.uint8)
    sparse = root / "sparse" / "0"
    if text:
        with open(sparse / "cameras.txt", "w") as f:
            f.write("# camera list\n")
            for c in cams.values():
                f.write(f"{c.id} {c.model} {c.width} {c.height} "
                        + " ".join(repr(float(p)) for p in c.params) + "\n")
        with open(sparse / "images.txt", "w") as f:
            f.write("# image list\n")
            for im in images.values():
                f.write(f"{im.id} " + " ".join(repr(float(v)) for v in
                                               (*im.qvec, *im.tvec))
                        + f" {im.camera_id} {im.name}\n"
                        + "1.5 2.5 -1\n")
        with open(sparse / "points3D.txt", "w") as f:
            for i in range(100):
                f.write(f"{i + 1} " + " ".join(repr(float(v)) for v in xyz[i])
                        + " " + " ".join(str(int(v)) for v in rgb[i])
                        + " 0.5\n")
    else:
        cm.write_cameras_binary(sparse / "cameras.bin", cams)
        cm.write_images_binary(sparse / "images.bin", images)
        cm.write_points3d_binary(sparse / "points3D.bin", xyz, rgb)
    return root


def blender_scene(root, alpha_files=False):
    rng = np.random.default_rng(1)
    for split, n in (("train", 6), ("test", 2)):
        (root / split).mkdir(parents=True)
        frames = []
        for i in range(n):
            c2w = np.eye(4)
            c2w[:3, :3] = qvec2rotmat(random_pose(rng)[0])
            c2w[:3, 3] = rng.normal(size=3) * 3
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
            write_img(root / f"{split}/r_{i}.png",
                      rng.uniform(size=(24, 32, 4)))
            write_img(root / f"{split}/r_{i}_normal.png",
                      rng.uniform(size=(24, 32, 3)))
            if alpha_files:
                write_img(root / f"{split}/r_{i}_alpha.png",
                          np.repeat(rng.uniform(size=(24, 32, 1)) > 0.5, 3,
                                    -1))
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    return root


def neilf_scene(root):
    rng = np.random.default_rng(2)
    inputs = root / "inputs"
    for sub in ("images", "depths", "normals", "pmasks", "model"):
        (inputs / sub).mkdir(parents=True)
    h, w = 24, 32
    image_paths, cam_map = {}, {}
    for i in range(8):
        q, t = random_pose(rng)
        ext = np.eye(4)
        ext[:3, :3] = qvec2rotmat(q).T
        ext[:3, 3] = t
        image_paths[str(i)] = f"images/{i:06d}.png"
        cam_map[str(i)] = {
            "flg": 2 if i != 3 else 1,
            "camera": {"extrinsic": ext.reshape(-1).tolist(),
                       "intrinsic": {"focal": [40.0, 41.0],
                                     "ppt": [w / 2, h / 2]}}}
        write_img(inputs / image_paths[str(i)], rng.uniform(size=(h, w, 3)))
        Image.fromarray(rng.uniform(1, 3, (h, w)).astype(np.float32)).save(
            inputs / "depths" / f"{i:06d}.tiff")
        nrm = rng.uniform(-1, 1, (h, w, 3)).astype(np.float32)
        with open(inputs / "normals" / f"{i:06d}.pfm", "wb") as f:
            f.write(b"PF\n" + f"{w} {h}\n".encode() + b"-1.0\n")
            nrm[::-1].astype("<f4").tofile(f)
        write_img(inputs / "pmasks" / f"{i:06d}.png",
                  rng.uniform(size=(h, w)) > 0.3)
    bbox = np.diag([2.0, 3.0, 2.5, 1.0])
    bbox[:3, 3] = [0.1, -0.2, 0.3]
    with open(inputs / "sfm_scene.json", "w") as f:
        json.dump({"bbox": {"transform": bbox.reshape(-1).tolist()},
                   "image_path": {"file_paths": image_paths},
                   "camera_track_map": {"images": cam_map}}, f)
    pts = rng.normal(size=(50, 3))
    plyio.write_ply_xyz(inputs / "model" / "sparse.ply", pts,
                        colors=rng.uniform(size=(50, 3)),
                        normals=rng.normal(size=(50, 3)))
    return root


def two_copies(make, tmp_path, name, **kw):
    src = make(tmp_path / "src" / name, **kw)
    a, b = tmp_path / "texgs" / name, tmp_path / "port" / name
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    return str(a), str(b)


def read_both(kind, a, b, seed=0, **kw):
    bg = [0.2, 0.4, 0.6]
    calls = {
        "colmap": lambda m, p: m.read_colmap_scene(p, None, True, log=LOG),
        "blender": lambda m, p: m.read_blender_scene(p, bg, True, log=LOG),
        "neilf": lambda m, p: m.read_neilf_scene(p, bg, True, log=LOG),
    }
    np.random.seed(seed)
    want = calls[kind](jreaders, a)
    np.random.seed(seed)
    got = calls[kind](readers, b)
    return want, got


def assert_same_info(got, want, a_root, b_root):
    assert got.uid == want.uid and got.image_name == want.image_name
    assert (got.width, got.height) == (want.width, want.height)
    assert got.image_path.replace(b_root, a_root) == want.image_path
    for k in ("R", "T"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=0, atol=1e-12, err_msg=k)
    assert abs(got.FovX - want.FovX) <= 1e-12
    assert abs(got.FovY - want.FovY) <= 1e-12
    for k in ARRAYS:
        w, g = getattr(want, k), getattr(got, k)
        assert (w is None) == (g is None), k
        if w is not None:
            assert g.dtype == np.asarray(w).dtype, k
            assert np.array_equal(g, np.asarray(w)), k


def assert_same_scene(got, want, a_root, b_root):
    for split in ("train_cameras", "test_cameras"):
        gs, ws = getattr(got, split), getattr(want, split)
        assert len(gs) == len(ws), split
        for g, w in zip(gs, ws):
            assert_same_info(g, w, a_root, b_root)
    for k in ("points", "colors", "normals"):
        assert np.array_equal(getattr(got.point_cloud, k),
                              getattr(want.point_cloud, k)), k
    np.testing.assert_allclose(got.nerf_normalization["translate"],
                               want.nerf_normalization["translate"],
                               rtol=0, atol=1e-12)
    assert abs(got.nerf_normalization["radius"]
               - want.nerf_normalization["radius"]) <= 1e-12
    assert got.ply_path.replace(b_root, a_root) == want.ply_path


@pytest.mark.parametrize("text", [False, True], ids=["bin", "txt"])
def test_colmap_reader_matches_texgs(tmp_path, text):
    a, b = two_copies(colmap_scene, tmp_path, "colmap", text=text)
    want, got = read_both("colmap", a, b)
    assert_same_scene(got, want, a, b)
    # llffhold 8 over 10 images; masks on images 0, 3, 6 and 9
    assert len(got.train_cameras) == 8 and len(got.test_cameras) == 2
    assert sum(c.alpha is not None for c in got.train_cameras
               + got.test_cameras) == 4


@pytest.mark.parametrize("alpha_files", [False, True],
                         ids=["alpha_from_normal", "alpha_png"])
@pytest.mark.parametrize("seed", [0, 5])
def test_blender_reader_matches_texgs(tmp_path, alpha_files, seed):
    a, b = two_copies(blender_scene, tmp_path, "blender",
                      alpha_files=alpha_files)
    want, got = read_both("blender", a, b, seed=seed)
    assert_same_scene(got, want, a, b)
    assert got.point_cloud.points.shape == (100_000, 3)
    assert len(got.train_cameras) == 6 and len(got.test_cameras) == 2


def test_neilf_reader_matches_texgs(tmp_path):
    a, b = two_copies(neilf_scene, tmp_path, "dtu_scan1")
    want, got = read_both("neilf", a, b)
    assert_same_scene(got, want, a, b)
    # DTU's test index 6 of 0..7, view 3 not registered (flg 1)
    assert [c.uid for c in got.test_cameras] == [6]
    assert len(got.train_cameras) == 6
    assert got.train_cameras[0].depth.shape == (24, 32)


def test_neilf_eval_split_refused_elsewhere(tmp_path):
    """Only a directory named for DTU has a NeILF test split."""
    root = neilf_scene(tmp_path / "scan1")
    with pytest.raises(NotImplementedError):
        readers.read_neilf_scene(str(root), [0, 0, 0], True)


def test_load_img_without_extension_and_mask(tmp_path):
    rng = np.random.default_rng(3)
    write_img(tmp_path / "a.png", rng.uniform(size=(5, 7, 3)))
    write_img(tmp_path / "m.png", rng.uniform(size=(5, 7, 3)))
    for fn, path in ((readers.load_img, "a"), (readers.load_mask, "m.png")):
        got = fn(str(tmp_path / path))
        want = getattr(jreaders, fn.__name__)(str(tmp_path / path))
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_resolution_cap():
    """resolution -1 caps the width at 1600 px, as texgs's load_camera."""
    rng = np.random.default_rng(4)
    info = readers.CameraInfo(
        uid=0, R=np.eye(3), T=np.zeros(3), FovY=0.8, FovX=0.8,
        image=rng.uniform(size=(600, 2000, 3)).astype(np.float32),
        image_path="", image_name="big", width=2000, height=600,
        alpha=(rng.uniform(size=(600, 2000)) > 0.5).astype(np.float32))
    cam = load_camera(Cfg(dict(resolution=-1)), 0, info, 1.0, device="cpu")
    want = jax_load_camera(JCfg(dict(resolution=-1)), 0, info, 1.0)
    assert (cam.width, cam.height) == (want.width, want.height) == (1600, 480)
    assert np.array_equal(cam.image.numpy(), np.asarray(want.image))
    assert np.array_equal(cam.alpha_mask.numpy(), np.asarray(want.alpha_mask))


def scene_cfg(root, **kw):
    return dict(type="scene", data_root_dir=root, eval=True,
                background=[0.2, 0.4, 0.6], shuffle=False,
                resolution_scales=[1.0], resolution=1, save_init_pcd=True,
                save_cameras=True, **kw)


@pytest.mark.parametrize("kind", ["blender", "colmap", "neilf"])
def test_scene_matches_texgs(tmp_path, kind):
    make = {"blender": blender_scene, "colmap": colmap_scene,
            "neilf": neilf_scene}[kind]
    a, b = two_copies(make, tmp_path, f"{kind}_dtu")
    wa, wb = tmp_path / "work_texgs", tmp_path / "work_port"
    wa.mkdir()
    wb.mkdir()
    np.random.seed(0)
    want = JScene(JCfg(scene_cfg(a)), LOG, str(wa))
    np.random.seed(0)
    got = Scene(Cfg(scene_cfg(b)), LOG, str(wb), device="cpu")
    assert got.cameras_extent == want.cameras_extent
    for split in ("getTrainCameras", "getTestCameras"):
        gs, ws = getattr(got, split)(), getattr(want, split)()
        assert len(gs) == len(ws) > 0
        for g, w in zip(gs, ws):
            assert (g.uid, g.image_name) == (w.uid, w.image_name)
            for k in ("world_view", "full_proj", "camera_center"):
                np.testing.assert_array_equal(getattr(g, k),
                                              np.asarray(getattr(w, k)))
            for k in ("image", "alpha_mask", "normal", "depth"):
                gv, wv = getattr(g, k), getattr(w, k)
                assert (gv is None) == (wv is None), k
                if gv is not None:
                    assert isinstance(gv, torch.Tensor), k
                    assert np.array_equal(gv.numpy(), np.asarray(wv)), k
    # uids unique across the splits
    uids = [c.uid for c in got.getTrainCameras() + got.getTestCameras()]
    assert len(set(uids)) == len(uids)
    for name in ("input.ply", "cameras.json", "train_cameras.json",
                 "test_cameras.json"):
        assert (wb / name).read_bytes() == (wa / name).read_bytes(), name


def test_scene_rejects_an_unknown_root(tmp_path):
    with pytest.raises(AssertionError):
        Scene(Cfg(scene_cfg(str(tmp_path))), LOG, str(tmp_path), device="cpu")
