"""The port's dataset writer (``python -m texgs_torch.tools.make_dataset``)
against texgs's scripts/make_synthetic_dataset.py, for the Blender, COLMAP
and NeILF layouts, on the same tiny arguments: the oracle renders 256
Gaussians into 3 + 1 views of 32².

Both write the same files.  Poses (JSON), COLMAP binaries and PLYs agree
to 1e-6; each 8-bit image differs by at most 1 level on at most 16 values;
TIFF depths and PFM normals agree within 1e-4 + 1e-4·|x|.  texgs's
readers read each port-written scene, and the port's stage 1 trains from
the Blender one through ``driver.train`` on the CPU.
"""

import glob
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from texgs.data import colmap as jcm
from texgs.data import readers as jreaders
from texgs.io import ply as jply
from texgs_torch.tools import make_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--n", "256", "--views", "3", "--test_views", "1", "--size", "32",
        "--init_ply"]
FORMATS = ("blender", "colmap", "neilf")
# a NeILF directory's name must hold "dtu" for its test split
DIRS = {"blender": "blender", "colmap": "colmap", "neilf": "dtu_neilf"}
THREADS = 2


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    base = tmp_path_factory.mktemp("datasets")
    script = os.path.join(REPO, "scripts", "make_synthetic_dataset.py")
    env = dict(os.environ, TEXGS_CPU="1")
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        for fmt in FORMATS:
            want, got = base / "texgs" / DIRS[fmt], base / "port" / DIRS[fmt]
            subprocess.run([sys.executable, script, str(want), *ARGS,
                            "--format", fmt], check=True, env=env,
                           timeout=600, capture_output=True)
            n = make_dataset.main([str(got), *ARGS, "--format", fmt,
                                   "--device", "cpu"])
            assert n == 4
            out[fmt] = (str(want), str(got))
    finally:
        torch.set_num_threads(threads)
    return out


def files_of(root):
    return sorted(os.path.relpath(p, root) for p in
                  glob.glob(os.path.join(root, "**", "*"), recursive=True)
                  if os.path.isfile(p))


def assert_json_close(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_json_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_json_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-6, (path, got, want)
    else:
        assert got == want, path


def assert_png_close(got_path, want_path):
    import imageio.v2 as imageio

    want = np.asarray(imageio.imread(want_path)).astype(np.int32)
    with Image.open(got_path) as im:
        got = np.asarray(im).astype(np.int32)
    assert got.shape == want.shape, got_path
    diff = np.abs(got - want)
    assert diff.max() <= 1, (got_path, diff.max())
    assert (diff > 0).sum() <= 16, (got_path, (diff > 0).sum())


def assert_float_close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("fmt", FORMATS)
def test_writer_matches_texgs_script(written, fmt):
    want_root, got_root = written[fmt]
    names = files_of(want_root)
    assert files_of(got_root) == names
    for rel in names:
        w, g = os.path.join(want_root, rel), os.path.join(got_root, rel)
        if rel.endswith(".png"):
            assert_png_close(g, w)
        elif rel.endswith(".json"):
            with open(w) as fw, open(g) as fg:
                assert_json_close(json.load(fg), json.load(fw), rel)
        elif rel.endswith(".tiff"):
            assert_float_close(jreaders.load_depth(g), jreaders.load_depth(w),
                               rel)
        elif rel.endswith(".pfm"):
            assert_float_close(jreaders.load_pfm(g), jreaders.load_pfm(w), rel)
        elif rel.endswith(".ply"):
            pw, pg = jply.read_pcd(w), jply.read_pcd(g)
            for k in ("points", "colors", "normals"):
                np.testing.assert_allclose(getattr(pg, k), getattr(pw, k),
                                           rtol=0, atol=1e-6, err_msg=rel)
        elif rel.endswith("cameras.bin"):
            cw, cg = jcm.read_cameras_binary(w), jcm.read_cameras_binary(g)
            assert sorted(cg) == sorted(cw)
            for k in cw:
                assert (cg[k].model, cg[k].width, cg[k].height) == (
                    cw[k].model, cw[k].width, cw[k].height)
                np.testing.assert_allclose(cg[k].params, cw[k].params,
                                           rtol=0, atol=1e-6)
        elif rel.endswith("images.bin"):
            iw, ig = jcm.read_images_binary(w), jcm.read_images_binary(g)
            assert sorted(ig) == sorted(iw)
            for k in iw:
                assert (ig[k].name, ig[k].camera_id) == (iw[k].name,
                                                         iw[k].camera_id)
                for f in ("qvec", "tvec"):
                    np.testing.assert_allclose(getattr(ig[k], f),
                                               getattr(iw[k], f), rtol=0,
                                               atol=1e-6)
        elif rel.endswith("points3D.bin"):
            for a, b in zip(jcm.read_points3d_binary(g),
                            jcm.read_points3d_binary(w)):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        else:
            raise AssertionError(f"unexpected file {rel}")


@pytest.mark.parametrize("fmt", FORMATS)
def test_texgs_reads_the_port_scene(written, fmt):
    """texgs's reader on the port's files gives the cameras and clouds it
    gives on its own script's files."""
    bg = [0.0, 0.0, 0.0]
    read = {"blender": lambda p: jreaders.read_blender_scene(p, bg, True),
            "colmap": lambda p: jreaders.read_colmap_scene(p, None, True),
            "neilf": lambda p: jreaders.read_neilf_scene(p, bg, True)}[fmt]
    want_root, got_root = written[fmt]
    want, got = read(want_root), read(got_root)
    assert len(got.train_cameras) == len(want.train_cameras) > 0
    assert len(got.test_cameras) == len(want.test_cameras)
    for g, w in zip(got.train_cameras + got.test_cameras,
                    want.train_cameras + want.test_cameras):
        assert g.image_name == w.image_name
        np.testing.assert_allclose(g.R, w.R, rtol=0, atol=1e-6)
        np.testing.assert_allclose(g.T, w.T, rtol=0, atol=1e-6)
        assert abs(g.FovX - w.FovX) <= 1e-6 and abs(g.FovY - w.FovY) <= 1e-6
        assert g.image.shape == w.image.shape == (32, 32, 3)
        assert np.abs(g.image - w.image).max() <= 1.0 / 255 + 1e-6
    np.testing.assert_allclose(got.point_cloud.points, want.point_cloud.points,
                               rtol=0, atol=1e-6)


def test_port_trains_stage1_from_the_written_scene(written, tmp_path):
    """The port's stage 1, 20 iterations of synthetic_smoke.yaml, from the
    port-written Blender scene read through the port's Scene."""
    from texgs_torch.config import load_config
    from texgs_torch.train import driver

    cfg = load_config(os.path.join(REPO, "configs", "synthetic_smoke.yaml"))
    cfg.dataset_cfg.data_root_dir = written["blender"][1]
    cfg.work_dir = str(tmp_path)
    os.makedirs(tmp_path / "checkpoints")
    cfg.debug = False
    cfg.train_cfg.update(num_iterations=20, visual_iters=[20], ckpt_iters=[20],
                         densify_from_iter=5, densification_interval=10,
                         densify_until_iter=15)
    cfg.loss_cfg.update(norm_range=[0, None], norm_smooth_range=[0, None],
                        opacity_reg_range=[0, None])
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        model, scene, ev = driver.train(
            cfg, logging.getLogger("texgs-torch-make-dataset"),
            progress=False, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert len(scene.getTrainCameras()) == 3
    assert len(scene.getTestCameras()) == 1
    assert scene.scene_info.point_cloud.points.shape == (256, 3)
    assert np.isfinite(ev["test"]["psnr"]) and ev["test"]["psnr"] > 5.0
    assert os.path.exists(tmp_path / "pcds" / "20.ply")
