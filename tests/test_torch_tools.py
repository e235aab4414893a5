"""The port's serving tools (texgs_torch/tools: extract_texture, evaluate,
retexture, viewer) and its PNG codec against texgs's.

Both packages' tools run on one texgs-written stage-3 checkpoint (a
capacity-padded model, its optimiser state included) and one config whose
scene is ``synthetic://sphere``.  The model renders with ``backend: scan``
and ``tex_backend: xla``: texgs's XLA two-pass render, which the port's
two-kernel path computes (its plain versions on the CPU).  texgs renders a
synthetic scene's ground truth with its dense oracle and the port with its
tiled render, which agree only at the oracle's tolerance, so the port's
tools read texgs's scene here: the comparison is then of the tools alone.
Tolerances: metrics within 1e-4 (PSNR in dB, SSIM, L1) and normal angles
within 1e-3 degrees; images decoded from the two packages' PNGs within one
8-bit step; the cube cross exactly.
"""

import json
import logging
import threading
import urllib.request

import imageio.v2 as imageio
import numpy as np
import pytest
import torch
import yaml

import tests.test_torch_render_stage3 as render3
from texgs.config import load_config as jax_load_config
from texgs.io import checkpoint as jckpt
from texgs_torch.config import load_config
from texgs_torch.io import png

N_VIEWS, SIZE = 8, 32
LOG = logging.getLogger("texgs-tools-test")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """The port's renders on two torch threads: beside the other test
    workers, one on every core slows the whole run more than this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(config path, checkpoint path, texgs's scene info, work dir)."""
    work = tmp_path_factory.mktemp("tools")
    jmodel = render3.build_jax_model()
    ckpt = str(work / "stage3" / "ckpt")
    jckpt.save(ckpt, jmodel.state_dict(), iteration=5000)
    optim = jax_load_config(render3.REPO / "configs" / "prod_texture.yaml"
                            ).optim_cfg.to_dict()
    cfg = {
        "dataset_cfg": {"type": "scene",
                        "data_root_dir": f"synthetic://sphere?n=1500&views="
                                         f"{N_VIEWS}&size={SIZE}",
                        "background": render3.BG, "shuffle": False,
                        "resolution": 1, "resolution_scales": [1.0]},
        "model_cfg": dict(render3.MODEL_CFG, type="TextureGaussian3D",
                          backend="scan", tex_backend="xla"),
        "train_cfg": {},
        "optim_cfg": optim,
    }
    path = work / "stage3.yaml"
    path.write_text(yaml.safe_dump(cfg))
    from texgs.data.synthetic_scene import make_synthetic_scene_info
    info = make_synthetic_scene_info(cfg["dataset_cfg"]["data_root_dir"],
                                     jax_load_config(path).dataset_cfg)
    return str(path), ckpt, info, work


@pytest.fixture
def texgs_scene(setup, monkeypatch):
    """The port's Scene reads texgs's scene info."""
    from texgs_torch.data import synthetic_scene

    info = setup[2]
    monkeypatch.setattr(synthetic_scene, "make_synthetic_scene_info",
                        lambda uri, cfg, debug=False, device="cuda": info)


def assert_images_close(got: np.ndarray, want: np.ndarray, name: str):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, f"{name}: {int((diff > 1).sum())} values off"


def test_extract_texture_matches_jax(setup, tmp_path):
    from texgs.tools.extract_texture import extract_texture as jax_tool
    from texgs_torch.tools.extract_texture import main

    path, ckpt, _, _ = setup
    want = np.asarray(jax_tool(jax_load_config(path), ckpt,
                               str(tmp_path / "jax.png"), log=LOG))
    got = main([path, "--ckpt", ckpt, "--out", str(tmp_path / "port.png"),
                "--device", "cpu"])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(png.read(str(tmp_path / "port.png")),
                                  imageio.imread(str(tmp_path / "jax.png")))


def test_evaluate_matches_jax(setup, texgs_scene, tmp_path):
    from texgs.tools.evaluate import evaluate as jax_tool
    from texgs_torch.tools.evaluate import main

    path, ckpt, _, _ = setup
    jcfg = jax_load_config(path)
    jcfg.debug = False
    jax_tool(jcfg, ckpt, "test", str(tmp_path / "jax.json"),
             str(tmp_path / "jax_img"), log=LOG)
    summary, rows = main([path, "--ckpt", ckpt, "--out",
                          str(tmp_path / "port.json"), "--save_images",
                          str(tmp_path / "port_img"), "--device", "cpu"])
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert got["summary"] == summary and got["views"] == rows
    assert set(got["summary"]) == set(want["summary"])
    assert got["summary"]["n_views"] == want["summary"]["n_views"] >= 1
    assert got["summary"]["iteration"] == want["summary"]["iteration"] == 5000
    for a, b in zip(got["views"], want["views"]):
        assert set(a) == set(b) and a["view"] == b["view"]
        for k in ("psnr", "ssim", "l1"):
            np.testing.assert_allclose(a[k], b[k], atol=1e-4, err_msg=k)
        np.testing.assert_allclose(a["normal_mae_deg"], b["normal_mae_deg"],
                                   atol=1e-3)
        assert np.isfinite(a["psnr"]) and 0 < a["ssim"] <= 1
    for k in ("psnr", "ssim", "l1"):
        np.testing.assert_allclose(got["summary"][k], want["summary"][k],
                                   atol=1e-4, err_msg=k)
    assert_images_close(png.read(str(tmp_path / "port_img" / "00000.png")),
                        imageio.imread(str(tmp_path / "jax_img" / "00000.png")),
                        "saved image")


def test_retexture_matches_jax(setup, texgs_scene, tmp_path):
    from texgs.tools.retexture import retexture as jax_tool
    from texgs_torch.tools.retexture import main

    path, ckpt, _, _ = setup
    res = render3.MODEL_CFG["tex_cfg"]["resolution"]
    cross = np.random.default_rng(1).integers(
        0, 256, size=(3 * res, 4 * res, 3), dtype=np.uint8)
    tex = str(tmp_path / "cross.png")
    imageio.imwrite(tex, cross)
    jcfg = jax_load_config(path)
    jcfg.debug = False
    jmodel, want = jax_tool(jcfg, ckpt, str(tmp_path / "jax"), tex, mode=1,
                            log=LOG)
    model, got = main([path, "--ckpt", ckpt, "--out", str(tmp_path / "port"),
                       "--load_texture_from", tex, "--mode", "1",
                       "--device", "cpu"])
    np.testing.assert_allclose(model.texture.numpy(),
                               np.asarray(jmodel.tex_params["texture"]),
                               rtol=1e-5, atol=1e-5)
    assert {k: len(v) for k, v in got.items()} == {
        "train": N_VIEWS - 1, "test": 1}
    for split in ("train", "test"):
        for a, b in zip(got[split], want[split]):
            assert_images_close(png.read(a), imageio.imread(b), a)


def test_retexture_resizes_like_pil():
    """A texture of another size is resized to the cube cross as texgs's
    PIL call does, to within a few 8-bit steps (another bicubic filter)."""
    from PIL import Image

    from texgs_torch.tools.retexture import resize_cross

    rng = np.random.default_rng(2)
    img = (np.kron(rng.uniform(size=(12, 16, 3)), np.ones((10, 10, 1)))
           ).astype(np.float32)
    pil = Image.fromarray((img * 255).astype(np.uint8))
    want = np.asarray(pil.resize((64, 48)), np.float32) / 255.0
    got = resize_cross(img, 48, 64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 4 / 255 + 1e-6
    assert np.abs(got - want).mean() <= 0.5 / 255


def test_viewer_frames_match_jax(setup):
    """ViewerState.render_frame in every mode against texgs's, and one GET
    of /frame from the port's server on an ephemeral port."""
    from texgs.tools.viewer import ViewerState as JaxViewerState
    from texgs.train.texture_gaussian3d import TextureGaussian3D as JaxModel
    from texgs_torch.tools.viewer import ViewerState, make_server
    from texgs_torch.train.models import load_model

    path, ckpt, _, work = setup
    jcfg = jax_load_config(path)
    jmodel = JaxModel(jcfg.model_cfg, LOG, str(work))
    jmodel.bind_train_cfg(jcfg.train_cfg, jcfg.dataset_cfg.background)
    jmodel.load_state_dict(jckpt.load(ckpt)[0], jcfg.optim_cfg)
    model, iteration = load_model(load_config(path), ckpt, "cpu")
    assert iteration == 5000
    want_state = JaxViewerState(jmodel, 40, 32)
    state = ViewerState(model, 40, 32)
    for mode in ("rgb", "depth", "alpha", "norm"):
        args = (0.4, 0.3, 3.5, mode, 1.0, 55.0)
        assert_images_close(state.render_frame(*args),
                            want_state.render_frame(*args), mode)

    server = make_server(state, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/frame?az=0.4&el=0.3&r=3.5&mode=rgb"
                "&scale=1&fov=55", timeout=60) as resp:
            assert resp.headers["Content-Type"] == "image/png"
            frame = png.decode(resp.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                    timeout=60) as resp:
            assert b"<canvas" in resp.read()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    np.testing.assert_array_equal(
        frame, state.render_frame(0.4, 0.3, 3.5, "rgb", 1.0, 55.0))


@pytest.mark.parametrize("channels", [3, 4])
def test_png_round_trips_against_imageio(channels, tmp_path):
    rng = np.random.default_rng(channels)
    smooth = np.cumsum(rng.integers(0, 3, size=(37, 53, channels)), 1)
    for name, img in (("noise", rng.integers(0, 256, size=(37, 53, channels))),
                      ("smooth", smooth % 256)):
        img = img.astype(np.uint8)
        png.write(str(tmp_path / f"{name}_port.png"), img)
        np.testing.assert_array_equal(
            imageio.imread(str(tmp_path / f"{name}_port.png")), img)
        imageio.imwrite(str(tmp_path / f"{name}_io.png"), img)
        np.testing.assert_array_equal(
            png.read(str(tmp_path / f"{name}_io.png")), img)


def _filtered_png(img: np.ndarray, kinds) -> bytes:
    """A PNG whose row y is written with filter type kinds[y], by the
    forward filters of the PNG specification (section 9.2)."""
    import struct
    import zlib

    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(int)
    rows = []
    for y in range(h):
        prev = x[y - 1] if y else np.zeros(w * c, int)
        a = np.concatenate([np.zeros(c, int), x[y, :-c]])
        cc = np.concatenate([np.zeros(c, int), prev[:-c]])
        p = a + prev - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, prev, cc))
        pred = {0: 0, 1: a, 2: prev, 3: (a + prev) // 2, 4: paeth}[kinds[y]]
        rows.append(bytes([kinds[y]]) + ((x[y] - pred) % 256)
                    .astype(np.uint8).tobytes())
    color = {3: 2, 4: 6}[c]

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))
    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
def test_png_reads_all_five_filter_types(channels):
    img = np.random.default_rng(7).integers(0, 256, size=(15, 9, channels),
                                            dtype=np.uint8)
    kinds = [y % 5 for y in range(15)]
    np.testing.assert_array_equal(png.decode(_filtered_png(img, kinds)), img)


def test_png_rejects_what_it_does_not_read():
    with pytest.raises(ValueError):
        png.decode(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError):
        png.encode(np.zeros((4, 4), np.uint8))
