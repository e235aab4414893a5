"""The port's measurement tools against texgs's, on the CPU.

``texgs_torch.tools.roofline`` counts the same work as
``texgs.tools.roofline`` (every component's FLOPs and bytes equal, integer
for integer; the units renamed from the TPU's engines to the kinds of
work) and reads it against the H100's f32 peak; ``verify_compiled``'s
``_rel_err`` is texgs's; its plain twin built over bands of tile rows
gives the whole-frame twin's gradient (1e-6 of the gradient's max: only
the order of the f32 sums differs); the verifier refuses a kernel side
corrupted in one tile row and passes the untouched one (not compiled on
the CPU); ``bench_stage3.measure`` and the bench's stage-1 line run at a
tiny shape; the driver writes a profiler trace over its window and reads
the host's RSS; the training command line takes ``--debug_nans`` and
``--profile_dir``; ``create_render_func`` maps texgs's render types.
"""

import importlib
import json
import math

import numpy as np
import pytest
import torch

from texgs.tools import roofline as jax_roofline
from texgs.tools.verify_compiled import _rel_err as jax_rel_err
from texgs_torch.tools import roofline, verify_compiled

UNITS = {"mxu": "matmul", "vpu": "elementwise", "hbm": "memory"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the tier-1 run shares the machine's cores among
    several workers, and torch's CPU kernels slow down many times over
    when their threads outnumber the cores; one thread also makes the
    f32 sums repeat from run to run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
# (n, n_pairs, width, height, stage-3 keywords): texgs's __main__ shape,
# one at tex_res 512 and m 16, one small
SHAPES = [(100_000, 500_000, 800, 600, {}),
          (20_000, 123_457, 640, 480, {"tex_res": 512, "m": 16}),
          (512, 1_794, 64, 48, {"tex_res": 16, "sh_deg": 2,
                                 "mlp_width": 64, "n_inv": 1024})]


@pytest.mark.parametrize("shape", SHAPES, ids=["main", "tex512_m16", "small"])
def test_roofline_counts_equal_texgs(shape):
    n, pairs, w, h, kw = shape
    stage1_kw = {"sh_deg": kw["sh_deg"]} if "sh_deg" in kw else {}
    for ours, theirs in (
            (roofline.stage1_counts(n, pairs, w, h, **stage1_kw),
             jax_roofline.stage1_counts(n, pairs, w, h, **stage1_kw)),
            (roofline.stage3_counts(n, pairs, w, h, **kw),
             jax_roofline.stage3_counts(n, pairs, w, h, **kw))):
        assert list(ours) == list(theirs)
        for k, c in theirs.items():
            assert ours[k]["flops"] == c["flops"], k
            assert ours[k]["bytes"] == c["bytes"], k
            assert ours[k]["unit"] == UNITS[c["unit"]], k


@pytest.mark.parametrize("dt", [0.040, 0.341, 1e-5])
def test_summarize_against_texgs_and_the_h100_peaks(dt):
    comps = roofline.stage3_counts(100_000, 500_000, 800, 600)
    ours = roofline.summarize(comps, dt)
    theirs = jax_roofline.summarize(
        jax_roofline.stage3_counts(100_000, 500_000, 800, 600), dt)
    assert ours["gflops_per_step"] == theirs["gflops_per_step"]
    assert ours["hbm_gb_per_step"] == theirs["hbm_gb_per_step"]
    f_tot = sum(c["flops"] for c in comps.values())
    b_tot = sum(c["bytes"] for c in comps.values())
    assert roofline.H100_F32_FLOPS == 67e12
    assert roofline.H100_BYTES_PER_S == 3.35e12
    assert ours["mfu_pct"] == round(f_tot / dt / 67e12 * 100, 2)
    assert ours["hbm_util_pct"] == round(b_tot / dt / 3.35e12 * 100, 1)
    t_flops, t_hbm = f_tot / 67e12, b_tot / 3.35e12
    assert ours["t_flops_ms"] == round(t_flops * 1e3, 3)
    assert ours["t_hbm_ms"] == round(t_hbm * 1e3, 3)
    assert ours["bound"] == ("flops" if t_flops >= t_hbm else "memory")
    assert ours["step_ms"] == round(dt * 1e3, 1)
    # a component table row per component, with the renamed units
    rows = roofline.table(comps).splitlines()[2:]
    assert [r.split("|")[4].strip() for r in rows] == [
        c["unit"] for c in comps.values()]


def test_summarize_bound_picks_the_larger_time():
    flops_heavy = {"x": {"flops": 67e9, "bytes": 1e6, "unit": "matmul"}}
    bytes_heavy = {"x": {"flops": 1e6, "bytes": 3.35e9, "unit": "memory"}}
    assert roofline.summarize(flops_heavy, 1.0)["bound"] == "flops"
    assert roofline.summarize(bytes_heavy, 1.0)["bound"] == "memory"


@pytest.mark.parametrize("kind", ["random", "zero_reference"])
def test_rel_err_equals_texgs(kind):
    rng = np.random.default_rng(0)
    got = rng.normal(size=(3, 40, 50)).astype(np.float32)
    ref = (got + rng.normal(size=got.shape) * 1e-3).astype(np.float32)
    if kind == "zero_reference":
        ref = np.zeros_like(ref)
    want = jax_rel_err(got, ref)
    assert verify_compiled._rel_err(got, ref) == want
    assert verify_compiled._rel_err(torch.as_tensor(got),
                                    torch.as_tensor(ref)) == want


def _plain_gradients(backend, groups):
    """The twin's gradients of verify_uvtex at 512 Gaussians, 64x64 and a
    16^2 cubemap, over ``groups`` bands of tile rows."""
    got = {}
    run = verify_compiled.kernel_and_plain

    def spy(*args, **kw):
        kernel, plain, n_groups = run(*args, **kw)
        got["grads"], got["groups"] = plain[0], n_groups
        return kernel, plain, n_groups

    verify_compiled.kernel_and_plain = spy
    try:
        ok, _ = verify_compiled.verify_uvtex(512, 64, 64, 16, device="cpu",
                                             backend=backend, groups=groups)
    finally:
        verify_compiled.kernel_and_plain = run
    assert ok
    return got["grads"], got["groups"]


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_tiled_plain_gradient_equals_the_whole_frame(backend):
    # on one thread (the module's fixture) only the bands reorder the sums
    whole, n1 = _plain_gradients(backend, 1)
    tiled, n4 = _plain_gradients(backend, 4)
    assert (n1, n4) == (1, 4)
    for k, g in whole.items():
        scale = g.abs().max().item()
        assert scale > 0, k
        err = (tiled[k] - g).abs().max().item()
        assert err <= 1e-6 * scale, (k, err / scale)


def _corrupt_one_tile_row(monkeypatch):
    """Kernel B's output plus 0.05 in the image rows of tile row 1."""
    from texgs_torch.kernels import tex_term as kt

    clean = kt.tex_term

    def corrupted(*args):
        img = clean(*args)
        return img + torch.where(
            (torch.arange(img.shape[1], device=img.device) // 16 == 1)[:, None],
            0.05, 0.0)
    corrupted.launches = 0  # kernel B's wrapper counts through this name
    monkeypatch.setattr(kt, "tex_term", corrupted)


def test_verifier_refuses_a_corrupted_tile_row(monkeypatch):
    _corrupt_one_tile_row(monkeypatch)
    ok, results = verify_compiled.verify_uvtex(512, 64, 64, 16, device="cpu",
                                               backend="auto", groups=1)
    assert not ok
    assert results["fwd_image"] > verify_compiled.REL_TOL_FWD


def test_verifier_main_on_the_cpu(monkeypatch, capsys):
    for k, v in (("VERIFY_N", "512"), ("VERIFY_W", "64"), ("VERIFY_H", "48"),
                 ("VERIFY_TEX", "16")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(verify_compiled, "TEX_TERM_TILES", 16)
    assert verify_compiled.main(["--device", "cpu"]) == 0
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert verdict["ok"] is True and verdict["compiled"] is False
    assert verdict["backend"] == "cpu"
    assert verdict["shapes"] == {"n_gauss": 512, "width": 64, "height": 48,
                                 "tex_res": 16, "m": 32}
    for check in ("raster", "uvtex", "uvtex_fused", "tex_term"):
        assert verdict[check]["ok"] is True
    for check in ("raster", "uvtex", "uvtex_fused"):
        assert verdict[check]["plain_tile_groups"] == 1


def test_bench_stage3_measure_on_the_cpu():
    from texgs_torch.tools import bench_stage3

    dt, aux = bench_stage3.measure(512, 64, 48, 16, 3, device="cpu")
    assert math.isfinite(dt) and dt > 0
    assert {"loss0", "n_pairs", "n", "width", "height", "tex_res"} <= set(aux)
    assert aux["n_pairs"] > 0 and math.isfinite(aux["loss0"])
    lo, hi = aux["spread_ms"]
    assert 0 < lo <= dt * 1e3 <= hi


def test_bench_stage1_line_on_the_cpu(monkeypatch):
    from texgs_torch.tools import bench

    for k, v in (("BENCH_N", "512"), ("BENCH_W", "64"), ("BENCH_H", "48"),
                 ("BENCH_ITERS", "3")):
        monkeypatch.setenv(k, v)
    line = bench.stage1_line("cpu")
    assert line["metric"] == "rays_per_s_fwd_bwd_cpu"
    assert line["n_pairs"] > 0
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert line["vs_baseline"] == round(
        line["value"] / bench.BASELINE_RAYS_PER_S, 3)
    # a CPU step at this size rounds the shares of the H100's peaks to 0
    for k in ("mfu_pct", "hbm_util_pct"):
        assert math.isfinite(line[k]) and line[k] >= 0, k
    assert line["analytic_bound"] in ("flops", "memory")


def test_driver_writes_a_trace_over_its_window(tmp_path, monkeypatch):
    import logging

    from texgs_torch.config import load_config
    from texgs_torch.train import driver

    assert driver._host_rss_gib() > 0
    monkeypatch.setattr(driver, "PROFILE_FIRST", 2)
    monkeypatch.setattr(driver, "PROFILE_LAST", 4)
    cfg = load_config("configs/synthetic_smoke.yaml")
    cfg.dataset_cfg.data_root_dir = "synthetic://blob?n=256&views=4&size=32"
    cfg.train_cfg.update(num_iterations=5, visual_iters=[], ckpt_iters=[])
    cfg.work_dir = str(tmp_path / "run")
    cfg.debug = True
    cfg.profile_dir = str(tmp_path / "trace")
    driver.train(cfg, logging.getLogger("texgs-torch-trace"), progress=False,
                 device="cpu")
    trace = tmp_path / "trace" / "trace_2_4.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mul" for e in events)


def test_train_command_line_flags(monkeypatch, tmp_path):
    from texgs_torch.train import __main__ as cli
    from texgs_torch.train import driver

    args = cli.parse_args(["cfg.yaml", "--debug_nans", "--profile_dir", "d"])
    assert args.debug_nans and args.profile_dir == "d"
    args = cli.parse_args(["cfg.yaml"])
    assert not args.debug_nans and args.profile_dir is None

    seen = {}

    def fake_train(cfg, log, tb_writer, device):
        seen.update(anomaly=torch.is_anomaly_enabled(),
                    profile_dir=cfg.profile_dir, device=device)
        return "trained"
    monkeypatch.setattr(driver, "train", fake_train)
    before = torch.is_anomaly_enabled()
    try:
        assert cli.main(["configs/synthetic_smoke.yaml", "--debug",
                         "--debug_nans", "--profile_dir", str(tmp_path),
                         "--device", "cpu"]) == "trained"
        assert seen == {"anomaly": True, "profile_dir": str(tmp_path),
                        "device": "cpu"}
        assert torch.is_anomaly_enabled() == before
        cli.main(["configs/synthetic_smoke.yaml", "--debug", "--device", "cpu"])
        assert seen["anomaly"] is False and seen["profile_dir"] is None
    finally:
        torch.autograd.set_detect_anomaly(before)


def test_create_render_func_maps_texgs_types():
    from texgs.render import create_render_func as jax_create
    from texgs_torch.config import Cfg
    from texgs_torch.render import create_render_func, type2render_func
    from texgs_torch.render.render import render
    from texgs_torch.render.uv_tex_render import uv_tex_render

    assert create_render_func(Cfg({"type": "render"})) is render
    assert create_render_func(Cfg({"type": "uv_tex_render"})) is uv_tex_render
    assert set(type2render_func) == {"render", "uv_tex_render"}
    for make in (create_render_func, jax_create):
        with pytest.raises(KeyError):
            make(Cfg({"type": "mesh_render"}))


def test_render_submodule_still_imports():
    import types

    mod = importlib.import_module("texgs_torch.render.render")
    assert isinstance(mod, types.ModuleType)
    assert mod.render is importlib.import_module("texgs_torch.render").render
