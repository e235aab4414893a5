"""texgs_torch/tools/prod_pipeline.py against scripts/run_prod_pipeline.py.

The script is loaded by path (it imports only os, subprocess and sys at
its top) and its functions run with its output root ``OUT`` pointed at a
temporary directory.

* ``scale_cfg``: each production config at div 1 and 10, with and without
  a model_cfg patch, loads to the same dict as the script's; a data root
  changes only dataset_cfg.data_root_dir.
* ``_parse_evals`` and ``write_metrics`` on TextureGS.log files that the
  port's training command line wrote, three runs in one process: the same
  dicts and the same JSON as the script's, merging into an existing file
  too.  Each run writes its own log (a second run in a process used to
  log into the first run's file).
* ``link_latest`` and ``latest_ckpt`` pick the newest run and the highest
  checkpoint, as the script's do.
* ``main`` end to end on the CPU: the golden's tiny scene
  (tests/test_pipeline_3stage.py's ``--n 512 --views 6 --test_views 2
  --size 48``), every stage cut to ITERS iterations with one evaluation
  and one checkpoint at the end, and the production model widths cut (a
  32^2 cubemap, 64-wide UV nets, 512 inverse points), so that it takes
  seconds: at the schedules' 50-iteration floor the plain versions take
  about 90 s on one thread.  Every stage's checkpoint, the point cloud and
  the metrics file are written, and each stage is evaluated.  The
  pipeline at full width and its --quick schedules runs on the card
  (chip_smoke.py phase 24).
"""

import importlib.util
import json
import os

import pytest
import torch
import yaml

from texgs_torch.tools import prod_pipeline as pp
from tests.torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("prod_stage1.yaml", "prod_uv_map.yaml", "prod_texture.yaml")
PATCH = {"init_from": "/ckpt/prod_stage1/latest/checkpoints/7500",
         "pcd_load_from": "/ckpt/prod_stage1/latest/pcd.npy"}
RUNS = ("prod_stage1", "prod_uv_map", "prod_texture")
TINY_SCENE = ["--n", "512", "--views", "6", "--test_views", "2", "--size",
              "48", "--init_ply"]
ITERS = 5


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "run_prod_pipeline", os.path.join(ROOT, "scripts",
                                          "run_prod_pipeline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(path):
    with open(path) as f:
        return yaml.safe_load(f)


@pytest.mark.parametrize("patch", [None, PATCH], ids=["plain", "patched"])
@pytest.mark.parametrize("div", [1, 10])
@pytest.mark.parametrize("config", CONFIGS)
def test_scale_cfg_matches_texgs(script, tmp_path, config, div, patch):
    path = os.path.join(ROOT, "configs", config)
    want = script.scale_cfg(path, div, str(tmp_path / "texgs"), patch)
    got = pp.scale_cfg(path, div, str(tmp_path / "port"), patch)
    assert os.path.basename(got) == config
    assert load(got) == load(want)
    root = pp.scale_cfg(path, div, str(tmp_path / "root"), patch,
                        data_root="/data/checker_prod")
    moved = load(root)
    assert moved["dataset_cfg"].pop("data_root_dir") == "/data/checker_prod"
    expect = load(want)
    expect["dataset_cfg"].pop("data_root_dir")
    assert moved == expect


def test_scale_cfg_quick_schedules(tmp_path):
    """The --quick schedules of the stage-3 config, by hand."""
    cfg = load(pp.scale_cfg(os.path.join(ROOT, "configs",
                                         "prod_texture.yaml"), 10,
                            str(tmp_path)))
    assert cfg["train_cfg"]["num_iterations"] == 1000
    assert cfg["train_cfg"]["visual_iters"] == [250, 500, 1000]
    assert cfg["train_cfg"]["min_scale_reset_interval"] == 25
    assert cfg["optim_cfg"]["gaussian_optim_range"] == [250, None]
    assert cfg["optim_cfg"]["uv_net_milestones"] == [250, 500]
    assert cfg["optim_cfg"]["position_lr_max_steps"] == 750
    assert cfg["loss_cfg"]["rgb_no_sh_range"] == [250, None]


@pytest.fixture(scope="module")
def logged(tmp_path_factory):
    """Three runs of the port's training command line in this process,
    one under each stage's run name, each 4 iterations of a tiny
    synthetic_smoke.yaml with evaluations at 2 and 4; each run's
    directory linked as its stage's latest."""
    from texgs_torch.train import driver
    from texgs_torch.train.__main__ import main as train

    out = tmp_path_factory.mktemp("logged")
    cfg = load(os.path.join(ROOT, "configs", "synthetic_smoke.yaml"))
    cfg["dataset_cfg"]["data_root_dir"] = "synthetic://blob?n=256&views=4&size=32"
    cfg["train_cfg"].update(num_iterations=4, visual_iters=[2, 4],
                            ckpt_iters=[4], densify_until_iter=0)
    path = out / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(driver, "tb_writer_for", lambda *args: None)
        for run in RUNS:
            train([str(path), "--run_name", run, "--workspace", str(out),
                   "--device", "cpu"])
            pp.link_latest(str(out), run)
    return out


def test_each_run_in_a_process_writes_its_own_log(logged):
    for run in RUNS:
        text = (logged / run / "latest" / "TextureGS.log").read_text()
        folders = [line for line in text.splitlines() if "Work folder" in line]
        assert len(folders) == 1 and f"/{run}/" in folders[0], run
        assert text.count("Evaluating test") == 2, run


def test_parse_evals_matches_texgs(script, logged, monkeypatch):
    monkeypatch.setattr(script, "OUT", str(logged))
    for run in RUNS:
        got = pp._parse_evals(str(logged), run)
        assert got == script._parse_evals(run)
        assert set(got) == {"test", "train"}
        assert got["test"]["iter"] == 4 and got["test"]["psnr"] > 0


@pytest.mark.parametrize("quick", [False, True], ids=["full", "quick"])
def test_write_metrics_matches_texgs(script, logged, monkeypatch, quick):
    monkeypatch.setattr(script, "OUT", str(logged))
    path = logged / "pipeline_prod_metrics.json"
    before = {"full": {"stage1": {}}, "quick_div10": {"old": 1}, "other": 2}
    results = []
    for write in (lambda: script.write_metrics(quick),
                  lambda: pp.write_metrics(str(logged), quick)):
        path.write_text(json.dumps(before))
        write()
        results.append(json.loads(path.read_text()))
    want, got = results
    assert got == want
    key = "quick_div10" if quick else "full"
    assert set(got) == {"full", "quick_div10", "other"}
    assert set(got[key]) == {"stage1", "uv_map", "texture",
                             "stage3_minus_stage1_db"}
    path.unlink()
    assert pp.write_metrics(str(logged), quick) == {key: got[key]}
    assert json.loads(path.read_text()) == {key: got[key]}


def test_link_latest_and_latest_ckpt_match_texgs(script, tmp_path,
                                                 monkeypatch):
    monkeypatch.setattr(script, "OUT", str(tmp_path))
    base = tmp_path / "prod_uv_map"
    for run in ("2026-01-02_09-00-00", "2026-01-10_08-00-00",
                "2026-01-09_23-59-59"):
        (base / run / "checkpoints").mkdir(parents=True)
    (base / "stray.txt").write_text("not a run")
    os.symlink("2026-01-02_09-00-00", base / "latest")
    ckpts = base / "2026-01-10_08-00-00" / "checkpoints"
    for name in ("50.npz", "50__meta__.json", "200.npz", "1000.npz",
                 "999.npz"):
        (ckpts / name).write_text("")
    for link in (lambda: script.link_latest("prod_uv_map"),
                 lambda: pp.link_latest(str(tmp_path), "prod_uv_map")):
        link()
        assert os.readlink(base / "latest") == "2026-01-10_08-00-00"
    want = script.latest_ckpt("prod_uv_map")
    assert pp.latest_ckpt(str(tmp_path), "prod_uv_map") == want
    assert want == str(base / "latest" / "checkpoints" / "1000")


def test_main_end_to_end_on_a_tiny_scene(tmp_path, monkeypatch):
    from texgs_torch.train import driver

    scale = pp.scale_cfg

    def small(path, div, workdir, patch=None, data_root=None):
        out = scale(path, div, workdir, patch, data_root)
        cfg = load(out)
        cfg["train_cfg"].update(num_iterations=ITERS, visual_iters=[ITERS],
                                ckpt_iters=[ITERS])
        model = cfg["model_cfg"]
        if "uv_net_cfg" in model:
            model["max_inverse_points"] = 512
            model["inv_uv_net_cfg"]["n_sample_points"] = 256
            model["geo_emb_dim"] = 64
            for net in ("uv_net_cfg", "inv_uv_net_cfg"):
                model[net]["emb_dim"] = 64
                for mlp in ("pre_mlp_cfg", "mlp_cfg"):
                    model[net][mlp]["n_neurons"] = 64
        if "tex_cfg" in model:
            model["tex_cfg"]["resolution"] = 32
        with open(out, "w") as f:
            yaml.safe_dump(cfg, f)
        return out

    monkeypatch.setattr(pp, "DATASET_ARGS", TINY_SCENE)
    monkeypatch.setattr(pp, "QUICK_DIV", 1000)
    monkeypatch.setattr(pp, "scale_cfg", small)
    # no TensorBoard event files (tensorboardX, where it is installed,
    # writes them through a process of its own)
    monkeypatch.setattr(driver, "tb_writer_for", lambda *args: None)
    result = pp.main(["--quick", "--workspace", str(tmp_path), "--device",
                      "cpu"])
    assert set(result["stages"]) == {"dataset", "prod_stage1", "extract_pcd",
                                     "prod_uv_map", "prod_texture"}
    assert (tmp_path / "data" / "checker_prod" / "points3d.ply").exists()
    assert (tmp_path / "prod_stage1" / "latest" / "pcd.npy").exists()
    for run in RUNS:
        ckpt = tmp_path / run / "latest" / "checkpoints" / f"{ITERS}.npz"
        assert ckpt.exists(), run
    metrics = json.loads((tmp_path / "pipeline_prod_metrics.json").read_text())
    assert metrics == result["metrics"]
    entry = metrics["quick_div1000"]
    for stage in ("stage1", "uv_map", "texture"):
        assert entry[stage]["test"]["iter"] == ITERS, stage
        assert entry[stage]["test"]["psnr"] > 0, stage
    assert entry["stage3_minus_stage1_db"] == round(
        entry["texture"]["test"]["psnr"] - entry["stage1"]["test"]["psnr"], 3)
