"""The three-stage production pipeline on the checker_prod scene (port of
scripts/run_prod_pipeline.py):

  0. write <output>/data/checker_prod (800x600, 64 + 8 spiral views, the
     50,000-point init) with tools/make_dataset, unless it is there;
  1. stage 1  configs/prod_stage1.yaml  (Gaussian3D, 7,500 iterations),
     then tools/extract_pcd: 8,192 farthest points for the UV nets;
  2. stage 2  configs/prod_uv_map.yaml  (UVMapGaussian3D, 4,000);
  3. stage 3  configs/prod_texture.yaml (TextureGaussian3D, 10,000);

then merges each stage's last test and train evaluation, read from its
TextureGS.log, into <output>/pipeline_prod_metrics.json, texgs's schema.

    python -m texgs_torch.tools.prod_pipeline [--stage N] [--quick]
        [--resume] [--workspace DIR] [--device cuda|cpu]

Each stage's timestamped run directory gets a ``latest`` symlink, through
which the next stage's ``init_from`` paths resolve.  ``--stage N`` starts
at step N (reusing the earlier ``latest`` runs); ``--quick`` divides every
schedule by QUICK_DIV (10); ``--resume`` resumes stage 3 from its latest
checkpoint.  The output root is ``output/`` under the repository unless
``--workspace`` names another.  Every step runs in this process through
its tool's ``main``; each stage's model is freed before the next, and each
stage's seconds and peak device memory are logged.  It runs on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import gc
import json
import os
import re
import time
from argparse import ArgumentParser

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# scripts/run_prod_pipeline.py:115-118: the scene of configs/prod_stage1.yaml
DATASET_ARGS = ["--kind", "checker", "--spiral", "--backend", "scan",
                "--n", "50000", "--views", "64", "--test_views", "8",
                "--width", "800", "--height", "600", "--init_ply"]
QUICK_DIV = 10
EVAL = re.compile(r"\[ITER (\d+)\] Evaluating (\w+): "
                  r"L1 ([\d.]+) PSNR ([\d.]+) SSIM ([\d.]+)")


def link_latest(out: str, run_name: str) -> None:
    """Points <out>/<run_name>/latest at the newest timestamped run."""
    base = os.path.join(out, run_name)
    runs = sorted(d for d in os.listdir(base)
                  if os.path.isdir(os.path.join(base, d)) and d != "latest")
    assert runs, f"no runs under {base}"
    latest = os.path.join(base, "latest")
    if os.path.islink(latest):
        os.unlink(latest)
    os.symlink(runs[-1], latest)
    print(f"{latest} -> {runs[-1]}", flush=True)


def latest_ckpt(out: str, run_name: str) -> str:
    """The newest checkpoints/<iter>.npz of the latest run, without .npz."""
    d = os.path.join(out, run_name, "latest", "checkpoints")
    it = max(int(f.split(".")[0]) for f in os.listdir(d)
             if f.endswith(".npz"))
    return os.path.join(d, str(it))


def scale_cfg(path: str, div: int, workdir: str, patch=None,
              data_root=None) -> str:
    """Writes the runtime variant of the config at ``path`` into
    ``workdir``: ``patch`` merged into its model_cfg, ``data_root`` (where
    given) as its dataset_cfg.data_root_dir, and every schedule divided by
    ``div`` (iterations, evaluations and checkpoints with a floor of 50,
    densify intervals with a floor of 1, milestones, max steps and
    [from, until] ranges).  Returns the written file's path."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    for k, v in (patch or {}).items():
        cfg["model_cfg"][k] = v
    if data_root is not None:
        cfg["dataset_cfg"]["data_root_dir"] = data_root
    if div != 1:
        tc = cfg["train_cfg"]
        tc["num_iterations"] = max(tc["num_iterations"] // div, 50)
        for k in ("visual_iters", "ckpt_iters"):
            tc[k] = [max(v // div, 50) for v in tc[k]]
        for k in ("densify_from_iter", "densify_until_iter",
                  "densification_interval", "opacity_reset_interval",
                  "min_scale_reset_interval"):
            if tc.get(k):
                tc[k] = max(tc[k] // div, 1)
        for sect in ("optim_cfg", "loss_cfg"):
            for k, v in cfg.get(sect, {}).items():
                if k.endswith("milestones"):
                    cfg[sect][k] = [m // div for m in v]
                elif k.endswith("max_steps"):
                    cfg[sect][k] = max(v // div, 50)
                elif (isinstance(v, list) and len(v) == 2
                      and isinstance(v[0], int)):
                    cfg[sect][k] = [v[0] // div,
                                    None if v[1] is None else v[1] // div]
    out = os.path.join(workdir, os.path.basename(path))
    os.makedirs(workdir, exist_ok=True)
    with open(out, "w") as f:
        yaml.safe_dump(cfg, f)
    return out


def run_stage(name: str, fn, argv, device: str) -> dict:
    """Runs ``fn(argv)`` (a tool's main), drops what it returned (the
    stage's model and scene) and returns the step's record: its seconds,
    and on the card its peak device memory and what stays allocated after
    the model is freed, in GiB."""
    import torch

    cuda = torch.device(device).type == "cuda"
    print(f"+ {name}: {' '.join(argv)}", flush=True)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn(argv)
    if cuda:
        torch.cuda.synchronize()
    record = {"seconds": time.perf_counter() - t0}
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        record["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        record["left_gib"] = torch.cuda.memory_allocated() / 2 ** 30
    print(f"  {name}: " + ", ".join(f"{k} {v:.3f}" for k, v in record.items()),
          flush=True)
    return record


def parse_args(argv=None):
    ap = ArgumentParser(description="texgs_torch: the three-stage "
                        "production pipeline on checker_prod")
    ap.add_argument("--stage", type=int, default=0,
                    help="start at: 0=dataset 1/2/3=train stages")
    ap.add_argument("--quick", action="store_true",
                    help=f"divide every schedule by {QUICK_DIV}")
    ap.add_argument("--resume", action="store_true",
                    help="resume the --stage 3 run from its latest "
                         "checkpoint")
    ap.add_argument("--workspace", default=os.path.join(ROOT, "output"),
                    help="the output root (default: output/ under the "
                         "repository)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the pipeline; returns {"metrics": what write_metrics merged,
    "stages": each step's run_stage record}."""
    from texgs_torch.tools import extract_pcd, make_dataset
    from texgs_torch.train.__main__ import main as train

    args = parse_args(argv)
    out = os.path.abspath(args.workspace)
    data = os.path.join(out, "data", "checker_prod")
    div = QUICK_DIV if args.quick else 1
    cfg_dir = os.path.join(out, "_run_cfgs")
    dev = ["--device", args.device]
    common = ["--workspace", out, *dev]
    stages = {}

    def cfgp(name, patch=None):
        return scale_cfg(os.path.join(ROOT, "configs", name), div, cfg_dir,
                         patch, data)

    if args.stage <= 0 and not os.path.exists(
            os.path.join(data, "transforms_train.json")):
        stages["dataset"] = run_stage("dataset", make_dataset.main,
                                      [data, *DATASET_ARGS, *dev],
                                      args.device)

    if args.stage <= 1:
        stages["prod_stage1"] = run_stage(
            "prod_stage1", train, [cfgp("prod_stage1.yaml"), "--run_name",
                                   "prod_stage1", *common], args.device)
        link_latest(out, "prod_stage1")
        stages["extract_pcd"] = run_stage(
            "extract_pcd", extract_pcd.main,
            [latest_ckpt(out, "prod_stage1"), "--num_points", "8192",
             "--out", os.path.join(out, "prod_stage1", "latest", "pcd"),
             *dev], args.device)

    if args.stage <= 2:
        stages["prod_uv_map"] = run_stage("prod_uv_map", train, [
            cfgp("prod_uv_map.yaml", {
                "init_from": latest_ckpt(out, "prod_stage1"),
                "pcd_load_from": os.path.join(out, "prod_stage1", "latest",
                                              "pcd.npy")}),
            "--run_name", "prod_uv_map", *common], args.device)
        link_latest(out, "prod_uv_map")

    if args.stage <= 3:
        extra = []
        if args.resume and args.stage == 3:
            extra = ["--resume_from", latest_ckpt(out, "prod_texture")]
        stages["prod_texture"] = run_stage("prod_texture", train, [
            cfgp("prod_texture.yaml", {
                "init_from": latest_ckpt(out, "prod_stage1"),
                "init_uv_map_from": latest_ckpt(out, "prod_uv_map")}),
            "--run_name", "prod_texture", *common, *extra], args.device)
        link_latest(out, "prod_texture")

    return {"metrics": write_metrics(out, args.quick), "stages": stages}


def _parse_evals(out: str, run_name: str) -> dict:
    """The last '[ITER n] Evaluating test/train: ...' metrics of each set
    in a stage's driver log."""
    path = os.path.join(out, run_name, "latest", "TextureGS.log")
    evals = {}
    with open(path) as f:
        for line in f:
            mm = EVAL.search(line)
            if mm:
                evals[mm.group(2)] = dict(
                    iter=int(mm.group(1)), l1=float(mm.group(3)),
                    psnr=float(mm.group(4)), ssim=float(mm.group(5)))
    return evals


def write_metrics(out: str, quick: bool) -> dict:
    """Merges each stage's final test and train metrics and the stage-3
    minus stage-1 test PSNR into <out>/pipeline_prod_metrics.json, under
    ``full`` or ``quick_div<QUICK_DIV>``.  Returns the merged entry."""
    key = f"quick_div{QUICK_DIV}" if quick else "full"
    m = {key: {"stage1": _parse_evals(out, "prod_stage1"),
               "uv_map": _parse_evals(out, "prod_uv_map"),
               "texture": _parse_evals(out, "prod_texture")}}
    s1 = m[key]["stage1"].get("test", {}).get("psnr")
    s3 = m[key]["texture"].get("test", {}).get("psnr")
    if s1 and s3:
        m[key]["stage3_minus_stage1_db"] = round(s3 - s1, 3)
    path = os.path.join(out, "pipeline_prod_metrics.json")
    merged = {}
    if os.path.exists(path):
        with open(path) as f:
            merged = json.load(f)
    merged.update(m)
    with open(path, "w") as f:
        json.dump(merged, f, indent=1)
    print("metrics ->", path, json.dumps(m), flush=True)
    return m


if __name__ == "__main__":
    main()
