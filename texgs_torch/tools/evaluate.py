"""Render a checkpoint over a scene split and report PSNR, SSIM, L1, the
normal maps' angular error and, where the ``lpips`` package is installed,
LPIPS and the paper's avg_error (port of texgs/tools/evaluate.py).

    python -m texgs_torch.tools.evaluate <config> --ckpt CKPT
        [--split test|train] [--out metrics.json] [--save_images DIR]
        [--device cuda|cpu]

It runs on the card unless ``--device cpu`` is given.  The scene comes from
the config's ``dataset_cfg``; the port reads ``synthetic://`` roots only
(data/scene.py).
"""

from __future__ import annotations

import json
import os

import numpy as np


def evaluate(cfg, ckpt_path: str, split: str = "test", out_path=None,
             save_images=None, log=None, device="cuda"):
    """Returns (summary, per-view rows); writes them as JSON to
    ``out_path`` and the clipped renders as PNGs into ``save_images``."""
    import torch

    from texgs_torch.data.scene import create_dataset
    from texgs_torch.io import png
    from texgs_torch.losses import l1_loss, ssim_loss
    from texgs_torch.train.models import load_model
    from texgs_torch.utils import metrics
    from texgs_torch.utils.logger import get_logger

    log = log or get_logger()
    work_dir = os.path.dirname(out_path) if out_path else "."
    model, iteration = load_model(cfg, ckpt_path, device)

    scene = create_dataset(cfg.dataset_cfg, log, work_dir,
                           bool(cfg.get_or("debug", False)), device)
    cams = (scene.getTestCameras() if split == "test"
            else scene.getTrainCameras())
    if not cams:
        raise ValueError(f"no cameras in split {split}")

    def on_device(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    rows = []
    with torch.no_grad():
        for idx, vp in enumerate(cams):
            pkg = model.visual_step(iteration or 0, 0, vp, None)
            image = torch.clamp(pkg["image"], 0.0, 1.0)
            gt = torch.clamp(on_device(vp.image), 0.0, 1.0)
            row = {"view": vp.image_name or str(idx),
                   "psnr": float(metrics.psnr(image, gt).mean()),
                   "ssim": float(ssim_loss(image, gt)),
                   "l1": float(l1_loss(image, gt))}
            lp = metrics.lpips(image, gt)
            if lp is not None:
                row["lpips"] = lp
            if vp.normal is not None and "norm" in pkg:
                mask = None if vp.alpha_mask is None else on_device(vp.alpha_mask)
                row["normal_mae_deg"] = float(metrics.mae(
                    pkg["norm"], on_device(vp.normal), mask))
            rows.append(row)
            if save_images:
                os.makedirs(save_images, exist_ok=True)
                png.write(os.path.join(save_images, f"{idx:05d}.png"),
                          (image.cpu().numpy().transpose(1, 2, 0) * 255)
                          .astype(np.uint8))
            log.info(f"[{row['view']}] psnr {row['psnr']:.2f} "
                     f"ssim {row['ssim']:.4f}")

    summary = {"split": split, "n_views": len(rows), "iteration": iteration}
    for k in ("psnr", "ssim", "l1"):
        summary[k] = float(np.mean([r[k] for r in rows]))
    if all("lpips" in r for r in rows):
        summary["lpips"] = float(np.mean([r["lpips"] for r in rows]))
        summary["avg_error"] = metrics.avg_error(
            summary["psnr"], summary["ssim"], summary["lpips"])
    log.info(f"== {split}: PSNR {summary['psnr']:.2f} "
             f"SSIM {summary['ssim']:.4f} over {len(rows)} views ==")
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"summary": summary, "views": rows}, f, indent=1)
    return summary, rows


def main(argv=None):
    from argparse import ArgumentParser

    from texgs_torch.config import load_config

    parser = ArgumentParser(description="Evaluate a checkpoint")
    parser.add_argument("config")
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--split", default="test", choices=["test", "train"])
    parser.add_argument("--out", default=None)
    parser.add_argument("--save_images", default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    cfg.debug = False
    return evaluate(cfg, args.ckpt, args.split, args.out, args.save_images,
                    device=args.device)


if __name__ == "__main__":
    main()
