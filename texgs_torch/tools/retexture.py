"""Texture swapping and full-view rendering (port of
texgs/tools/retexture.py): load a stage-3 checkpoint, optionally replace
its texture from a cross-layout cubemap PNG (``change_texture``'s blend
modes), render every train and test view composited over the background
with the ground-truth alpha, and write PNGs.

    python -m texgs_torch.tools.retexture <config> --ckpt CKPT
        [--out ./retexture_out] [--load_texture_from PNG] [--mode 0]
        [--device cuda|cpu]

It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import os

import numpy as np


def resize_cross(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """An (h, w, 3) float image in [0, 1] resized to (height, width) as
    8-bit values, by torch's antialiased bicubic filter.  texgs resizes with
    PIL's default filter; the two differ by a few 8-bit steps near sharp
    edges."""
    import torch
    import torch.nn.functional as F

    img = torch.as_tensor((image * 255).astype(np.uint8), dtype=torch.float32)
    out = F.interpolate(img.permute(2, 0, 1)[None], size=(height, width),
                        mode="bicubic", antialias=True, align_corners=False)
    out = torch.clamp(torch.round(out[0]), 0, 255).permute(1, 2, 0)
    return out.numpy() / 255.0


def render_views(model, cameras, out_dir: str, bg, log=None) -> list:
    """Each camera's clipped render, composited over ``bg`` with its
    ground-truth alpha, as out_dir/<index>.png."""
    import torch

    from texgs_torch.io import png

    os.makedirs(out_dir, exist_ok=True)
    bg_np = np.asarray(bg, np.float32).reshape(3, 1, 1)
    paths = []
    with torch.no_grad():
        for idx, vp in enumerate(cameras):
            pkg = model.visual_step(0, 0, vp, None)
            image = torch.clamp(pkg["image"], 0, 1).cpu().numpy()
            if vp.alpha_mask is not None:
                gt_alpha = torch.as_tensor(vp.alpha_mask).cpu().numpy()
                image = image * gt_alpha + bg_np * (1 - gt_alpha)
            path = os.path.join(out_dir, f"{idx:05d}.png")
            png.write(path, (image.transpose(1, 2, 0) * 255).astype(np.uint8))
            paths.append(path)
    if log:
        log.info(f"wrote {len(paths)} views to {out_dir}")
    return paths


def retexture(cfg, ckpt_path: str, out_dir: str,
              load_texture_from: str | None = None, mode: int = 0,
              splits=("train", "test"), log=None, device="cuda"):
    """Returns (the model, {split: written paths})."""
    from texgs_torch.data.scene import create_dataset
    from texgs_torch.io import png
    from texgs_torch.train.models import load_model
    from texgs_torch.utils.logger import get_logger

    log = log or get_logger()
    os.makedirs(out_dir, exist_ok=True)
    model = load_model(cfg, ckpt_path, device)[0]

    if load_texture_from:
        img = png.read(load_texture_from)[..., :3].astype(np.float32) / 255.0
        res = model.tex_res
        if img.shape[:2] != (3 * res, 4 * res):
            img = resize_cross(img, 3 * res, 4 * res)
        model.change_texture(img, mode=mode)
        log.info(f"applied texture {load_texture_from} (mode {mode})")

    scene = create_dataset(cfg.dataset_cfg, log, out_dir,
                           bool(cfg.get_or("debug", False)), device)
    bg = cfg.dataset_cfg.get_or("background", [0, 0, 0])
    outs = {}
    if "train" in splits:
        outs["train"] = render_views(model, scene.getTrainCameras(),
                                     os.path.join(out_dir, "train"), bg, log)
    if "test" in splits:
        outs["test"] = render_views(model, scene.getTestCameras(),
                                    os.path.join(out_dir, "test"), bg, log)
    return model, outs


def main(argv=None):
    from argparse import ArgumentParser

    from texgs_torch.config import load_config

    parser = ArgumentParser(description="Retexture + render all views")
    parser.add_argument("config")
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--out", type=str, default="./retexture_out")
    parser.add_argument("--load_texture_from", type=str, default=None)
    parser.add_argument("--mode", type=int, default=0,
                        help="-1 replace, 0 luminance, 1 multiply, 2 divide, "
                             "3 masked blend")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    cfg.debug = False
    return retexture(cfg, args.ckpt, args.out, args.load_texture_from,
                     args.mode, device=args.device)


if __name__ == "__main__":
    main()
