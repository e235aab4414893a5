"""Export a stage-3 texture as a cross-layout cubemap PNG (port of
texgs/tools/extract_texture.py).

    python -m texgs_torch.tools.extract_texture <config> --ckpt CKPT
        [--out texture.png] [--device cuda|cpu]

It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import os

import numpy as np


def extract_texture(cfg, ckpt_path: str, out_path: str,
                    device="cuda") -> np.ndarray:
    """Loads the stage-3 checkpoint, writes its ``cube_map()`` (3R, 4R, 3)
    as an 8-bit PNG and returns it."""
    from texgs_torch.io import png
    from texgs_torch.train.models import load_model

    cube = load_model(cfg, ckpt_path, device)[0].cube_map().cpu().numpy()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    png.write(out_path, (np.clip(cube, 0, 1) * 255).astype(np.uint8))
    return cube


def main(argv=None):
    from argparse import ArgumentParser

    from texgs_torch.config import load_config

    parser = ArgumentParser(description="Extract cubemap texture PNG")
    parser.add_argument("config")
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--out", type=str, default="texture.png")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    return extract_texture(load_config(args.config), args.ckpt, args.out,
                           args.device)


if __name__ == "__main__":
    main()
