"""Training command line of texgs_torch (mirrors the root train.py):

    python -m texgs_torch.train <config.yaml> [--workspace ./output]
        [--run_name NAME] [--debug] [--resume_from CKPT] [--seed 0]
        [--device cuda|cpu]

It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import os
import random
from argparse import ArgumentParser
from datetime import datetime


def parse_args(argv=None):
    parser = ArgumentParser(description="texgs_torch: Texture-GS training "
                            "on PyTorch + CUDA")
    parser.add_argument("config", help="path to config file")
    parser.add_argument("--workspace", type=str, default="./output")
    parser.add_argument("--run_name", type=str, default=None)
    parser.add_argument("--debug", action="store_true",
                        help="tiny deterministic run, no artifacts")
    parser.add_argument("--resume_from", type=str, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from texgs_torch.config import dump_config, load_config
    from texgs_torch.train.driver import tb_writer_for, train
    from texgs_torch.utils.logger import get_logger

    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    cfg = load_config(args.config)
    cfg.model_cfg.seed = args.seed
    run_name = args.run_name or os.path.splitext(os.path.basename(args.config))[0]
    cfg.work_dir = os.path.abspath(os.path.join(
        args.workspace, run_name, datetime.now().strftime("%Y-%m-%d_%H-%M-%S")))
    cfg.resume_from = args.resume_from
    cfg.debug = args.debug
    if not cfg.debug:
        os.makedirs(os.path.join(cfg.work_dir, "checkpoints"), exist_ok=True)
        dump_config(cfg, os.path.join(cfg.work_dir, "config.yaml"))

    log = get_logger(log_file=None if cfg.debug else
                     os.path.join(cfg.work_dir, "TextureGS.log"))
    if not cfg.debug:
        log.info(f"Work folder: {cfg.work_dir}")
    return train(cfg, log, tb_writer_for(cfg.work_dir, cfg.debug),
                 device=args.device)


if __name__ == "__main__":
    main()
