"""Training command line of texgs_torch (mirrors the root train.py):

    python -m texgs_torch.train <config.yaml> [--workspace ./output]
        [--run_name NAME] [--debug] [--resume_from CKPT] [--seed 0]
        [--device cuda|cpu] [--debug_nans] [--profile_dir DIR]

It runs on the card unless ``--device cpu`` is given.  ``--debug_nans``
runs the training under autograd's anomaly mode (a backward that makes
NaN raises, naming the forward operation that led to it); ``--profile_dir`` writes a
torch.profiler trace of iterations 100..110 into DIR.
"""

from __future__ import annotations

import contextlib
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
    parser.add_argument("--debug_nans", action="store_true",
                        help="torch.autograd.set_detect_anomaly(True), the "
                             "port of texgs's jax_debug_nans")
    parser.add_argument("--resume_from", type=str, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of iterations "
                             "100-110 to this directory")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from texgs_torch.config import dump_config, load_config
    from texgs_torch.train.driver import tb_writer_for, train
    from texgs_torch.utils.logger import get_logger, logging_to

    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    cfg = load_config(args.config)
    cfg.model_cfg.seed = args.seed
    cfg.profile_dir = args.profile_dir
    run_name = args.run_name or os.path.splitext(os.path.basename(args.config))[0]
    cfg.work_dir = os.path.abspath(os.path.join(
        args.workspace, run_name, datetime.now().strftime("%Y-%m-%d_%H-%M-%S")))
    cfg.resume_from = args.resume_from
    cfg.debug = args.debug
    if not cfg.debug:
        os.makedirs(os.path.join(cfg.work_dir, "checkpoints"), exist_ok=True)
        dump_config(cfg, os.path.join(cfg.work_dir, "config.yaml"))

    # this run's TextureGS.log, also where main runs again in one process
    with logging_to(get_logger(), None if cfg.debug else
                    os.path.join(cfg.work_dir, "TextureGS.log")) as log:
        if not cfg.debug:
            log.info(f"Work folder: {cfg.work_dir}")
        # anomaly mode for this run only, as callers in the same process
        # (tests, the smoke run) go on after main returns
        nan_check = (torch.autograd.detect_anomaly() if args.debug_nans
                     else contextlib.nullcontext())
        with nan_check:
            return train(cfg, log, tb_writer_for(cfg.work_dir, cfg.debug),
                         device=args.device)


if __name__ == "__main__":
    main()
