"""Training driver: the per-iteration loop, validation, checkpointing
(port of texgs/train/driver.py:44,110).

Random viewpoint order, EMA-loss progress reports, periodic ``visualize``
with L1 / PSNR / SSIM on the test and some train cameras, point-cloud dumps
and checkpoints in texgs's schema, and TensorBoard scalars and images
through tensorboardX where it is installed.  With ``cfg.profile_dir`` a
``torch.profiler`` trace of iterations PROFILE_FIRST..PROFILE_LAST (CPU
activity, and the card's where there is one) goes into that directory as
a Chrome trace; it holds the program's ``texgs::`` spans
(``texgs_torch.utils.spans``), and ``python -m benchmark.spans TRACE``
reduces it to launches, idle time and host syncs by span and by phase.
Every 250 iterations the loop collects cyclic garbage and reads the
host's resident memory, logged every 1,000.  The port's
models validate every step when it returns, so there is no ``flush``.
"""

from __future__ import annotations

import gc
import os
import random
import time

import numpy as np
import torch

from texgs_torch.config import Cfg
from texgs_torch.io import checkpoint as ckpt
from texgs_torch.losses import l1_loss, ssim_loss
from texgs_torch.utils.metrics import psnr

# the iterations a cfg.profile_dir trace covers (texgs's 100..110)
PROFILE_FIRST = 100
PROFILE_LAST = 110


def _host_rss_gib() -> float:
    """The process's resident host memory in GiB (0.0 where
    /proc/self/statm cannot be read)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
    except (OSError, IndexError, ValueError):
        return 0.0
    return pages * os.sysconf("SC_PAGE_SIZE") / 2 ** 30


def start_profile(device):
    """A running torch.profiler over CPU activity, and CUDA activity when
    the model is on the card."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_profile(prof, profile_dir, log) -> str:
    """Stops ``prof`` and writes its Chrome trace into ``profile_dir``;
    returns the file's path."""
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir,
                        f"trace_{PROFILE_FIRST}_{PROFILE_LAST}.json")
    prof.export_chrome_trace(path)
    log.info(f"profiler trace written to {path}")
    return path


def tb_writer_for(work_dir, debug):
    """A tensorboardX writer into ``work_dir``, or None in debug runs and
    where tensorboardX is not installed."""
    if debug:
        return None
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(work_dir)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


@torch.no_grad()
def visualize(tb_writer, iteration, end_iteration, model, scene, log,
              show_gt=False) -> dict:
    """Validation pass over the test cameras and five train cameras:
    mean L1, PSNR and SSIM of each set."""
    train_cams = scene.getTrainCameras()
    configs = (
        {"name": "test", "cameras": scene.getTestCameras()},
        {"name": "train",
         "cameras": [train_cams[i % len(train_cams)] for i in range(5, 30, 5)]},
    )
    results = {}
    for config in configs:
        cams = config["cameras"]
        if not cams:
            continue
        l1_t = psnr_t = ssim_t = 0.0
        for idx, vp in enumerate(cams):
            pkg = model.visual_step(iteration, end_iteration, vp, None)
            image = torch.clamp(pkg["image"], 0.0, 1.0)
            gt = torch.clamp(torch.as_tensor(vp.image, dtype=torch.float32,
                                             device=image.device), 0.0, 1.0)
            l1_t += float(l1_loss(image, gt))
            psnr_t += float(psnr(image, gt).mean())
            ssim_t += float(ssim_loss(image, gt))
            if tb_writer and idx < 5:
                name = f"{config['name']}_view_{vp.image_name}"
                tb_writer.add_image(f"{name}/render", _np(image), iteration)
                tb_writer.add_image(f"{name}/norm", np.clip(
                    0.5 * (_np(pkg["norm"]) + 1), 0, 1), iteration)
                tb_writer.add_image(f"{name}/alpha",
                                    np.clip(_np(pkg["alpha"]), 0, 1), iteration)
                d = _np(pkg["depth"])
                tb_writer.add_image(f"{name}/depth", (d - d.min()) / (
                    d.max() - d.min() + 1e-8), iteration)
                for key, value in pkg.items():
                    if key not in ("image", "norm", "alpha", "depth"):
                        tb_writer.add_image(f"{name}/{key}",
                                            np.clip(_np(value), 0, 1), iteration)
                if show_gt:
                    tb_writer.add_image(f"{name}/ground_truth", _np(gt),
                                        iteration)
        n = len(cams)
        results[config["name"]] = dict(l1=l1_t / n, psnr=psnr_t / n,
                                       ssim=ssim_t / n)
        log.info(f"\n[ITER {iteration}] Evaluating {config['name']}: "
                 f"L1 {l1_t / n:.4f} PSNR {psnr_t / n:.2f} "
                 f"SSIM {ssim_t / n:.4f}")
        if tb_writer:
            for k, v in results[config["name"]].items():
                tb_writer.add_scalar(f"{config['name']}/loss_viewpoint - {k}",
                                     v, iteration)
    if tb_writer and hasattr(model, "n_points"):
        tb_writer.add_scalar("total_points", model.n_points, iteration)
    return results


def train(cfg: Cfg, log, tb_writer=None, scene=None, model=None,
          progress=True, device="cuda"):
    """The main loop.  Returns (model, scene, the last evaluation)."""
    from texgs_torch.data.scene import create_dataset
    from texgs_torch.train.models import create_model

    debug = bool(cfg.debug)
    if model is None:
        model = create_model(cfg.model_cfg, device)
    if scene is None:
        scene = create_dataset(cfg.dataset_cfg, log, cfg.work_dir, debug,
                               device)

    model.bind_train_cfg(cfg.train_cfg,
                         cfg.dataset_cfg.get_or("background", [0, 0, 0]))
    if cfg.get_or("resume_from", None):
        sd, start_iteration = ckpt.load(cfg.resume_from)
        model.load_state_dict(sd, cfg.optim_cfg)
        log.info(f"Resumed from {cfg.resume_from} at iter {start_iteration}")
    else:
        model.initialize(scene.scene_info.point_cloud, scene.cameras_extent)
        model.setup_optim(cfg.optim_cfg)
        start_iteration = 0

    end_iteration = int(cfg.train_cfg.num_iterations)
    viewpoints = list(scene.getTrainCameras())
    visual_iters = cfg.train_cfg.get_or("visual_iters", [])
    ckpt_iters = cfg.train_cfg.get_or("ckpt_iters", [])
    pool: list = []
    ema_loss = 0.0
    last_eval = None
    t_start = t_last_ckpt = time.time()
    ckpt_wall_s = 60.0 * float(cfg.train_cfg.get_or("ckpt_wall_minutes", 10))
    profile_dir = cfg.get_or("profile_dir", None)
    prof = None

    for iteration in range(start_iteration + 1, end_iteration + 1):
        if not pool:
            pool = list(viewpoints)
        viewpoint = (pool.pop(0) if debug
                     else pool.pop(random.randint(0, len(pool) - 1)))

        if profile_dir and iteration == PROFILE_FIRST:
            prof = start_profile(device)
        it_t0 = time.time()
        loss, loss_stats, extra = model.compute_loss(
            iteration, end_iteration, viewpoint, None, cfg.loss_cfg)
        loss_f = float(loss)
        it_time = time.time() - it_t0
        if prof is not None and iteration == PROFILE_LAST:
            stop_profile(prof, profile_dir, log)
            prof = None
        ema_loss = 0.4 * loss_f + 0.6 * ema_loss
        if iteration % 250 == 0:
            gc.collect()
            rss = _host_rss_gib()
            if progress and iteration % 1000 == 0:
                log.info(f"[mem] host rss {rss:.1f} GiB")
        if progress and iteration % 50 == 0:
            log.info(f"iter {iteration}/{end_iteration} L={ema_loss:.6f} "
                     f"N={getattr(model, 'n_points', 0)} "
                     f"({(iteration - start_iteration) / (time.time() - t_start):.1f} it/s)")
        if tb_writer:
            for k, v in loss_stats.items():
                tb_writer.add_scalar(f"train_loss_patches/{k}", float(v),
                                     iteration)
            tb_writer.add_scalar("iter_time", it_time * 1000.0, iteration)

        if iteration in visual_iters and not debug:
            os.makedirs(os.path.join(cfg.work_dir, "pcds"), exist_ok=True)
            model.save_point_cloud(
                os.path.join(cfg.work_dir, "pcds", f"{iteration}.ply"))
        if iteration in visual_iters or (debug and iteration == end_iteration):
            last_eval = visualize(tb_writer, iteration, end_iteration, model,
                                  scene, log,
                                  show_gt=bool(visual_iters)
                                  and iteration == min(visual_iters))
        if iteration in ckpt_iters and not debug:
            log.info(f"\n[ITER {iteration}] Saving Checkpoint")
            ckpt.save(os.path.join(cfg.work_dir, "checkpoints", str(iteration)),
                      model.state_dict(), iteration)
            t_last_ckpt = time.time()
        # a resumable checkpoint every ckpt_wall_minutes of wall clock
        if (not debug and ckpt_wall_s > 0
                and time.time() - t_last_ckpt > ckpt_wall_s):
            path = os.path.join(cfg.work_dir, "checkpoints", str(iteration))
            ckpt.save(path, model.state_dict(), iteration)
            t_last_ckpt = time.time()
            log.info(f"[ITER {iteration}] wall-clock checkpoint -> {path}")

        model.optimize_step(iteration, end_iteration, cfg.train_cfg, extra)
    if prof is not None:  # the run ended inside the window
        stop_profile(prof, profile_dir, log)
    return model, scene, last_eval
