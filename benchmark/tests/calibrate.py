"""Readings that the limits of ``correct`` are set from, on the card at the
cells' own sizes (or on the CPU at the test size with ``--tiny``):

  program  the program against the reference, one line a seed;
  control  the reference computed with TF32 on (the nearest precision
           below the configuration's float32 with TF32 off) in the
           program's place, against the reference;
  half     (training) the program with half of each view's pixels left
           out of the loss, the mean taken over the rest.

    python -m benchmark.tests.calibrate --cell tgs3-dtu-train \\
        --seeds 11,12,13 [--control 11,12,13] [--half 11,12,13] [--tiny]

Prints one JSON line a reading; a state left unchanged reads 1 on the
change by the check's measure and needs no run.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys

import torch


@contextlib.contextmanager
def tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@contextlib.contextmanager
def half_batch():
    """The program's stage-3 loss over the top half of each view's rows."""
    from texgs_torch.train import texture_gaussian3d as t3
    orig = t3.stage3_loss_terms

    def cut(image, depth, norm, alpha, image_ns, camera, gt_image, gt_alpha,
            *rest, **kw):
        h = image.shape[-2] // 2

        def top(t):
            return None if t is None else t[..., :h, :]
        camera = dataclasses.replace(
            camera, normal=top(camera.normal), depth=top(camera.depth))
        return orig(top(image), top(depth), top(norm), top(alpha),
                    top(image_ns), camera, top(gt_image), top(gt_alpha),
                    *rest, **kw)
    t3.stage3_loss_terms = cut
    try:
        yield
    finally:
        t3.stage3_loss_terms = orig


def train_readings(cell, seed, device, control: bool, half: bool):
    from benchmark.drivers import train_loop as T
    cfg, work = cell["config"], cell["work"]["traffic_params"]
    ses = T.Session(cfg, work, seed, device)
    ses.model = ses.pviews = None
    if device != "cpu":
        torch.cuda.empty_cache()
    ref = ses.reference()
    out = [("program", T.numbers(ses.prog, ref))]
    if control:
        with tf32():
            ctl = T.reference_readings(ses.state0, ses.views,
                                       ses.prog["order"], ses.hy, cfg, ses.m)
        out.append(("control", T.numbers(ctl, ref)))
        del ctl
    if half:
        with half_batch():
            bad = T.Session(cfg, work, seed, device)
        out.append(("half", T.numbers(bad.prog, ref)))
    return out


def view_readings(cell, seed, device, control: bool, n_frames: int = 12):
    from benchmark import program, scene
    from benchmark.drivers import view_loop as V
    cfg, work = cell["config"], cell["work"]["traffic_params"]
    m = int(cfg["model_cfg"].get("uvtex_m", 32))
    state0, _ = scene.make_state(cfg, seed, device)
    hy = V.hyper(cfg)
    model = program.build_model(cfg, state0, hy, device, train=False)
    cam_of = V.orbit(work, seed)
    step = max(1, int(round(360.0 / work["step_deg"])) // n_frames)
    cams = [cam_of(k * step) for k in range(n_frames)]
    outs = [V.frame_outputs(model, c) for c in cams]
    del model
    refs = [V.reference_outputs(state0, c, hy, cfg, m) for c in cams]
    res = [("program", V.numbers(outs, refs))]
    if control:
        with tf32():
            ctl = [V.reference_outputs(state0, c, hy, cfg, m) for c in cams]
        res.append(("control", V.numbers(ctl, refs)))
    return res


def readings(cell_name, seed, device, control=False, half=False, tiny=False):
    from benchmark import harness
    from benchmark.tests.tiny import tiny_cell
    cell = tiny_cell(cell_name) if tiny else harness.cell(cell_name)
    if cell["work"]["driver"] == "train_loop":
        return train_readings(cell, seed, device, control, half)
    return view_readings(cell, seed, device, control)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cell", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--half", default="")
    p.add_argument("--tiny", action="store_true")
    a = p.parse_args(argv)
    import texgs_torch  # noqa: F401  (TF32 off, as the program runs)
    device = "cpu" if a.tiny else "cuda"

    def ints(s):
        return [int(x) for x in s.split(",") if x]
    ctl, half = set(ints(a.control)), set(ints(a.half))
    for seed in ints(a.seeds):
        for kind, nums in readings(a.cell, seed, device, seed in ctl,
                                   seed in half, a.tiny):
            print(json.dumps({"cell": a.cell, "seed": seed, "kind": kind,
                              "numbers": nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
