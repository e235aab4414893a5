"""Readings that the limits of ``gs1-dtu-train``'s ``correct`` are set
from, on the card at the cell's own size (or on the CPU at the test size
with ``--tiny``):

  program  the program against the reference, one line a seed;
  control  the reference computed with TF32 on (the nearest precision
           below the configuration's float32 with TF32 off) in the
           program's place, against the reference;
  half     the program with half of each view's rows left out of the loss;
  frozen   the program with its Adam frozen (no leaf moves);
  sh0      the program rendering at SH degree 0 (``f_rest`` left out).

    python -m benchmark.tests.calibrate_gs1 --seeds 11,12,13 \\
        [--control 11,12,13] [--faults 11,12,13] [--tiny]

Prints one JSON line a reading.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys

import torch

from benchmark.tests.calibrate import tf32


@contextlib.contextmanager
def half_batch():
    """The program's stage-1 loss over the top half of each view's rows."""
    from texgs_torch.train import gaussian3d as g3
    orig = g3.stage1_loss_terms

    def cut(image, depth, norm, alpha, camera, gt_image, gt_alpha, *rest):
        h = image.shape[-2] // 2

        def top(t):
            return None if t is None else t[..., :h, :]
        camera = dataclasses.replace(camera, normal=top(camera.normal),
                                     depth=top(camera.depth))
        return orig(top(image), top(depth), top(norm), top(alpha), camera,
                    top(gt_image), top(gt_alpha), *rest)
    g3.stage1_loss_terms = cut
    try:
        yield
    finally:
        g3.stage1_loss_terms = orig


@contextlib.contextmanager
def frozen_adam():
    """A step that leaves every leaf as it was: no Adam moves one."""
    from texgs_torch.train import optim
    orig = optim.Adam.step
    optim.Adam.step = lambda self, params, lrs: None
    try:
        yield
    finally:
        optim.Adam.step = orig


@contextlib.contextmanager
def sh_degree_0():
    """The program's render held at SH degree 0: ``f_rest`` left out of the
    colours, the loss and the gradients."""
    from texgs_torch.train import gaussian3d as g3
    orig = g3.render

    def deg0(*a, **k):
        return orig(*a, **{**k, "active_sh_degree": 0})
    g3.render = deg0
    try:
        yield
    finally:
        g3.render = orig


FAULTS = {"half": half_batch, "frozen": frozen_adam, "sh0": sh_degree_0}


def cell_of(tiny: bool) -> dict:
    from benchmark import harness
    from benchmark.tests.tiny_gs1 import CELL, tiny_gs1_cell
    return tiny_gs1_cell() if tiny else harness.cell(CELL)


def readings(seed, device, control=False, faults=(), tiny=False) -> list:
    """[(kind, numbers)]: the program's, then the control's and each
    fault's, all against the reference of the program's checked steps."""
    from benchmark.drivers import gs1_train_loop as G
    cell = cell_of(tiny)
    cfg, work = cell["config"], cell["work"]["traffic_params"]
    ses = G.Session(cfg, work, seed, device)
    ses.model = ses.pviews = None
    if device != "cpu":
        torch.cuda.empty_cache()
    ref = ses.reference()
    out = [("program", G.numbers(ses.prog, ref))]
    if control:
        with tf32():
            ctl = G.reference_readings(ses.state0, ses.views,
                                       ses.prog["order"], ses.hy, cfg)
        out.append(("control", G.numbers(ctl, ref)))
        del ctl
    for name in faults:
        with FAULTS[name]():
            bad = G.Session(cfg, work, seed, device)
        bad.model = bad.pviews = None
        out.append((name, G.numbers(bad.prog, ref)))
        del bad
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--tiny", action="store_true")
    a = p.parse_args(argv)
    import texgs_torch  # noqa: F401  (TF32 off, as the program runs)
    device = "cpu" if a.tiny else "cuda"

    def ints(s):
        return [int(x) for x in s.split(",") if x]
    ctl, bad = set(ints(a.control)), set(ints(a.faults))
    for seed in ints(a.seeds):
        for kind, nums in readings(seed, device, seed in ctl,
                                   tuple(FAULTS) if seed in bad else (),
                                   a.tiny):
            print(json.dumps({"cell": "gs1-dtu-train", "seed": seed,
                              "kind": kind, "numbers": nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
