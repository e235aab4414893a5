"""Readings that the limits of ``uv2-dtu-train``'s ``correct`` are set
from, on the card at the cell's own size (or on the CPU at the test size
with ``--tiny``):

  program  the program against the reference, one line a seed;
  control  the reference computed with TF32 on (the nearest precision
           below the configuration's float32 with TF32 off) in the
           program's place, against the reference;
  subset   the program's inverse loss on a random subset of the masked
           points, the repository YAML's 65,536 of a 800x600 frame (its
           ``max_inverse_points``), scaled to the frame's pixels;
  frozen   the program with its hash table frozen (Adam leaves it);
  oneway   the program's chamfer in one direction, samples to cloud.

    python -m benchmark.tests.calibrate_uv2 --seeds 11,12,13 \\
        [--control 11,12,13] [--faults 11,12,13] [--views 11] [--tiny]

Prints one JSON line a reading; with ``--views``, one a seed with each
view's inverse points (its pixels with alpha > 0.5 in the reference's
render), the traffic's points a step.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import sys

import torch

from benchmark.tests.calibrate import tf32

SUBSET_POINTS, SUBSET_FRAME = 65536, 800 * 600
TABLE = "inv_uv_net.hashgrid.table"


@contextlib.contextmanager
def inverse_subset(cfg: dict):
    """``max_inverse_points`` at the YAML's share of the frame: the
    program's top-k route over a random subset of the masked pixels."""
    mc, v = cfg["model_cfg"], cfg["assumed"]["views"]
    old = mc["max_inverse_points"]
    mc["max_inverse_points"] = round(SUBSET_POINTS * v["width"] * v["height"]
                                     / SUBSET_FRAME)
    try:
        yield
    finally:
        mc["max_inverse_points"] = old


@contextlib.contextmanager
def frozen_table(cfg: dict):
    """Adam steps every leaf but the hash table."""
    from texgs_torch.train import optim
    orig = optim.Adam.step

    def step(self, params, lrs):
        orig(self, {k: p for k, p in params.items() if k != TABLE}, lrs)
    optim.Adam.step = step
    try:
        yield
    finally:
        optim.Adam.step = orig


@contextlib.contextmanager
def one_way_chamfer(cfg: dict):
    """The chamfer loss from the samples to the cloud alone."""
    from texgs_torch.train import uv_map_gaussian3d as U
    orig = U.chamfer_distance
    U.chamfer_distance = functools.partial(orig, single_directional=True)
    try:
        yield
    finally:
        U.chamfer_distance = orig


FAULTS = {"subset": inverse_subset, "frozen": frozen_table,
          "oneway": one_way_chamfer}


def cell_of(tiny: bool) -> dict:
    from benchmark import harness
    from benchmark.tests.tiny_uv2 import CELL, tiny_uv2_cell
    return tiny_uv2_cell() if tiny else harness.cell(CELL)


def readings(seed, device, control=False, faults=(), tiny=False) -> list:
    """[(kind, numbers)]: the program's, then the control's and each
    fault's, each against the reference of its checked steps (a fault
    that draws otherwise than the program, as the subset does, against a
    reference of its own draws, as its run's check would hold it)."""
    from benchmark.drivers import uv2_train_loop as U2
    cell = cell_of(tiny)
    cfg, work = cell["config"], cell["work"]["traffic_params"]
    ses = U2.Session(cfg, work, seed, device)
    ses.model = ses.pviews = None
    if device != "cpu":
        torch.cuda.empty_cache()
    ref = ses.reference()
    out = [("program", U2.numbers(ses.prog, ref))]
    if control:
        with tf32():
            ctl = U2.reference_readings(ses.gauss, ses.pcd, ses.state0,
                                        ses.cams, ses.prog["order"],
                                        ses.prog["draws"], ses.hy, cfg)
        out.append(("control", U2.numbers(ctl, ref)))
        del ctl
    for name in faults:
        with FAULTS[name](cfg):
            bad = U2.Session(cfg, work, seed, device)
        bad.model = bad.pviews = None
        same = bad.prog["order"] == ses.prog["order"] and all(
            torch.equal(a[k], b[k]) for a, b in zip(bad.prog["draws"],
                                                    ses.prog["draws"])
            for k in ("sample_uvs",))
        out.append((name, U2.numbers(bad.prog,
                                     ref if same else bad.reference())))
        del bad
    return out


def view_points(seed, device, tiny=False) -> list:
    """Each view's masked pixels in the reference's render of the seed's
    frozen Gaussians."""
    from benchmark import quantities_uv2, scene_uv2
    from benchmark.drivers import uv2_train_loop as U2
    cfg = cell_of(tiny)["config"]
    gauss, _, cams = scene_uv2.build(cfg, seed, device)
    bg = U2.background(cfg, device)
    return [quantities_uv2.masked_pixels(gauss, c, bg) for c in cams]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--views", default="")
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
            print(json.dumps({"cell": "uv2-dtu-train", "seed": seed,
                              "kind": kind, "numbers": nums}), flush=True)
    for seed in ints(a.views):
        print(json.dumps({"cell": "uv2-dtu-train", "seed": seed,
                          "view_points": view_points(seed, device, a.tiny)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
