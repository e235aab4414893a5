"""A second witness for the training cell's check: the reference's first
step in float64 beside the program's and the float32 reference's, leaf by
leaf, on the card at the cell's size.

    python -m benchmark.tests.witness --seeds 11,12 [--tiny]

For each leaf: the three gradient norms, each float32 gradient's relative
distance from the float64 one, and the share of the float64 gradient's
squared norm that its heaviest 0.1% of rows carry.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", required=True)
    p.add_argument("--tiny", action="store_true")
    a = p.parse_args(argv)
    import texgs_torch  # noqa: F401
    from benchmark import harness
    from benchmark.drivers import train_loop as T
    from benchmark.tests.tiny import tiny_cell
    name = "tgs3-dtu-train"
    cell = tiny_cell(name) if a.tiny else harness.cell(name)
    dev = "cpu" if a.tiny else "cuda"
    cfg, work = cell["config"], cell["work"]["traffic_params"]
    for seed in [int(x) for x in a.seeds.split(",")]:
        ses = T.Session(cfg, work, seed, dev)
        ses.model = ses.pviews = None
        order = ses.prog["order"][:1]
        r32 = T.reference_readings(ses.state0, ses.views, order, ses.hy, cfg,
                                   ses.m)
        torch.set_default_dtype(torch.float64)
        try:
            s64 = {k: v.double() for k, v in ses.state0.items()}
            v64 = [{k: (x.double() if torch.is_tensor(x) else x)
                    for k, x in v.items()} for v in ses.views]
            r64 = T.reference_readings(s64, v64, order, ses.hy, cfg, ses.m)
        finally:
            torch.set_default_dtype(torch.float32)
        rows = {}
        for k, g64 in r64["g1_t"].items():
            n64 = float(torch.linalg.norm(g64))
            if n64 == 0:
                continue
            gp, g32 = ses.prog["g1_t"][k].double(), r32["g1_t"][k].double()
            flat = g64.reshape(g64.shape[0], -1) if g64.dim() > 1 else g64[:, None]
            sq = (flat * flat).sum(1)
            top = max(1, sq.numel() // 1000)
            rows[k] = {"norm_prog": ses.prog["g1"][k], "norm_ref32": r32["g1"][k],
                       "norm_ref64": n64,
                       "dist_prog_64": float(torch.linalg.norm(gp - g64)) / n64,
                       "dist_ref32_64": float(torch.linalg.norm(g32 - g64)) / n64,
                       "top_0.1pct_share": float(torch.topk(sq, top).values.sum()
                                                 / sq.sum())}
        print(json.dumps({"seed": seed, "loss_prog": ses.prog["loss"][0],
                          "loss_ref32": r32["loss"][0],
                          "loss_ref64": r64["loss"][0], "leaves": rows}),
              flush=True)
        del ses, r32, r64
        if dev == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
