"""Runs one cell of the benchmark once and prints its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for; without them it exits non-zero and prints no result.  With
``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a traced window.  Either way the
run checks what its timed path produced against the plain reference and
prints each number compared beside its limit: as the last lines of
standard error, and under ``compared``, the last key of the result line.
Kernel builds stay in ``build/`` inside the checkout.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

CPU_THREADS = 2


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def per_layer(cell: dict, res: dict) -> dict:
    from benchmark import harness
    run = {k: res[k] for k in ("trace", "steps", "calls", "per_step")}
    out = {}
    for m in cell["per_layer"]:
        v = harness.load_module("metrics", m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import harness
    cell = harness.cell(args.workload)
    root = harness.ROOT
    # the program's and its libraries' caches live at fixed paths inside
    # the checkout, so only a checkout's first run builds
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(root / "build" / "torch_extensions"))
    import torch
    harness.require_card(torch, int(cell["entry"]["chips"]))
    import texgs_torch  # noqa: F401  (sets TF32 off, as the program runs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(CPU_THREADS)

    driver = harness.load_module("drivers", cell["work"]["driver"])
    ctx = SimpleNamespace(torch=torch, device="cuda", cell=cell,
                          seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), t0=T0)
    res = driver.run(ctx)

    bad = harness.forbidden_loaded()
    if bad:
        sys.stderr.write(f"benchmark: modules that must not load: {bad}\n")
        return 3
    limits = cell["work"]["limits"]
    comp, correct = harness.verdict(res["numbers"], limits)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["entry"]["chips"]),
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": correct, "attempted": int(res["attempted"]),
            "failed": int(res["failed"])}
    if args.trace:
        t = res["trace"]
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        line["metrics"] = per_layer(cell, res)
        line["device"] = device
        line["breakdown"] = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
    else:
        line["metrics"] = {k: {"value": float(v), "unit": u}
                           for k, (v, u) in res["metrics"].items()}
        line["device"] = device
    line["compared"] = comp
    info = {k: v for k, v in res["numbers"].items() if k not in limits}
    if "window_mallocs" in res:
        info["cudaMalloc calls in the window"] = res["window_mallocs"]
    print(f"# device: {torch.cuda.get_device_name(0)}; nvidia-smi "
          f"name, power.limit: {harness.power_limit()}", flush=True)
    if info:
        sys.stderr.write(f"compared (context): {info}\n")
    for k, (v, lim) in comp.items():
        sys.stderr.write(f"compared {k}: {v!r} limit {lim!r}"
                         f"{'' if v <= lim else '  FAILS'}\n")
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
