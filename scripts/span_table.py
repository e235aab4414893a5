#!/usr/bin/env python3
"""The program's spans in a traced run of a benchmark cell, on an NVIDIA
H100.

Run from the repository root on a machine with the card:

    python3 scripts/span_table.py --workload <cell> --seed <n> [--out FILE]

Runs the cell as ``python -m benchmark.run --trace 1`` does (its result
line is printed as that command prints it) and reduces the same traced
window's events with benchmark/spans.py beside
``benchmark.harness.reduce_trace``.  Then prints one JSON line (and writes
it to FILE): the card and its power limit; the cost of a ``span`` in us a
call, with no profiler running and inside a running one; per step (or
frame) the launches, idle ms and host syncs of each phase and the host
syncs of the whole step, under the names of the per-layer metrics they
would be; the two identities
(the phases' launches against the window's kernels, their idle time
against the window less its busy time); each kernel span's device time
beside that of the ``bench::fn::`` range the harness puts around the same
function; and each span's row (calls, launches, idle ms, syncs, self host
ms and device ms per step).  Needs one card and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import timeit

sys.path.insert(0, os.getcwd())

ROOFLINE_FNS = ("uvtex_fused", "uvtex_fused_bwd", "tex_term", "tex_term_bwd",
                "raster", "raster_bwd", "hash_encode", "hash_encode_bwd")
# (the span a step or frame opens, the metrics' suffix) by driver kind
KINDS = {"train_loop": ("step", "train"), "gs1_train_loop": ("step", "gs1"),
         "uv2_train_loop": ("step", "uv2"), "view_loop": ("view", "view")}


def span_cost_us(n: int = 200_000) -> tuple[float, float]:
    """us a ``with span(...)`` costs, less an empty loop's: with no
    profiler running, and inside a running torch.profiler (CPU and CUDA
    activity, as the traced window's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from texgs_torch.utils.spans import span

    def with_span():
        with span("render"):
            pass

    def empty():
        pass

    def per_call(f, m):
        return min(timeit.repeat(f, number=m, repeat=5)) / m
    off = per_call(with_span, n) - per_call(empty, n)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = per_call(with_span, n // 20) - per_call(empty, n // 20)
    torch.cuda.synchronize()
    return off * 1e6, on * 1e6


def summary(cell: dict, trace: dict, red: dict) -> dict:
    kind, tag = KINDS[cell["work"]["driver"]]
    steps = red["steps"]
    out = {"steps": steps}
    ph = red["phases"]
    for name, p in ph.items():
        if name != "outside":
            out[f"launches_per_{kind}.{name}.{tag}"] = p["launches"] / steps
        out[f"idle_ms_per_{kind}.{name}.{tag}"] = p["idle_s"] * 1e3 / steps
    out[f"host_syncs_per_{kind}.{tag}"] = red["syncs"] / steps
    out["outside_launches_per_step"] = ph["outside"]["launches"] / steps
    idle_s = trace["window_s"] - trace["busy_s"]
    out["identity_launches"] = [red["kernels"], trace["kernels"]]
    out["identity_idle_ms_per_step"] = [red["idle_s"] * 1e3 / steps,
                                        idle_s * 1e3 / steps]
    out["identity_idle_rel"] = abs(red["idle_s"] - idle_s) / idle_s
    rows = red["spans"]
    out["kernel_span_vs_fn_ms"] = {
        fn: [rows.get("kernel." + fn, {}).get("device_s", 0.0) * 1e3,
             trace["fn_device_s"].get(fn, 0.0) * 1e3]
        for fn in ROOFLINE_FNS if fn in trace["fn_device_s"]}
    out["table"] = {
        name: {"calls": r["calls"] / steps, "launches": r["launches"] / steps,
               "idle_ms": r["idle_s"] * 1e3 / steps,
               "syncs": r["syncs"] / steps,
               "self_host_ms": r["self_host_s"] * 1e3 / steps,
               "device_ms": r["device_s"] * 1e3 / steps}
        for name, r in sorted(rows.items())}
    out["table"]["(outside)"] = {
        "launches": ph["outside"]["launches"] / steps,
        "idle_ms": ph["outside"]["idle_s"] * 1e3 / steps,
        "syncs": ph["outside"]["syncs"] / steps}
    out["traced_ms_per_step"] = trace["window_s"] * 1e3 / steps
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    from benchmark import harness, run, spans
    kept = {}
    reduce_trace = harness.reduce_trace

    def reduce_and_keep(events):
        kept["trace"] = reduce_trace(events)
        kept["spans"] = spans.reduce(events)
        return kept["trace"]
    harness.reduce_trace = reduce_and_keep
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", "1", "--trace", "1"])
    if rc or "spans" not in kept:
        return rc or 1
    # after the window: a profile before it can cost the window's profile
    # its first device events
    cost_off, cost_on = span_cost_us()
    line = {"workload": args.workload, "seed": args.seed,
            "card": harness.power_limit(), "span_cost_off_us": cost_off,
            "span_cost_on_us": cost_on,
            **summary(harness.cell(args.workload), kept["trace"],
                      kept["spans"])}
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
