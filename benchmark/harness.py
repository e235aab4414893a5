"""What every cell shares: the manifest and the files it names, the card's
checks, the profiler's trace and its reduction, and the comparison
numbers.

Files are found by name: a configuration in ``configs/<name>.json``, a
cell in ``workloads/<cell>.json`` (its traffic and its driver kind), a
driver in ``drivers/<kind>.py``, a per-layer metric's reader in
``metrics/<metric>.py`` and a function's count in ``counts/<function>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "texgs")
WINDOW = "bench::window"
SKIP = "bench::skip"          # host work of the benchmark inside a window
FN = "bench::fn::"            # a call into a function with a roofline


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str, bench: dict | None = None) -> dict:
    """The cell's manifest entry, its workload file, its configuration and
    the metrics it reports (end-to-end and per-layer)."""
    bench = bench or manifest()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    work = load_json(HERE / "workloads" / f"{name}.json")
    if work["traffic"] != entry["traffic"]:
        raise SystemExit(f"workloads/{name}.json is traffic "
                         f"{work['traffic']!r}, BENCHMARK.json says "
                         f"{entry['traffic']!r}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return {"entry": entry, "work": work,
            "config": load_json(ROOT / conf["file"]),
            "end_to_end": e2e, "per_layer": layer}


# --------------------------------------------------------------- card
def require_card(torch, chips: int) -> None:
    """Exits non-zero, with no result, without the cards the cell asks for."""
    if not torch.cuda.is_available():
        sys.stderr.write("benchmark: no CUDA device; the benchmark runs on "
                         "the card only\n")
        raise SystemExit(2)
    if torch.cuda.device_count() < chips:
        sys.stderr.write(f"benchmark: {torch.cuda.device_count()} CUDA "
                         f"devices, the cell needs {chips}\n")
        raise SystemExit(2)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else "nvidia-smi: no reading"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def device_mallocs(torch) -> int:
    """cudaMalloc calls of the caching allocator so far (0 off the card)."""
    if not torch.cuda.is_available():
        return 0
    return int(torch.cuda.memory_stats().get("num_device_alloc", 0))


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


# -------------------------------------------------------- comparisons
def verdict(numbers: dict, limits: dict) -> tuple[dict, bool]:
    """({name: [value, limit]} for each number with a limit, whether every
    one is finite and within its limit)."""
    comp = {k: [float(numbers[k]), float(lim)] for k, lim in limits.items()}
    return comp, all(math.isfinite(v) and v <= lim for v, lim in comp.values())


def rel_l1(prog, ref) -> float:
    """mean |prog - ref| / mean |ref|."""
    return float((prog - ref).abs().mean() / ref.abs().mean().clamp(min=1e-30))


def leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    """|prog[k] - ref[k]| / max(ref[k], the median over ``keep`` of ref)
    for each leaf k of ``keep``."""
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep}


# -------------------------------------------------------------- trace
class Trace:
    """torch.profiler over a window of the run, reduced to what the
    per-layer readers need."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        # the profiler misses the first device events of a profile
        x = self.torch.ones(1 << 20, device="cuda")
        for _ in range(20):
            x = x * 1.0001
        self.torch.cuda.synchronize()

    def stop(self) -> dict:
        self.torch.cuda.synchronize()
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            events = load_json(path)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        return reduce_trace(events)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(events: list) -> dict:
    """From Chrome-trace events: the window, the device's busy time in it
    (the union of its kernels, copies and fills, less those launched from
    a ``bench::skip`` range), kernel launches, device time by function
    range and by operation name, and the longest idle gaps with the host
    operation that was running."""
    win = [e for e in events if e.get("name") == WINDOW and "dur" in e]
    if not win:
        raise RuntimeError("the trace holds no window")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and "dur" in e and (e["name"].startswith(FN)
                                  or e["name"] == SKIP)]
    launch = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and \
                "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = e
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and "dur" in e and w0 <= e["ts"] < w1]

    def owner(dev_event):
        rt = launch.get(dev_event.get("args", {}).get("correlation"))
        if rt is None:
            return None
        best = None
        for r in ranges:
            if r["tid"] == rt["tid"] and r["ts"] <= rt["ts"] <= r["ts"] + r["dur"]:
                if best is None or r["ts"] >= best["ts"]:
                    best = r
        return best["name"] if best else None

    by_fn, by_op, busy_iv, kernels = {}, {}, [], 0
    for e in device:
        who = owner(e)
        if who == SKIP:
            continue
        end = min(e["ts"] + e["dur"], w1)
        busy_iv.append((e["ts"], end))
        kernels += e.get("cat") == "kernel"
        by_op[e["name"][:100]] = by_op.get(e["name"][:100], 0.0) + e["dur"]
        if who:
            fn = who[len(FN):]
            by_fn[fn] = by_fn.get(fn, 0.0) + e["dur"]
    merged = _merge(busy_iv)
    busy = sum(e - s for s, e in merged)
    skip_host = sum(r["dur"] for r in ranges
                    if r["name"] == SKIP and w0 <= r["ts"] < w1)
    window_us = (w1 - w0) - skip_host

    gaps, prev = [], w0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    host = [e for e in events if e.get("ph") == "X" and "dur" in e
            and e.get("cat") in
            ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
            and e.get("name") != WINDOW]
    idle = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (s + e)
        inside = [h for h in host if h["ts"] <= mid <= h["ts"] + h["dur"]]
        if inside:
            name = min(inside, key=lambda h: h["dur"])["name"]
        else:   # Python between two operations: name the one before it
            before = [h for h in host if h["ts"] + h["dur"] <= mid]
            name = ("host Python after " + max(
                before, key=lambda h: h["ts"] + h["dur"])["name"]
                if before else "host Python")
        idle.append([name[:100], (e - s) * 1e-6])
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": window_us * 1e-6, "busy_s": busy * 1e-6,
            "kernels": kernels,
            "fn_device_s": {k: v * 1e-6 for k, v in by_fn.items()},
            "device_ops": [[k, v * 1e-6] for k, v in ops],
            "idle_gaps": idle}


def wrap_functions(torch, targets: dict):
    """Puts each function ``module.attr`` of ``targets`` ({name: (module,
    attr)}) inside a ``bench::fn::<name>`` profiler range and records the
    order of its calls in the returned list.  Returns (calls, undo)."""
    calls, saved = [], []
    for name, (module, attr) in targets.items():
        fn = getattr(module, attr)

        def wrapped(*args, _fn=fn, _name=name, **kw):
            calls.append(_name)
            with torch.profiler.record_function(FN + _name):
                return _fn(*args, **kw)
        # a function that counts its launches through its module's global
        # name finds its counter on the wrapper
        if hasattr(fn, "launches"):
            wrapped.launches = fn.launches
        saved.append((module, attr, fn))
        setattr(module, attr, wrapped)

    def undo():
        for module, attr, fn in saved:
            setattr(module, attr, fn)
    return calls, undo
