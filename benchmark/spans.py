"""The program's spans in a profiler trace: device launches, idle time,
host syncs and host time by span and by phase.

texgs_torch opens ``texgs::<name>`` ranges at its layer boundaries
(texgs_torch/utils/spans.py) while a ``torch.profiler`` records, so they
lie in the same trace as the device events.  ``reduce(events)`` takes a
Chrome trace's events:

- the window and its device work as ``harness.reduce_trace`` takes them:
  the ``bench::window`` range (in a trace without one, the whole trace);
  kernels, copies and fills that start in it, less those launched inside
  a ``bench::skip`` range; the window's thread is the main thread (in a
  trace without a window, the thread of the first phase span);
- a launch (a kernel, copy or fill, through its correlation id and the
  runtime call that launched it) and a host sync (``SYNC_CALLS``) go to
  the innermost ``texgs::`` span open at the call on the calling thread,
  else to the one open then on the main thread; its phase is the phase
  span (``PHASES``) open then on the main thread, else ``outside``;
- idle time, the window's time that no device work covers less the host
  time inside ``bench::skip`` ranges, is split at the edges of the main
  thread's spans; each piece goes to the innermost span and the phase
  open on the main thread;
- a span's self host time is its duration less its child spans'.

Returns ``steps`` (``texgs::step`` and ``texgs::view`` spans in the
window), the totals ``kernels`` (counted as ``reduce_trace`` counts
them), ``idle_s`` and ``syncs``, ``phases`` ({phase or ``outside``:
launches, idle_s, syncs}; a phase only where one of its spans lies in
the window) and ``spans`` ({name without the prefix: calls, launches,
device_s, idle_s, syncs, self_host_s}).  The launches of ``phases`` add
up to ``kernels``, their ``idle_s`` to the window less its busy time.

    python -m benchmark.spans TRACE.json ...

prints each trace's reduction as one JSON line: a trace that
texgs_torch.train's ``--profile_dir`` wrote, or any other of the program.
"""

from __future__ import annotations

import bisect
import json
import sys

from benchmark.harness import FN, SKIP, WINDOW, _merge

PREFIX = "texgs::"
PHASES = ("render", "loss", "backward", "adam", "maps")
STEPS = ("step", "view")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME = ("cuda_runtime", "cuda_driver")


def _end(e) -> float:
    return e["ts"] + e["dur"]


def _innermost(ranges: list, queries: list) -> list:
    """For each (tid, time) of ``queries``, the range of ``ranges`` on
    that thread that holds the time (ends included) and started last, or
    None."""
    by_tid = {}
    for r in ranges:
        by_tid.setdefault(r["tid"], []).append(r)
    for rs in by_tid.values():
        rs.sort(key=lambda r: (r["ts"], -r["dur"]))
    out = [None] * len(queries)
    order = sorted(range(len(queries)), key=lambda q: queries[q][1])
    stacks, nexts = {tid: [] for tid in by_tid}, dict.fromkeys(by_tid, 0)
    for q in order:
        tid, t = queries[q]
        rs = by_tid.get(tid)
        if rs is None:
            continue
        stack, i = stacks[tid], nexts[tid]
        while i < len(rs) and rs[i]["ts"] <= t:
            stack.append(rs[i])
            i += 1
        nexts[tid] = i
        while stack and _end(stack[-1]) < t:
            stack.pop()
        for r in reversed(stack):
            if _end(r) >= t:
                out[q] = r
                break
    return out


def _name(span) -> str:
    return span["name"][len(PREFIX):]


def reduce(events: list) -> dict:
    host = [e for e in events if e.get("ph") == "X" and "dur" in e
            and e.get("cat") in ("user_annotation", "cpu_op", *RUNTIME)]
    ann = [e for e in host if e["cat"] == "user_annotation"]
    spans = [e for e in ann if e["name"].startswith(PREFIX)]
    phase_spans = [e for e in spans if _name(e) in PHASES]
    win = [e for e in events if e.get("name") == WINDOW and "dur" in e]
    if win:
        w0, w1 = win[0]["ts"], _end(win[0])
        main = next(e["tid"] for e in ann if e["name"] == WINDOW)
    else:
        timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
        w0, w1 = min(e["ts"] for e in timed), max(_end(e) for e in timed)
        main = min(phase_spans, key=lambda e: e["ts"])["tid"] \
            if phase_spans else None
    spans = [e for e in spans if _end(e) > w0 and e["ts"] < w1]
    main_spans = [e for e in spans if e["tid"] == main]
    main_phases = [e for e in main_spans if _name(e) in PHASES]
    gates = [e for e in ann if e["name"].startswith(FN) or e["name"] == SKIP]
    skips = [e for e in gates if e["name"] == SKIP and w0 <= e["ts"] < w1]

    launch = {}
    for e in host:
        if e["cat"] in RUNTIME and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = e
    device = [e for e in events if e.get("cat") in DEVICE and "dur" in e
              and w0 <= e["ts"] < w1]
    syncs = [e for e in host if e["cat"] in RUNTIME
             and e["name"] in SYNC_CALLS and w0 <= e["ts"] < w1]

    # the host call behind each device event and each sync; what a
    # bench::skip range launched or waited for is left out
    calls = [launch.get(e.get("args", {}).get("correlation")) for e in device]
    calls += syncs
    at = [(c["tid"], c["ts"]) if c else (None, 0.0) for c in calls]
    gate = _innermost(gates, at)
    own = _innermost(spans, at)
    on_main = _innermost(main_spans, [(main, t) for _, t in at])
    phase_at = _innermost(main_phases, [(main, t) for _, t in at])

    phases = {_name(e): {"launches": 0, "idle_s": 0.0, "syncs": 0}
              for e in main_phases}
    phases["outside"] = {"launches": 0, "idle_s": 0.0, "syncs": 0}
    rows = {}

    def row(span):
        return rows.setdefault(_name(span), {
            "calls": 0, "launches": 0, "device_s": 0.0, "idle_s": 0.0,
            "syncs": 0, "self_host_s": 0.0})

    busy = []
    for k, c in enumerate(calls):
        if gate[k] is not None and gate[k]["name"] == SKIP:
            continue
        span = (own[k] or on_main[k]) if c else None
        phase = phases[_name(phase_at[k])] if c and phase_at[k] \
            else phases["outside"]
        if k >= len(device):
            phase["syncs"] += 1
            if span:
                row(span)["syncs"] += 1
            continue
        e = device[k]
        busy.append((e["ts"], min(_end(e), w1)))
        kernel = e["cat"] == "kernel"
        phase["launches"] += kernel
        if span:
            row(span)["launches"] += kernel
            row(span)["device_s"] += e["dur"] * 1e-6

    # idle pieces between the edges of the main thread's spans
    gaps, prev = [], w0
    for s, e in _merge(busy):
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    edges = sorted({t for e in main_spans + skips
                    for t in (e["ts"], _end(e))})
    pieces = []
    for s, e in gaps:
        lo, hi = bisect.bisect_right(edges, s), bisect.bisect_left(edges, e)
        pts = [s, *edges[lo:hi], e]
        pieces += [(a, b) for a, b in zip(pts, pts[1:]) if b > a]
    mids = [(main, 0.5 * (a + b)) for a, b in pieces]
    in_skip = _innermost([{**e, "tid": main} for e in skips], mids)
    span_at = _innermost(main_spans, mids)
    phase_at = _innermost(main_phases, mids)
    for k, (a, b) in enumerate(pieces):
        if in_skip[k] is not None:
            continue
        idle = (b - a) * 1e-6
        phases[_name(phase_at[k]) if phase_at[k] else "outside"]["idle_s"] \
            += idle
        if span_at[k]:
            row(span_at[k])["idle_s"] += idle

    # calls and self host time (a span's duration less its children's) of
    # the spans that open in the window
    def inside(e):
        return w0 <= e["ts"] < w1

    for tid in {e["tid"] for e in spans}:
        stack = []
        for e in sorted((e for e in spans if e["tid"] == tid),
                        key=lambda e: (e["ts"], -e["dur"])):
            while stack and _end(e) > _end(stack[-1]):
                stack.pop()
            if inside(e):
                row(e)["calls"] += 1
                row(e)["self_host_s"] += e["dur"] * 1e-6
            if stack and inside(stack[-1]):
                row(stack[-1])["self_host_s"] -= e["dur"] * 1e-6
            stack.append(e)

    return {"steps": sum(_name(e) in STEPS and inside(e) for e in spans),
            "kernels": sum(p["launches"] for p in phases.values()),
            "idle_s": sum(p["idle_s"] for p in phases.values()),
            "syncs": sum(p["syncs"] for p in phases.values()),
            "phases": phases, "spans": rows}


def main(argv=None) -> int:
    for path in (argv if argv is not None else sys.argv[1:]):
        with open(path) as f:
            print(json.dumps(reduce(json.load(f)["traceEvents"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
