"""The reduction of the program's spans (benchmark/spans.py) on a
hand-made trace: a 200 us window on thread 1 holding one training step
(render with a blend and a kernel span, loss, backward, adam) and a
``bench::skip`` range; thread 2 launching during the backward, inside a
kernel span and outside any span."""

import copy

import pytest

from benchmark import harness, spans


def ann(name, ts, dur, tid=1):
    return {"name": name, "cat": "user_annotation", "ph": "X", "ts": ts,
            "dur": dur, "tid": tid}


def span(name, ts, dur, tid=1):
    return ann(spans.PREFIX + name, ts, dur, tid)


def rt(ts, corr, tid=1, name="cudaLaunchKernel", dur=1.0):
    return {"name": name, "cat": "cuda_runtime", "ph": "X", "ts": ts,
            "dur": dur, "tid": tid, "args": {"correlation": corr}}


def dev(name, ts, dur, corr, cat="kernel"):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


EVENTS = [
    ann(harness.WINDOW, 0.0, 200.0),
    span("step", 0.0, 190.0),
    span("render", 10.0, 50.0),
    span("render.blend", 20.0, 20.0),
    span("kernel.uvtex_fused", 25.0, 5.0),
    span("loss", 60.0, 20.0),
    span("backward", 80.0, 40.0),
    span("kernel.uvtex_fused_bwd", 89.0, 6.0, tid=2),
    span("adam", 120.0, 30.0),
    ann(harness.SKIP, 160.0, 10.0),
    rt(26.0, 1), dev("k_fused", 30.0, 5.0, 1),
    rt(45.0, 2), dev("k_render", 50.0, 5.0, 2),
    rt(62.0, 3), dev("k_loss", 70.0, 5.0, 3),
    rt(65.0, 30, name="cudaStreamSynchronize", dur=5.0),
    rt(90.0, 4, tid=2), dev("k_bwd", 92.0, 8.0, 4),
    rt(101.0, 5, tid=2), dev("k_autograd", 102.0, 8.0, 5),
    rt(125.0, 6, name="cudaMemcpyAsync"),
    dev("Memcpy HtoD", 125.0, 5.0, 6, "gpu_memcpy"),
    rt(161.0, 7), dev("k_snap", 162.0, 4.0, 7),              # skipped
    rt(163.0, 31, name="cudaStreamSynchronize"),              # skipped
    dev("k_orphan", 180.0, 2.0, 99),      # no runtime call in the trace
    dev("k_late", 250.0, 5.0, 8),         # after the window
]


def test_phases():
    r = spans.reduce(EVENTS)
    ph = r["phases"]
    assert {k: v["launches"] for k, v in ph.items()} == {
        "render": 2, "loss": 1, "backward": 2, "adam": 0, "outside": 1}
    # 55..70 crosses the render -> loss edge at 60: 5 us and 10 us
    assert {k: v["idle_s"] * 1e6 for k, v in ph.items()} == pytest.approx({
        "render": 40.0, "loss": 15.0, "backward": 24.0, "adam": 25.0,
        "outside": 48.0})
    assert {k: v["syncs"] for k, v in ph.items()} == {
        "render": 0, "loss": 1, "backward": 0, "adam": 0, "outside": 0}
    assert r["steps"] == 1 and r["syncs"] == 1


def test_second_thread_launches_count_under_backward():
    r = spans.reduce(EVENTS)["spans"]
    assert r["kernel.uvtex_fused_bwd"]["launches"] == 1
    assert r["kernel.uvtex_fused_bwd"]["device_s"] == pytest.approx(8e-6)
    assert r["backward"]["launches"] == 1           # k_autograd
    assert r["kernel.uvtex_fused"]["device_s"] == pytest.approx(5e-6)
    assert r["adam"]["device_s"] == pytest.approx(5e-6)   # the copy
    assert r["adam"]["launches"] == 0


def test_span_rows():
    r = spans.reduce(EVENTS)["spans"]
    self_host = {k: v["self_host_s"] * 1e6 for k, v in r.items()}
    assert self_host == pytest.approx({
        "step": 50.0, "render": 30.0, "render.blend": 15.0,
        "kernel.uvtex_fused": 5.0, "loss": 20.0, "backward": 40.0,
        "kernel.uvtex_fused_bwd": 6.0, "adam": 30.0})
    idle = {k: v["idle_s"] * 1e6 for k, v in r.items()}
    assert idle == pytest.approx({
        "step": 38.0, "render": 25.0, "render.blend": 10.0,
        "kernel.uvtex_fused": 5.0, "loss": 15.0, "backward": 24.0,
        "kernel.uvtex_fused_bwd": 0.0, "adam": 25.0})
    assert all(v["calls"] == 1 for v in r.values())
    assert r["loss"]["syncs"] == 1


def test_identities_with_reduce_trace():
    """The phases' launches add up to reduce_trace's kernels, their idle
    time to its window less its busy time; reduce_trace reads the trace as
    it did."""
    before = copy.deepcopy(EVENTS)
    t = harness.reduce_trace(EVENTS)
    r = spans.reduce(EVENTS)
    assert EVENTS == before
    assert harness.reduce_trace(EVENTS) == t
    assert r["kernels"] == t["kernels"] == 6
    assert r["idle_s"] == pytest.approx(t["window_s"] - t["busy_s"])
    assert r["idle_s"] == pytest.approx(152e-6)


def test_a_trace_without_spans():
    """reduce_trace's own hand-made trace: everything outside."""
    from benchmark.tests.test_bench_trace import EVENTS as PLAIN
    t = harness.reduce_trace(PLAIN)
    r = spans.reduce(PLAIN)
    assert list(r["phases"]) == ["outside"] and r["spans"] == {}
    assert r["kernels"] == t["kernels"]
    assert r["idle_s"] == pytest.approx(t["window_s"] - t["busy_s"])


def test_a_trace_without_a_window():
    """A --profile_dir trace: the whole trace is the window, the first
    phase span's thread the main thread."""
    events = [e for e in EVENTS if e["name"] not in (harness.WINDOW,
                                                     harness.SKIP)]
    r = spans.reduce(events)
    assert r["steps"] == 1
    assert r["kernels"] == 8          # k_snap and k_late now inside
    assert r["phases"]["backward"]["launches"] == 2
    assert r["syncs"] == 2
