"""The trace reduction and the per-layer readers on a hand-made trace: a
100 us window, three kernels (one inside a kernel function's range, one
inside the benchmark's own skipped range) and a copy."""

import pytest

from benchmark import harness, metrics_common

W = {"name": harness.WINDOW, "cat": "user_annotation", "ph": "X", "ts": 0.0,
     "dur": 100.0, "tid": 1}


def dev(name, ts, dur, corr, cat="kernel"):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def rt(ts, corr, tid=1):
    return {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ph": "X",
            "ts": ts, "dur": 1.0, "tid": tid, "args": {"correlation": corr}}


EVENTS = [
    W,
    {"name": harness.FN + "tex_term", "cat": "user_annotation", "ph": "X",
     "ts": 10.0, "dur": 5.0, "tid": 1},
    {"name": harness.SKIP, "cat": "user_annotation", "ph": "X", "ts": 50.0,
     "dur": 4.0, "tid": 1},
    {"name": "aten::mul", "cat": "cpu_op", "ph": "X", "ts": 60.0, "dur": 30.0,
     "tid": 2},
    rt(5.0, 1), rt(11.0, 2), rt(51.0, 3), rt(52.0, 4),
    dev("k_a", 6.0, 4.0, 1), dev("k_tex", 20.0, 10.0, 2),
    dev("k_snap", 55.0, 2.0, 3), dev("Memcpy", 56.0, 4.0, 4, "gpu_memcpy"),
    dev("k_late", 150.0, 5.0, 5),        # outside the window
]


def test_reduce_trace():
    r = harness.reduce_trace(EVENTS)
    assert r["window_s"] == pytest.approx(96e-6)       # less the skipped range
    assert r["busy_s"] == pytest.approx(14e-6)          # k_a + k_tex
    assert r["kernels"] == 2
    assert r["fn_device_s"] == {"tex_term": pytest.approx(10e-6)}
    assert r["device_ops"][0] == ["k_tex", pytest.approx(10e-6)]
    longest = r["idle_gaps"][0]
    assert longest[1] == pytest.approx(70e-6)           # 30 .. 100
    assert longest[0] == "aten::mul"


def test_readers():
    run = {"trace": harness.reduce_trace(EVENTS), "steps": 2,
           "calls": ["tex_term", "tex_term"],
           "per_step": [{"n_tiles": 1, "m": 1, "texels": 0, "height": 1,
                         "width": 1, "live": 0}] * 2}
    assert metrics_common.launches(run) == 1.0
    assert metrics_common.idle_pct(run) == pytest.approx(100 * (1 - 14 / 96))
    # two calls, each 256 slots of 16 B and a 3-channel pixel written, at
    # 3.35 TB/s over 10 us of device time
    assert metrics_common.roofline(run, "tex_term") == pytest.approx(
        100 * 2 * (256 * 16 + 12) / 3.35e12 / 10e-6)
    assert metrics_common.roofline(run, "uvtex_fused") is None
    run["calls"] = ["tex_term"]
    assert metrics_common.roofline(run, "tex_term") is None
