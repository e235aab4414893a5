"""The benchmark's stage-2 cell (``uv2-dtu-train``) on the CPU at the test
size (benchmark/tests/tiny_uv2.py: 400 frozen Gaussians, 64x48 views, a
128-point cloud, the published nets, table and sphere samples): the
program's ``UVMapGaussian3D`` step against the plain reference
``benchmark/reference/stage2.py`` (each loss term, each leaf's gradient,
one Adam step, the nets' outputs on the inverse points), a tiny run of
the cell's driver that comes out ``correct``, the three faults its
limits must catch, and the counts and span readers the cell's per-layer
metrics use, on a recorded tiny trace."""

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny_uv2 import tiny_uv2_cell
from tests.torch_threads import one_thread  # noqa: F401

SEED = 2718281829
TERMS = ("Linv", "Lchamfer", "Linv2")


@pytest.fixture(scope="module")
def step():
    """One program step and one reference step at the first iteration,
    from the same state, view and sphere samples."""
    import texgs_torch  # noqa: F401  (TF32 off, as the program runs)
    from benchmark import program_uv2, scene, scene_uv2
    from benchmark.drivers import uv2_train_loop as U2
    from benchmark.reference import stage2 as ref2
    from texgs_torch.config import Cfg
    cfg = tiny_uv2_cell()["config"]
    gauss, pcd, cams = scene_uv2.build(cfg, SEED, "cpu")
    hy = U2.hyper(cfg)
    model = program_uv2.build_model(cfg, gauss, pcd, SEED, hy, "cpu")
    state = {k: v.detach().clone()
             for k, v in program_uv2.leaves(model).items()}
    scene.prefit_uv_net(state, gauss["xyz"])
    scene_uv2.prefit_inverse_net(state, pcd)
    program_uv2.load_leaves(model, state)
    draws, outs = [], {}
    draw, uv_fwd = model.draws, model.uv_net.forward

    def capture_draws(*a, **k):
        draws.append(draw(*a, **k))
        return draws[-1]

    def capture_uv(*a):
        out = uv_fwd(*a)
        outs.setdefault("uv", out.detach().clone())
        return out
    model.draws, model.uv_net.forward = capture_draws, capture_uv
    it = U2.first_iteration(cfg)
    cam = program_uv2.camera(cams[0], 0)
    _, stats, _ = model.compute_loss(it, 15000, cam, None,
                                     Cfg(cfg["loss_cfg"]))
    leaves = program_uv2.leaves(model)
    prog = {"terms": {k: float(stats[k]) for k in TERMS},
            "loss": float(stats["total_loss"]), "uv": outs["uv"],
            "grads": {k: p.grad.detach().clone() for k, p in leaves.items()},
            "after": {k: p.detach().clone() for k, p in leaves.items()}}

    opt = {k: (torch.zeros_like(v), torch.zeros_like(v), hy["adam_count"])
           for k, v in state.items()}
    tr = ref2.Trainer(state, opt, hy, cfg, pcd)
    lrs = tr.lrs()
    points, _ = ref2.view_points(gauss, cams[0], torch.zeros(3))
    r_loss, r_terms, r_outs, r_grads = tr.step(it, points,
                                               draws[0]["sample_uvs"])
    ref = {"terms": {k: float(v) for k, v in r_terms.items()},
           "loss": float(r_loss), "uv": r_outs["uv"],
           "grads": dict(zip(tr.state, r_grads)), "after": tr.state}
    return prog, ref, state, lrs


@pytest.mark.parametrize("term", TERMS + ("total",))
def test_loss_term_matches_reference(step, term):
    # the same float32 operations but for the hash encode's corner sums
    # and the chamfer's distances (the program expands |q - b|^2, the
    # reference takes the differences), a few ulps of each term
    prog, ref, _, _ = step
    got, want = ((prog["loss"], ref["loss"]) if term == "total"
                 else (prog["terms"][term], ref["terms"][term]))
    assert want > 0
    assert got == pytest.approx(want, rel=1e-5)


def test_inverse_points_are_the_masked_pixels(step):
    """The program's UV net ran on as many points as the reference's mask
    holds, and gave what the reference's gives on them."""
    prog, ref, _, _ = step
    assert prog["uv"].shape == ref["uv"].shape and ref["uv"].shape[0] > 100
    torch.testing.assert_close(prog["uv"], ref["uv"], rtol=1e-5, atol=1e-6)


LEAVES = ("uv_net.pre_mlp.w.0", "uv_net.pre_mlp.b.1", "uv_net.mlp.w.0",
          "uv_net.mlp.w.2", "uv_net.mlp.b.2", "inv_uv_net.hashgrid.table",
          "inv_uv_net.pre_mlp.w.0", "inv_uv_net.pre_mlp.w.1",
          "inv_uv_net.mlp.w.1", "inv_uv_net.mlp.b.2", "geo_emb")


@pytest.mark.parametrize("leaf", LEAVES)
def test_leaf_gradient_matches_reference(step, leaf):
    # autograd through the same operations; the hash table's gradient is
    # the encode's plain VJP in the program and autograd's scatter of the
    # reference's gathers, summed in other orders
    prog, ref, _, _ = step
    g, g_ref = prog["grads"][leaf], ref["grads"][leaf]
    assert g_ref.abs().max() > 0
    torch.testing.assert_close(g, g_ref, rtol=1e-4,
                               atol=1e-5 * float(g_ref.abs().max()))


def test_every_leaf_is_trained(step):
    prog, ref, _, _ = step
    assert set(prog["grads"]) == set(ref["grads"]) and len(ref["grads"]) == 22
    assert set(LEAVES) <= set(ref["grads"])


@pytest.mark.parametrize("leaf", LEAVES)
def test_adam_step_matches_reference(step, leaf):
    # with zero moments the first step is lr * 0.1 g / sqrt(0.001 g^2), a
    # step of ~3.16 lr whatever |g|: where the gradient is round-off (below
    # a thousandth of its leaf's root mean square, train_loop's rule) its
    # sign may differ, so there the step is held to its size alone
    prog, ref, state, lrs = step
    g_ref = ref["grads"][leaf]
    d, d_ref = prog["after"][leaf] - state[leaf], ref["after"][leaf] - state[leaf]
    counts = g_ref.abs() >= 1e-3 * g_ref.pow(2).mean().sqrt()
    assert counts.any() and d_ref[counts].abs().max() > 0
    torch.testing.assert_close(d[counts], d_ref[counts], rtol=1e-4,
                               atol=1e-4 * lrs[leaf])
    rest = d[~counts].abs()
    assert rest.numel() == 0 or float(rest.max()) <= 3.17 * lrs[leaf]


# ---------------------------------------------------- the cell's driver
def _ctx(cell, trace=False):
    return SimpleNamespace(torch=torch, device="cpu", cell=cell, seed=SEED,
                           seconds=0.3, trace=trace, t0=time.perf_counter())


def test_tiny_run_is_correct():
    import texgs_torch  # noqa: F401
    cell = tiny_uv2_cell()
    res = harness.load_module("drivers", "uv2_train_loop").run(_ctx(cell))
    comp, correct = harness.verdict(res["numbers"], cell["work"]["limits"])
    assert correct, comp
    assert set(comp) == {"loss1", "Linv", "Lchamfer", "Linv2", "grad",
                         "delta", "uv", "inv"}
    assert res["numbers"]["mask_differ"] == 0
    assert res["attempted"] >= 1
    assert all(v > 0 for v, _ in res["metrics"].values())


@pytest.fixture(scope="module")
def fault_readings():
    import texgs_torch  # noqa: F401
    from benchmark.tests import calibrate_uv2
    return dict(calibrate_uv2.readings(SEED, "cpu", faults=tuple(
        calibrate_uv2.FAULTS), tiny=True))


@pytest.mark.parametrize("fault", ["subset", "frozen", "oneway"])
def test_fault_is_not_correct(fault_readings, fault):
    """The inverse loss on a subset of the masked points, a frozen hash
    table, a one-directional chamfer: each fails a limit of the cell."""
    limits = tiny_uv2_cell()["work"]["limits"]
    assert harness.verdict(fault_readings["program"], limits)[1]
    comp, correct = harness.verdict(fault_readings[fault], limits)
    assert not correct, comp


# -------------------------------------------------- counts and readers
def _quantities():
    from benchmark import quantities_uv2
    return quantities_uv2.of_call(1000, tiny_uv2_cell()["config"])


def test_quantities_of_a_step():
    c = _quantities()
    assert (c["n_points"], c["n_samples"], c["n_enc"], c["n_pcd"]) == (
        1000, 2048, 3048, 128)
    assert (c["n_levels"], c["n_features"], c["table_size"]) == (8, 4, 4096)
    assert c["uv_layers"] == [(3, 128), (128, 128), (128, 128), (128, 128),
                              (128, 3)]
    assert c["inv_layers"] == [(32, 128), (128, 128), (128, 128), (128, 128),
                               (128, 3)]


def test_counts_on_a_hand_checked_case():
    c = _quantities()

    def count(name):
        return harness.load_module("counts", name).count(c)
    # 3,048 queries of 3 + 32 floats, the 8 x 4,096 x 4 table; a query and
    # level 12 + 8 (11 + 8) ops
    table = 8 * 4096 * 4 * 4
    assert count("hash_encode") == (3048 * 35 * 4 + table,
                                    3048 * 8 * 164)
    # point, cotangent and point gradient a query, the table and its
    # gradient; a query and level 15 + 8 (11 + 16 + 6)
    assert count("hash_encode_bwd") == (3048 * 38 * 4 + 2 * table,
                                        3048 * 8 * 279)
    uv = 3 * 128 + 3 * 128 * 128 + 128 * 3
    inv = 32 * 128 + 3 * 128 * 128 + 128 * 3
    flops = (6 * 3048 * uv + 6 * 3048 * inv + 3048 * 8 * 164
             + 3048 * 8 * 279 + 10 * 2048 * 128)
    assert count("stage2_step")[1] == flops


def test_masked_pixels_from_the_reference():
    from benchmark import quantities_uv2, scene_uv2
    from benchmark.reference import stage2 as ref2
    cfg = tiny_uv2_cell()["config"]
    gauss, _, cams = scene_uv2.build(cfg, SEED, "cpu")
    n = quantities_uv2.masked_pixels(gauss, cams[0], torch.zeros(3))
    points, mask = ref2.view_points(gauss, cams[0], torch.zeros(3))
    assert 0 < n == points.shape[0] == int(mask.sum()) < 64 * 48


def _run(spans):
    return {"trace": {"kernels": 48, "window_s": 1.0, "busy_s": 0.25,
                      **({"spans": spans} if spans is not None else {})},
            "steps": 2, "calls": [], "per_step": []}


SPAN_READERS = ("launches_per_step.loss.uv2", "launches_per_step.backward.uv2",
                "launches_per_step.adam.uv2", "idle_ms_per_step.backward.uv2",
                "host_syncs_per_step.uv2")


@pytest.mark.parametrize("spans", [None, {"steps": 0, "syncs": 0,
                                          "phases": {"outside": {}}}])
def test_span_readers_read_nothing_without_steps(spans):
    """A program without the stage-2 spans: its readers read None."""
    for name in SPAN_READERS:
        assert harness.load_module("metrics", name).read(_run(spans)) is None


def test_readers_on_a_recorded_tiny_trace(tmp_path):
    """Two tiny steps under the profiler, reduced as the traced window is:
    the spans reduce to two steps with the stage-2 phases and sub-spans,
    every reader reads a number, and the roofline readers find one encode
    and one VJP a step."""
    import texgs_torch  # noqa: F401
    from torch.profiler import ProfilerActivity, profile

    from benchmark import program_uv2, quantities_uv2, spans
    from benchmark.drivers import uv2_train_loop as U2
    cell = tiny_uv2_cell()
    ses = U2.Session(cell["config"], cell["work"]["traffic_params"], SEED,
                     "cpu")
    for _ in range(len(ses.cams)):
        ses.step()          # every view cached, as before the window
    calls, undo = harness.wrap_functions(torch,
                                         program_uv2.kernel_functions())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(harness.WINDOW):
            ses.step()
            ses.step()
    undo()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = harness.load_json(tmp_path / "trace.json")["traceEvents"]
    red = spans.reduce(events)
    assert red["steps"] == 2
    assert {"loss", "backward", "adam"} <= set(red["phases"])
    assert "render" not in red["phases"]    # every view was cached
    for name in ("uv2.points", "uv2.uv_net", "uv2.inv_uv_net", "uv2.chamfer",
                 "kernel.hash_encode", "kernel.hash_encode_bwd"):
        assert red["spans"][name]["calls"] == (4 if name == "uv2.uv_net"
                                               else 2), name
    assert calls == ["hash_encode", "hash_encode_bwd"] * 2
    trace = {**harness.reduce_trace(events), "spans": red}
    trace["fn_device_s"] = {"hash_encode": 1e-3, "hash_encode_bwd": 2e-3}
    trace["window_s"], trace["busy_s"] = 1.0, 0.5
    n = quantities_uv2.masked_pixels(ses.gauss, ses.cams[0], torch.zeros(3))
    run = {"trace": trace, "steps": 2, "calls": calls,
           "per_step": [quantities_uv2.of_call(n, cell["config"])] * 2}
    for m in cell["per_layer"]:
        v = harness.load_module("metrics", m["name"]).read(run)
        assert v is not None and v >= 0, m["name"]
    assert harness.load_module("metrics", "device_idle_pct.uv2").read(run) \
        == 50.0


def test_reference_imports_nothing_of_the_program():
    """The plain reference, the scene and the counts load neither JAX nor
    the JAX package nor the program (in a process of their own)."""
    import subprocess
    import sys
    code = ("import sys, benchmark.reference.stage2, benchmark.scene_uv2, "
            "benchmark.quantities_uv2\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            f"set({harness.FORBIDDEN + ('texgs_torch',)!r})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
