"""The benchmark's stage-1 cell (``gs1-dtu-train``) on the CPU at the test
size (benchmark/tests/tiny_gs1.py: 400 Gaussians, 64x48 views, SH 3,
seeded state): the program's ``Gaussian3D`` step against the plain
reference ``benchmark/reference/stage1.py`` (loss, each leaf's gradient,
one Adam step, the four render outputs), a tiny run of the cell's driver
that comes out ``correct``, the three faults its limits must catch, and
the counts and span readers the cell's per-layer metrics use."""

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny_gs1 import tiny_gs1_cell
from tests.torch_threads import one_thread  # noqa: F401

SEED = 2718281829
LEAVES = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")
OUTPUTS = {"image": "render", "depth": "depth", "norm": "norm",
           "alpha": "alpha"}


@pytest.fixture(scope="module")
def step():
    """One program step and one reference step at the first iteration,
    from the same state and view."""
    import texgs_torch  # noqa: F401  (TF32 off, as the program runs)
    from benchmark import program, program_gs1
    from benchmark.drivers import gs1_train_loop as G
    from benchmark.reference import stage1 as ref1
    from texgs_torch.config import Cfg
    cfg = tiny_gs1_cell()["config"]
    state, views, hy = G.build(cfg, SEED, "cpu")
    it = G.first_iteration(cfg)
    model = program_gs1.build_model(cfg, state, hy, "cpu")
    render, outs = model._render, {}

    def capture(*a, **k):
        out = render(*a, **k)
        outs.update({r: out[p].detach().clone() for r, p in OUTPUTS.items()})
        return out
    model._render = capture
    loss, _, _ = model.compute_loss(it, 30000, program.camera(
        views[0]["cam"], views[0]), None, Cfg(cfg["loss_cfg"]))
    leaves = program_gs1.leaves(model)
    prog = {"loss": float(loss), "outs": outs,
            "grads": {k: p.grad.detach().clone() for k, p in leaves.items()},
            "after": {k: p.detach().clone() for k, p in leaves.items()}}

    opt = {k: (torch.zeros_like(v), torch.zeros_like(v), hy["adam_count"])
           for k, v in state.items()}
    tr = ref1.Trainer(state, opt, hy, cfg)
    r_loss, r_outs, r_grads = tr.step(it, views[0], torch.zeros(3))
    ref = {"loss": float(r_loss), "outs": r_outs,
           "grads": dict(zip(tr.state, r_grads)), "after": tr.state}
    lrs = tr.lrs(it)
    return prog, ref, state, lrs


def test_loss_matches_reference(step):
    # the same float32 operations in the same order on one thread; the
    # room is for the blend's channel sums, which the program takes as a
    # fancy index and the reference as an index_select
    prog, ref, _, _ = step
    assert ref["loss"] > 0
    assert prog["loss"] == pytest.approx(ref["loss"], rel=1e-6)


@pytest.mark.parametrize("leaf", LEAVES)
def test_leaf_gradient_matches_reference(step, leaf):
    # autograd through the same operations: the backward of the fancy
    # index (an ordered accumulate) and of index_select (an index_add) add
    # a Gaussian's pairs in different orders, a few ulps of the largest
    # entry
    prog, ref, _, _ = step
    g, g_ref = prog["grads"][leaf], ref["grads"][leaf]
    assert g_ref.abs().max() > 0
    torch.testing.assert_close(g, g_ref, rtol=1e-4,
                               atol=1e-5 * float(g_ref.abs().max()))


@pytest.mark.parametrize("leaf", LEAVES)
def test_adam_step_matches_reference(step, leaf):
    # with zero moments the first step is lr * 0.1 g / sqrt(0.001 g^2), a
    # step of ~3.16 lr whatever |g|: where the gradient is round-off (below
    # a thousandth of its leaf's root mean square, the driver's rule) its
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


@pytest.mark.parametrize("name", OUTPUTS)
def test_render_output_matches_reference(step, name):
    # the forward alone: the same operations, summed in one order
    prog, ref, _, _ = step
    out, out_ref = prog["outs"][name], ref["outs"][name]
    assert out.shape == out_ref.shape and out_ref.abs().max() > 0
    torch.testing.assert_close(out, out_ref, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------- the cell's driver
def test_tiny_run_is_correct():
    import time
    from types import SimpleNamespace

    import texgs_torch  # noqa: F401
    cell = tiny_gs1_cell()
    ctx = SimpleNamespace(torch=torch, device="cpu", cell=cell, seed=SEED,
                          seconds=0.3, trace=False, t0=time.perf_counter())
    res = harness.load_module("drivers", "gs1_train_loop").run(ctx)
    comp, correct = harness.verdict(res["numbers"], cell["work"]["limits"])
    assert correct, comp
    assert set(comp) == {"loss1", "grad", "delta", "image", "depth", "norm",
                         "alpha"}
    assert res["attempted"] >= 1
    assert all(v > 0 for v, _ in res["metrics"].values())


@pytest.fixture(scope="module")
def fault_reference():
    import texgs_torch  # noqa: F401
    from benchmark.drivers import gs1_train_loop as G
    cell = tiny_gs1_cell()
    ses = G.Session(cell["config"], cell["work"]["traffic_params"], SEED,
                    "cpu")
    return cell, ses.reference()


@pytest.mark.parametrize("fault", ["half", "frozen", "sh0"])
def test_fault_is_not_correct(fault_reference, fault):
    """Half of each view out of the loss, a frozen Adam, SH held at degree
    0 (``f_rest`` left out): each fails a limit of the cell."""
    from benchmark.drivers import gs1_train_loop as G
    from benchmark.tests.calibrate_gs1 import FAULTS
    cell, ref = fault_reference
    with FAULTS[fault]():
        bad = G.Session(cell["config"], cell["work"]["traffic_params"], SEED,
                        "cpu")
    comp, correct = harness.verdict(G.numbers(bad.prog, ref),
                                    cell["work"]["limits"])
    assert not correct, comp


# -------------------------------------------------- counts and readers
def test_counts_on_a_hand_checked_case():
    """10 Gaussians, 2 tiles (512 pixels), 30 pairs, 1,000 evaluated
    entries, F = 7, a 32x16 view at SH 3."""
    c = {"n": 10, "n_f": 7, "n_tiles": 2, "n_pairs": 30, "n_eval": 1000,
         "width": 32, "height": 16, "sh_degree": 3}

    def count(name):
        return harness.load_module("counts", name).count(c)
    # table 10 x 16 x 4 = 640, pairs 120, tile ends 16, blend 512 x 7 x 4
    # = 14,336, T_final 2,048, evaluated counts 2,048; (16 + 14) an entry
    assert count("raster") == (19208, 30000)
    # table and its gradient 1,280, pairs 120, tile ends 16, blend and
    # T_final with their cotangents 2 x 16,384; (40 + 21) an entry
    assert count("raster_bwd") == (34184, 61000)
    # stage3_step.stage1_counts' six components at N = 10, 30 pairs, 512
    # pixels, 16 SH coefficients
    flops = (3 * 10 * (4 * 16 + 2 * 16 * 3) + 3 * 10 * 250 + 30 * 10
             + 3 * 30 * 256 * 40 + 3 * 512 * 3 * 46 + 10 * 59 * 12)
    n_bytes = (10 * (16 * 3 + 6) * 8 + 10 * 60 * 8 + 30 * 8 * 4 * 4
               + 30 * 16 * 4 * 3 + 512 * 3 * 4 * 6 + 10 * 59 * 4 * 7)
    assert count("stage1_step") == (n_bytes, flops)


def test_quantities_of_a_step():
    from benchmark import quantities_gs1, scene, scene_gs1
    from benchmark.reference import render as R
    cfg = tiny_gs1_cell()["config"]
    state, _ = scene_gs1.make_state(cfg, SEED, "cpu")
    cam = scene.spiral_views(cfg["assumed"]["views"])[0]
    q = quantities_gs1.of_call(state, cam, cfg)
    gy, gx = R.grid_shape(cam.height, cam.width)
    assert (q["n"], q["n_f"], q["n_tiles"], q["sh_degree"]) == (400, 7,
                                                                gy * gx, 3)
    assert 0 < q["n_pairs"] and 0 < q["n_eval"] <= q["n_pairs"] * 256


def _run(spans):
    return {"trace": {"kernels": 48, "window_s": 1.0, "busy_s": 0.25,
                      **({"spans": spans} if spans is not None else {})},
            "steps": 2, "calls": [], "per_step": []}


@pytest.mark.parametrize("spans", [None, {"steps": 0, "syncs": 0,
                                          "phases": {"outside": {}}}])
def test_span_readers_read_nothing_without_steps(spans):
    """The parent's program has no stage-1 spans: its readers read None."""
    for name in ("launches_per_step.render.gs1",
                 "launches_per_step.backward.gs1",
                 "launches_per_step.adam.gs1",
                 "idle_ms_per_step.backward.gs1", "host_syncs_per_step.gs1"):
        assert harness.load_module("metrics", name).read(_run(spans)) is None


def test_span_readers():
    phases = {p: {"launches": n, "idle_s": 0.004 * n, "syncs": 0}
              for p, n in (("render", 10), ("backward", 30), ("adam", 6),
                           ("outside", 2))}
    run = _run({"steps": 2, "syncs": 5, "phases": phases})

    def read(name):
        return harness.load_module("metrics", name).read(run)
    assert read("launches_per_step.render.gs1") == 5
    assert read("launches_per_step.backward.gs1") == 15
    assert read("launches_per_step.adam.gs1") == 3
    assert read("idle_ms_per_step.backward.gs1") == pytest.approx(60.0)
    assert read("host_syncs_per_step.gs1") == 2.5
    assert read("launches_per_step.gs1") == 24
    assert read("device_idle_pct.gs1") == 75.0
