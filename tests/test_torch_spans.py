"""The port's spans (texgs_torch/utils/spans.py): recorded into a running
torch.profiler's trace, a shared null context without one, recorded inside
an autograd backward; the stage-3 model's phases, once per training
step and per viewer frame, on the benchmark's cells cut to the test size
(benchmark/tests/tiny.py); and the stage-1 model's phases and surgery on
the stage-1 cell cut the same way (benchmark/tests/tiny_gs1.py)."""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.torch_threads import one_thread  # noqa: F401
from texgs_torch.utils import spans
from texgs_torch.utils.spans import span, spanned


def names(prof) -> collections.Counter:
    """How often each ``texgs::`` range occurs in the profile."""
    return collections.Counter(e.name for e in prof.events()
                               if e.name.startswith(spans.PREFIX))


def test_span_records_while_a_profiler_runs():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer"):
            with span("inner"):
                torch.ones(4).sum()
    assert names(prof) == {"texgs::outer": 1, "texgs::inner": 1}


def test_span_is_one_shared_null_context_without_a_profiler():
    a, b = span("render"), span("loss")
    assert a is b
    with a:
        torch.ones(4).sum()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()     # no span opened while it records
    assert not names(prof)
    # after a profile the guard is off again
    assert span("render") is a


def test_spanned_keeps_the_function_and_its_counter():
    @spanned("kernel.f")
    def f(x, y=1):
        """f's docstring."""
        f.launches += 1
        return x + y
    f.launches = 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert f(1, y=2) == 3
    assert f(2) == 3
    assert f.launches == 2 and f.__name__ == "f" and f.__doc__
    assert names(prof) == {"texgs::kernel.f": 1}


class _Double(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        with span("fwd"):
            return 2 * x

    @staticmethod
    def backward(ctx, g):
        with span("bwd"):
            return 2 * g


def test_span_inside_a_backward_is_recorded():
    x = torch.ones(8, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("backward"):
            _Double.apply(x).sum().backward()
    assert names(prof) == {"texgs::fwd": 1, "texgs::bwd": 1,
                           "texgs::backward": 1}
    assert torch.equal(x.grad, torch.full((8,), 2.0))


# ------------------------------------------------ the stage-3 model's phases
N_STEPS = 2


@pytest.fixture(scope="module")
def trainer():
    from benchmark.drivers import train_loop
    from benchmark.tests.tiny import tiny_cell
    cell = tiny_cell("tgs3-dtu-train")
    return train_loop.Session(cell["config"], cell["work"]["traffic_params"],
                              7, "cpu")


def test_training_step_phases(trainer):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(N_STEPS):
            trainer.step()
    got = names(prof)
    for phase in ("step", "render", "loss", "backward", "adam",
                  "render.uv_net", "render.project", "render.binning",
                  "render.blend", "render.tex_term", "kernel.uvtex_fused",
                  "kernel.uvtex_fused_bwd", "kernel.tex_term",
                  "kernel.tex_term_bwd"):
        assert got["texgs::" + phase] == N_STEPS, (phase, got)
    assert "texgs::view" not in got and "texgs::maps" not in got


def test_phases_nest_in_the_training_step(trainer):
    """render, loss, backward and adam open inside step, one after
    another; the sub-spans of render inside render."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.step()
    ev = {e.name[len(spans.PREFIX):]: e.time_range for e in prof.events()
          if e.name.startswith(spans.PREFIX)}
    step = ev["step"]
    order = [ev[p] for p in ("render", "loss", "backward", "adam")]
    assert all(step.start <= r.start and r.end <= step.end for r in order)
    assert all(a.end <= b.start for a, b in zip(order, order[1:]))
    for sub in ("uv_net", "project", "binning", "blend", "tex_term"):
        r = ev["render." + sub]
        assert ev["render"].start <= r.start and r.end <= ev["render"].end


def test_viewer_frame_phases():
    from benchmark import program, scene
    from benchmark.drivers import view_loop
    from benchmark.tests.tiny import tiny_cell
    cell = tiny_cell("tgs3-obj-view")
    cfg, work = cell["config"], cell["work"]["traffic_params"]
    state, _ = scene.make_state(cfg, 7, "cpu")
    model = program.build_model(cfg, state, view_loop.hyper(cfg), "cpu",
                                train=False)
    cam_of = view_loop.orbit(work, 7)
    n_frames = 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(n_frames):
            model.visual_step(0, 0, program.camera(cam_of(k)), None)
    got = names(prof)
    for phase in ("view", "render", "maps", "kernel.uvtex_fused",
                  "kernel.tex_term"):
        assert got["texgs::" + phase] == n_frames, (phase, got)
    for phase in ("step", "loss", "backward", "adam",
                  "kernel.uvtex_fused_bwd"):
        assert "texgs::" + phase not in got


# ------------------------------------------------ the stage-1 model's phases
GS1_PHASES = ("render", "loss", "backward", "adam")
GS1_RENDER = ("render.sh", "render.project", "render.binning", "render.blend")


@pytest.fixture(scope="module")
def gs1_trainer():
    from benchmark.drivers import gs1_train_loop
    from benchmark.tests.tiny_gs1 import tiny_gs1_cell
    cell = tiny_gs1_cell()
    return gs1_train_loop.Session(cell["config"],
                                  cell["work"]["traffic_params"], 7, "cpu")


def test_stage1_step_phases(gs1_trainer):
    """step, its four phases and render's sub-spans, once a step, nested
    as the reduction reads them; no surgery off its schedule."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gs1_trainer.step()
    got = names(prof)
    for name in ("step", *GS1_PHASES, *GS1_RENDER, "kernel.raster",
                 "kernel.raster_bwd"):
        assert got["texgs::" + name] == 1, (name, got)
    assert "texgs::surgery" not in got
    ev = {e.name[len(spans.PREFIX):]: e.time_range for e in prof.events()
          if e.name.startswith(spans.PREFIX)}
    order = [ev[p] for p in GS1_PHASES]
    assert all(ev["step"].start <= r.start and r.end <= ev["step"].end
               for r in order)
    assert all(a.end <= b.start for a, b in zip(order, order[1:]))
    for sub in GS1_RENDER:
        assert ev["render"].start <= ev[sub].start
        assert ev[sub].end <= ev["render"].end


def test_stage1_surgery_step(gs1_trainer):
    """Iteration 19,000: the min-scale reset in ``surgery``, after the
    step, which takes no Adam step."""
    gs1_trainer.it = 19000
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gs1_trainer.step()
    got = names(prof)
    assert got["texgs::surgery"] == 1 and got["texgs::step"] == 1, got
    assert "texgs::adam" not in got
    ev = {e.name[len(spans.PREFIX):]: e.time_range for e in prof.events()
          if e.name.startswith(spans.PREFIX)}
    assert ev["step"].end <= ev["surgery"].start
