"""Both driver kinds rehearsed on the CPU at the test size: the program's
plain versions against the reference, within the cells' limits; and with
the timed path broken underneath, ``correct`` false, once for each fault
the cell can have (one card: no exchange between chips to leave out)."""

import contextlib

import pytest
import torch

import texgs_torch  # noqa: F401
from benchmark import harness
from benchmark.tests.calibrate import half_batch
from benchmark.tests.tiny import cpu_ctx, tiny_cell


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_cell(name):
    cell = tiny_cell(name)
    res = harness.load_module("drivers", cell["work"]["driver"]).run(
        cpu_ctx(cell))
    return res, harness.verdict(res["numbers"], cell["work"]["limits"])


@pytest.mark.parametrize("name", ["tgs3-dtu-train", "tgs3-obj-view"])
def test_sound_run_is_correct(name):
    res, (comp, correct) = run_cell(name)
    assert correct, comp
    assert res["attempted"] >= 1
    assert all(v > 0 for v, _ in (res["metrics"][k] for k in res["metrics"]))


@contextlib.contextmanager
def frozen_step():
    """A step that returns its state unchanged: no Adam moves a leaf."""
    from texgs_torch.train import optim
    orig = optim.Adam.step
    optim.Adam.step = lambda self, params, lrs: None
    try:
        yield
    finally:
        optim.Adam.step = orig


@contextlib.contextmanager
def altered_image():
    """Each frame's image altered where visual_step produces it."""
    from texgs_torch.train.texture_gaussian3d import TextureGaussian3D
    orig = TextureGaussian3D.visual_step

    def bad(self, *a, **k):
        out = orig(self, *a, **k)
        img = out["image"].clone()
        img[:, :8, :8] += 0.05
        return {**out, "image": img}
    TextureGaussian3D.visual_step = bad
    try:
        yield
    finally:
        TextureGaussian3D.visual_step = orig


@pytest.mark.parametrize("name,fault", [
    ("tgs3-dtu-train", frozen_step), ("tgs3-dtu-train", half_batch),
    ("tgs3-obj-view", altered_image)])
def test_broken_path_is_not_correct(name, fault):
    with fault():
        _, (comp, correct) = run_cell(name)
    assert not correct, comp
