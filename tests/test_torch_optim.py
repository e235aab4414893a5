"""The port's Adam, learning-rate schedules, range gating and ground-truth
camera fields against texgs's.  Adam is elementwise float32 arithmetic in
both packages: parameters and moments agree to 1e-6 relative."""

import numpy as np
import pytest
import torch

from texgs.config import in_range as jax_in_range
from texgs.core.camera import look_at_camera as jax_look_at_camera
from texgs.train import optim as joptim
from texgs.utils import schedules as jsched
from texgs_torch.config import in_range
from texgs_torch.core.camera import look_at_camera, with_ground_truth
from texgs_torch.train import optim
from texgs_torch.utils import schedules
from tests.torch_threads import one_thread  # noqa: F401


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "net": {"w": [rng.normal(size=(4, 2)).astype(np.float32)],
                    "b": [rng.normal(size=(2,)).astype(np.float32)]}}


def test_adam_matches_texgs_and_converts_state():
    params = _tree()
    lrs = {"a": 0.01, "net": {"w": [0.002], "b": [0.003]}}
    jp, js = params, joptim.init(params)
    leaves = {k: torch.tensor(v.T.copy() if ".w." in f".{k}." else v)
              for k, v in optim.flatten_tree(params).items()}
    adam = optim.Adam(leaves, {"net.w.0"})
    flat_lrs = optim.flatten_tree(lrs)
    for step in range(4):
        grads = _tree(step + 1)
        jp, js = joptim.update(jp, grads, js, lrs)
        if step == 2:
            js = joptim.zero_moments(js, "a")
        for k, g in optim.flatten_tree(grads).items():
            leaves[k].grad = torch.tensor(g.T.copy() if k == "net.w.0" else g)
        adam.step(leaves, flat_lrs)
        if step == 2:
            adam.zero_moments("a")
    for k, v in optim.flatten_tree(jp).items():
        got = leaves[k].numpy()
        np.testing.assert_allclose(got.T if k == "net.w.0" else got,
                                   np.asarray(v), rtol=1e-6, atol=1e-6)
    state = adam.to_jax()
    for field in ("mu", "nu", "count"):
        want = optim.flatten_tree(getattr(js, field))
        got = optim.flatten_tree(state[field])
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-9)
    again = optim.Adam(leaves, {"net.w.0"})
    again.load_jax(state)
    for k in leaves:
        torch.testing.assert_close(again.mu[k], adam.mu[k], rtol=0, atol=0)
        assert again.count[k] == adam.count[k] == 4


def test_adam_load_slices_capacity_rows():
    leaves = {"xyz": torch.zeros(3, 2)}
    adam = optim.Adam(leaves)
    state = {f: {"xyz": np.arange(10, dtype=np.float32).reshape(5, 2)}
             for f in ("mu", "nu")}
    state["count"] = {"xyz": np.int32(7)}
    adam.load_jax(state, rows=3, row_keys={"xyz"})
    np.testing.assert_array_equal(adam.mu["xyz"].numpy(),
                                  state["mu"]["xyz"][:3])
    assert adam.count["xyz"] == 7


def test_schedules_match_texgs():
    kw = dict(lr_init=2e-4, lr_final=2e-6, lr_delay_mult=0.01, max_steps=7500)
    for delay in (0, 500):
        a = jsched.expon_lr(lr_delay_steps=delay, **kw)
        b = schedules.expon_lr(lr_delay_steps=delay, **kw)
        for step in (-1, 0, 1, 250, 2500, 7500, 9000):
            assert b(step) == a(step)
    a = jsched.warmup_multistep(2e-5, [2500, 5000], 0.5)
    b = schedules.warmup_multistep(2e-5, [2500, 5000], 0.5)
    for step in (0, 1, 50, 99, 100, 2499, 2500, 5000, 8000):
        assert b(step) == a(step)


@pytest.mark.parametrize("rng", [None, [], [0, None], [2500, None],
                                 [None, 100], [10, 20], [1, 2, 3]])
def test_in_range_matches_texgs(rng):
    for it in (0, 1, 10, 11, 20, 21, 100, 101, 2500, 2501):
        assert in_range(it, rng) == jax_in_range(it, rng)


def test_ground_truth_premultiplied_as_texgs():
    rng = np.random.default_rng(0)
    image = rng.uniform(-0.2, 1.2, size=(3, 6, 8)).astype(np.float32)
    alpha = rng.uniform(size=(1, 6, 8)).astype(np.float32)
    normal = rng.normal(size=(3, 6, 8)).astype(np.float32)
    eye, up = np.array([3.0, 1.0, 0.5]), np.array([0.0, 0.0, 1.0])
    want = jax_look_at_camera(eye, np.zeros(3), up, 0.8, 0.7, 8, 6,
                              image=image, alpha_mask=alpha, normal=normal)
    cam = look_at_camera(eye, np.zeros(3), up, 0.8, 0.7, 8, 6)
    got = with_ground_truth(cam, image, alpha, normal=normal)
    np.testing.assert_array_equal(got.image, want.image)
    np.testing.assert_array_equal(got.alpha_mask, want.alpha_mask)
    np.testing.assert_array_equal(got.normal, want.normal)
    assert got.depth is None and cam.image is None
    on_tensor = with_ground_truth(cam, torch.as_tensor(image),
                                  torch.as_tensor(alpha))
    np.testing.assert_array_equal(on_tensor.image.numpy(), want.image)
    with pytest.raises(ValueError, match="alpha_mask"):
        with_ground_truth(cam, image, alpha[:, :3])
