"""The port's fused hash encode (kernels K5' and K5'') against texgs.

On CPU tensors ``hash_encode`` runs its plain versions: ``encode_plain``
(the forward) and ``encode_backward_plain`` (the formula the backward
kernel computes, written out, not autograd).  Both are held against
texgs's ``apply_hashgrid(backend="xla")`` and its ``jax.grad``, on the same
numpy inputs: random points from a seed plus points exactly on grid lines
(x = k / res_l), at x = 0 and at x = 1, where a one-ulp difference in
``x * res`` would flip ``floor`` and pick another hash row.  Tolerances are
tests/test_hashgrid.py's: features atol 1e-6 / rtol 1e-5, table gradients
atol 1e-5 / rtol 1e-4, point gradients atol 1e-4 / rtol 1e-4 (the sums run
in another order than XLA's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texgs.nets import hashgrid as jhg
from texgs_torch.nets.hash_encode import (encode_backward_plain, encode_plain,
                                          hash_encode, hash_encode_backward,
                                          hash_encode_forward,
                                          indices_and_weights,
                                          level_resolution)
from texgs_torch.nets.hashgrid import HashGrid
from tests.torch_threads import one_thread  # noqa: F401

# (levels, features, log2 table size): configs/'s grid, and a narrow one
SHAPES = {"L8F4T4096": (8, 4, 12), "L4F2T1024": (4, 2, 10)}
# two table gradients of the plain version: the CPU's index_put_ sums the
# rows' shares in an order that varies with its threads
TABLE_TOL = {"atol": 1e-5, "rtol": 1e-4}


def grid_points(n_levels, per_level=48, seed=1):
    """Points with coordinates exactly on grid lines of each level (k /
    res_l, rounded to f32), some mixed with random coordinates, and rows at
    0, at 1 and mixing the two."""
    rng = np.random.default_rng(seed)
    rows = []
    for level in range(n_levels):
        res = level_resolution(level)
        k = rng.integers(0, res + 1, size=(per_level, 3))
        on = (k / res).astype(np.float32)
        free = rng.uniform(size=(per_level, 3)).astype(np.float32)
        mix = rng.uniform(size=(per_level, 3)) < 0.5
        mix[: per_level // 2] = True          # half wholly on grid lines
        rows.append(np.where(mix, on, free))
    corners = np.array([[(c >> a) & 1 for a in range(3)] for c in range(8)],
                       np.float32)
    return np.concatenate(rows + [corners, np.zeros((2, 3), np.float32),
                                  np.ones((2, 3), np.float32)])


def make_inputs(shape, n=3000, seed=0):
    """(table (L, T, F), points (N, 3), cotangent (N, L F)) as numpy f32:
    n random points from `seed` plus the grid-line and boundary points."""
    levels, feats, log2 = SHAPES[shape]
    rng = np.random.default_rng(seed)
    table = rng.uniform(-0.1, 0.1, size=(levels, 2 ** log2, feats)
                        ).astype(np.float32)
    x = np.concatenate([rng.uniform(size=(n, 3)).astype(np.float32),
                        grid_points(levels, seed=seed + 1)])
    cot = rng.normal(size=(x.shape[0], levels * feats)).astype(np.float32)
    return table, x, cot


def jax_grads(table, x, cot):
    return jax.grad(
        lambda t, xx: jnp.sum(jhg.apply_hashgrid({"table": t}, xx,
                                                 backend="xla") * cot),
        argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))


@pytest.mark.parametrize("shape", SHAPES)
def test_grid_line_indices_match_texgs(shape):
    table, x, _ = make_inputs(shape, n=0)
    levels, size = table.shape[:2]
    idx_w, w_w = jhg._indices_and_weights(jnp.asarray(x), levels, size)
    idx, w = indices_and_weights(torch.as_tensor(x), levels, size)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_w))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_w), atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_encode_plain_matches_texgs(shape):
    table, x, _ = make_inputs(shape, n=8192)
    want = jhg.apply_hashgrid({"table": jnp.asarray(table)}, jnp.asarray(x),
                              backend="xla")
    got = encode_plain(torch.as_tensor(table), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_encode_backward_plain_matches_jax_grad(shape):
    table, x, cot = make_inputs(shape, n=4000)
    g_t_w, g_x_w = jax_grads(table, x, cot)
    d_table, d_x = encode_backward_plain(
        torch.as_tensor(table), torch.as_tensor(x), torch.as_tensor(cot))
    np.testing.assert_allclose(d_table.numpy(), np.asarray(g_t_w), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(d_x.numpy(), np.asarray(g_x_w), atol=1e-4,
                               rtol=1e-4)
    assert np.abs(np.asarray(g_x_w)).max() > 1.0   # a check that can fail
    d_table_only, none = encode_backward_plain(
        torch.as_tensor(table), torch.as_tensor(x), torch.as_tensor(cot),
        need_x=False)
    assert none is None
    torch.testing.assert_close(d_table_only, d_table, **TABLE_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_encode_backward_plain_matches_autograd(shape):
    """The written-out formula against torch autograd through the plain
    forward, on the same inputs."""
    table, x, cot = make_inputs(shape, n=1500, seed=3)
    t = torch.tensor(table, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    (encode_plain(t, xt) * torch.as_tensor(cot)).sum().backward()
    d_table, d_x = encode_backward_plain(torch.as_tensor(table),
                                         torch.as_tensor(x),
                                         torch.as_tensor(cot))
    torch.testing.assert_close(d_table, t.grad, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(d_x, xt.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_hash_encode_wrapper_runs_plain_versions_on_cpu(shape):
    table, x, cot = make_inputs(shape, n=1500, seed=5)
    t = torch.tensor(table, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    before = (hash_encode.launches, hash_encode_backward.launches)
    out = hash_encode(t, xt)
    (out * torch.as_tensor(cot)).sum().backward()
    assert (hash_encode.launches, hash_encode_backward.launches) == before
    tt, xx, cc = (torch.as_tensor(a) for a in (table, x, cot))
    torch.testing.assert_close(out.detach(), encode_plain(tt, xx), atol=0,
                               rtol=0)
    d_table, d_x = encode_backward_plain(tt, xx, cc)
    torch.testing.assert_close(t.grad, d_table, **TABLE_TOL)
    torch.testing.assert_close(xt.grad, d_x, atol=0, rtol=0)
    # the kernel entry points take the same plain versions on the CPU
    got, idx, w = hash_encode_forward(tt, xx, corners=True)
    torch.testing.assert_close(got, encode_plain(tt, xx), atol=0, rtol=0)
    idx_w, w_w = indices_and_weights(xx, *table.shape[:2])
    torch.testing.assert_close(idx, idx_w, atol=0, rtol=0)
    torch.testing.assert_close(w, w_w, atol=0, rtol=0)
    assert hash_encode_backward(tt, xx, cc, need_x=False)[1] is None
    assert (hash_encode.launches, hash_encode_backward.launches) == before


@pytest.mark.parametrize("shape", SHAPES)
def test_hashgrid_module_grads_match_texgs(shape):
    """HashGrid's forward and backward (the autograd Function) against
    apply_hashgrid and its jax.grad, table and points."""
    table, x, cot = make_inputs(shape, n=2000, seed=7)
    levels, feats, log2 = SHAPES[shape]
    want = jhg.apply_hashgrid({"table": jnp.asarray(table)}, jnp.asarray(x),
                              backend="xla")
    g_t_w, g_x_w = jax_grads(table, x, cot)
    grid = HashGrid(levels, feats, log2, device="cpu")
    grid.load_jax_params({"table": table})
    xt = torch.tensor(x, requires_grad=True)
    out = grid(xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-6, rtol=1e-5)
    (out * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(grid.table.grad.numpy(), np.asarray(g_t_w),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x_w), atol=1e-4,
                               rtol=1e-4)


def test_hash_encode_without_point_gradient():
    """A point that needs no gradient gets none, and the table's is the
    same."""
    table, x, cot = make_inputs("L4F2T1024", n=500, seed=9)
    t = torch.tensor(table, requires_grad=True)
    (hash_encode(t, torch.as_tensor(x)) * torch.as_tensor(cot)).sum().backward()
    want, _ = encode_backward_plain(torch.as_tensor(table), torch.as_tensor(x),
                                    torch.as_tensor(cot))
    torch.testing.assert_close(t.grad, want, **TABLE_TOL)


def test_hash_encode_empty_query():
    table, _, _ = make_inputs("L4F2T1024", n=0)
    t = torch.tensor(table, requires_grad=True)
    x = torch.zeros((0, 3), requires_grad=True)
    out = hash_encode(t, x)
    assert out.shape == (0, 8)
    out.sum().backward()
    assert not bool(t.grad.any()) and x.grad.shape == (0, 3)
