"""Densification ops of the port (texgs_torch.train.densify) against
texgs's (texgs/train/densify.py), row for row.

Both packages get the same numpy-seeded state, Adam moments and stats;
texgs's state is at capacity == n (grown with its own ``grow_capacity``
where densification adds rows, and then its first n_alive rows are
compared).  The split children take texgs's normal draws.  Tolerance:
float32 rounding (rtol 1e-6, atol 1e-6); masks and counts exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texgs.core.state import GaussianState as JState
from texgs.train import densify as jd
from texgs.train import optim as jopt
from texgs_torch.core.state import GaussianState
from texgs_torch.train import densify as td
from texgs_torch.train import optim as topt
from tests.torch_threads import one_thread  # noqa: F401

N = 256
KEYS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")


def inputs(seed=0):
    """(params, mu, nu, stats) as numpy: 256 Gaussians, SH degree 1."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    params = dict(
        xyz=rng.normal(size=(N, 3)).astype(f32),
        f_dc=rng.normal(size=(N, 1, 3)).astype(f32),
        f_rest=(0.1 * rng.normal(size=(N, 3, 3))).astype(f32),
        opacity=rng.uniform(-6, 3, size=(N, 1)).astype(f32),
        scaling=rng.uniform(-5, -0.5, size=(N, 3)).astype(f32),
        rotation=rng.normal(size=(N, 4)).astype(f32))
    mu = {k: rng.normal(size=v.shape).astype(f32) for k, v in params.items()}
    nu = {k: rng.uniform(size=v.shape).astype(f32) for k, v in params.items()}
    denom = rng.integers(0, 4, size=(N, 1)).astype(f32)
    stats = dict(
        xyz_gradient_accum=(rng.uniform(0, 1e-3, size=(N, 1)) * denom).astype(f32),
        denom=denom,
        max_radii2d=rng.integers(0, 40, size=N).astype(f32))
    return params, mu, nu, stats


def jax_side(params, mu, nu, stats):
    state = JState(**{f: jnp.asarray(params[k]) for f, k in zip(
        ("xyz", "features_dc", "features_rest", "opacity", "scaling",
         "rotation"), KEYS)}, n_alive=jnp.asarray(N, jnp.int32))
    adam = jopt.AdamState(
        mu={k: jnp.asarray(v) for k, v in mu.items()},
        nu={k: jnp.asarray(v) for k, v in nu.items()},
        count={k: jnp.asarray(7, jnp.int32) for k in KEYS})
    return state, adam, jd.DensifyStats(**{k: jnp.asarray(v)
                                           for k, v in stats.items()})


def torch_side(params, mu, nu, stats):
    state = GaussianState.from_params({k: torch.as_tensor(v)
                                       for k, v in params.items()})
    adam = topt.Adam(state.params_dict())
    for k in KEYS:
        adam.mu[k].copy_(torch.as_tensor(mu[k]))
        adam.nu[k].copy_(torch.as_tensor(nu[k]))
        adam.count[k] = 7
    return state, adam, td.DensifyStats(**{k: torch.as_tensor(v)
                                           for k, v in stats.items()})


def assert_rows_match(jstate, jadam, tstate, tadam, jstats=None, tstats=None):
    n = int(jstate.n_alive)
    assert tstate.n_alive == n
    jp = jstate.params_dict()
    for k in KEYS:
        np.testing.assert_allclose(tstate.params_dict()[k].numpy(),
                                   np.asarray(jp[k])[:n], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
        for m in ("mu", "nu"):
            np.testing.assert_allclose(getattr(tadam, m)[k].numpy(),
                                       np.asarray(getattr(jadam, m)[k])[:n],
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{m}.{k}")
        assert tadam.count[k] == int(jadam.count[k]) == 7
    if jstats is not None:
        for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
            np.testing.assert_allclose(getattr(tstats, k).numpy(),
                                       np.asarray(getattr(jstats, k))[:n],
                                       rtol=1e-6, atol=1e-9, err_msg=k)


def test_add_stats_and_avg_grads():
    params, mu, nu, stats = inputs()
    rng = np.random.default_rng(3)
    vs = rng.normal(scale=1e-3, size=(N, 2)).astype(np.float32)
    radii = (rng.integers(0, 30, size=N) * (rng.uniform(size=N) < 0.7)).astype(
        np.int32)
    _, _, jstats = jax_side(params, mu, nu, stats)
    _, _, tstats = torch_side(params, mu, nu, stats)
    want = jd.add_stats(jstats, jnp.asarray(vs), jnp.asarray(radii))
    got = td.add_stats(tstats, torch.as_tensor(vs), torch.as_tensor(radii))
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-6,
                                   atol=1e-9, err_msg=k)
    np.testing.assert_allclose(td.avg_grads(got).numpy(),
                               np.asarray(jd.avg_grads(want)), rtol=1e-6)


@pytest.mark.parametrize("op", ["reset_opacity", "reset_min_scale"])
def test_resets(op):
    args = inputs(1)
    jstate, jadam, _ = jax_side(*args)
    tstate, tadam, _ = torch_side(*args)
    jstate, jadam = getattr(jd, op)(jstate, jadam)
    tstate = getattr(td, op)(tstate, tadam)
    assert_rows_match(jstate, jadam, tstate, tadam)
    key = "opacity" if op == "reset_opacity" else "scaling"
    assert not tadam.mu[key].any() and not tadam.nu[key].any()


def test_opacity_prune():
    args = inputs(2)
    jstate, jadam, jstats = jax_side(*args)
    tstate, tadam, tstats = torch_side(*args)
    jstate, jadam, jstats = jd.opacity_prune(jstate, jadam, jstats, 0.3)
    tstate, tstats = td.opacity_prune(tstate, tadam, tstats, 0.3)
    assert 0 < tstate.n_alive < N
    assert_rows_match(jstate, jadam, tstate, tadam, jstats, tstats)


@pytest.mark.parametrize("max_screen_size", [None, 20])
def test_densify_and_prune(max_screen_size):
    """Clones, splits (with texgs's draws) and prunes: the rows in texgs's
    order, old rows' moments carried and new rows' zeroed, stats reset."""
    args = inputs(3)
    jstate, jadam, jstats = jax_side(*args)
    tstate, tadam, tstats = torch_side(*args)
    kw = dict(max_grad=2e-4, min_opacity=0.005, extent=4.0,
              max_screen_size=max_screen_size, percent_dense=0.01)
    need = int(jd.required_capacity(jstate, jstats, kw["max_grad"],
                                    kw["extent"], kw["percent_dense"]))
    cap = 1024
    assert need <= cap
    jstate, jadam, jstats = jd.grow_capacity(jstate, jadam, jstats, cap)
    key = jax.random.PRNGKey(11)
    k1, k2 = jax.random.split(key)
    draws = torch.as_tensor(np.stack([
        np.asarray(jax.random.normal(k, (cap, 3)))[:N] for k in (k1, k2)]))
    jstate, jadam, jstats, overflow = jd.densify_and_prune(
        jstate, jadam, jstats, key, **kw)
    tstate, tstats = td.densify_and_prune(tstate, tadam, tstats, draws, **kw)
    assert not bool(overflow)
    grads = td.avg_grads(td.DensifyStats(**{k: torch.as_tensor(v) for k, v in
                                            args[3].items()}))
    n_hot = int((grads >= kw["max_grad"]).sum())
    assert 0 < n_hot < N and tstate.n_alive != N
    assert_rows_match(jstate, jadam, tstate, tadam, jstats, tstats)
    assert not tstats.denom.any()
