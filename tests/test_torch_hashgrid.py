"""The port's hash-grid encoding and inverse UV net against texgs.

``HashGrid`` (kernel K5's plain version on the CPU) and ``InvUVNet``
against texgs's ``apply_hashgrid(backend="xla")``, its interpret-mode
Pallas ``hash_gather`` and ``apply_inv_uv_net``: outputs and gradients,
on the same numpy inputs, at tests/test_hashgrid.py's tolerances
(features atol 1e-6 / rtol 1e-5; table gradients atol 1e-5 / rtol 1e-4,
query gradients atol 1e-4 / rtol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texgs.config import Cfg as JCfg
from texgs.nets import hashgrid as jhg
from texgs.nets.pallas_hashgrid import BLOCK_Q
from texgs.nets.pallas_hashgrid import hash_gather as jax_hash_gather
from texgs.nets.uv_net import apply_inv_uv_net, init_inv_uv_net
from texgs_torch.config import Cfg
from texgs_torch.nets.hash_gather import gather_plain, hash_gather
from texgs_torch.nets.hashgrid import (HashGrid, indices_and_weights,
                                       level_resolution)
from texgs_torch.nets.uv_net import InvUVNet
from tests.torch_threads import one_thread  # noqa: F401

INV_CFG = {
    "emb_dim": 16,
    "pre_mlp_cfg": {"hash_grid_cfg": {"n_levels": 4, "n_features_per_level": 2,
                                      "max_hashmap": 10},
                    "n_hidden_layers": 1, "n_neurons": 16},
    "mlp_cfg": {"n_hidden_layers": 2, "n_neurons": 16},
}


def _setup(n=1500, levels=4, feats=2, log2=12, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-0.1, 0.1, size=(levels, 2 ** log2, feats)).astype(np.float32)
    x = rng.uniform(size=(n, 3)).astype(np.float32)
    return table, x


def _grid(table) -> HashGrid:
    levels, size, feats = table.shape
    grid = HashGrid(levels, feats, int(np.log2(size)), device="cpu")
    grid.load_jax_params({"table": table})
    return grid


def test_level_resolutions_match_texgs():
    import math
    for level in range(16):
        want = int(math.floor(jhg.BASE_RESOLUTION * jhg.PER_LEVEL_SCALE ** level))
        assert level_resolution(level) == want


def test_indices_and_weights_match_texgs():
    # points right up to the unit cube's faces, where uint32 wrap-around of
    # the hash products matters most at fine levels
    _, x = _setup(n=3000)
    x[:10] = 1.0
    x[10:20] = 0.0
    idx_w, w_w = jhg._indices_and_weights(jnp.asarray(x), 8, 4096)
    idx, w = indices_and_weights(torch.as_tensor(x), 8, 4096)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_w))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_w), atol=1e-6)


# (levels, log2 table rows, F): the flagship's F = 4 and 8 levels on
# smaller tables, as the interpret-mode kernel's time grows with levels x
# rows x F (the flagship's 8 levels of 4,096 rows of 4 take ~75 s on a CPU)
@pytest.mark.parametrize("levels,log2,feats", [(4, 12, 2), (2, 10, 4),
                                               (2, 8, 2), (8, 7, 4)])
def test_gather_matches_pallas_interpret(levels, log2, feats):
    """The gather (its plain version on the CPU) against texgs's Pallas
    hash_gather in interpret mode, exactly, at F = 2 and 4; every corner
    row's first and last query read table rows 0 and T - 1.  texgs needs
    T % 128 == 0 and N % 1024 == 0."""
    table, x = _setup(n=BLOCK_Q, levels=levels, feats=feats, log2=log2)
    idx, _ = jhg._indices_and_weights(jnp.asarray(x), levels, 2 ** log2)
    idx = np.array(idx)
    idx[:, 0], idx[:, -1] = 0, 2 ** log2 - 1
    want = jax_hash_gather(jnp.asarray(table), jnp.asarray(idx), levels, 8)
    got = hash_gather(torch.as_tensor(table), torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        gather_plain(torch.as_tensor(table), torch.as_tensor(idx)).numpy(),
        np.asarray(want))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_hashgrid_matches_texgs(backend):
    table, x = _setup(n=BLOCK_Q)
    want = jhg.apply_hashgrid({"table": jnp.asarray(table)}, jnp.asarray(x),
                              backend=backend)
    got = _grid(table)(torch.as_tensor(x)).detach()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_hashgrid_grads_match_texgs(backend):
    table, x = _setup(n=BLOCK_Q)
    cot = np.random.default_rng(3).normal(size=(BLOCK_Q, 8)).astype(np.float32)
    g_t_w, g_x_w = jax.grad(
        lambda t, xx: jnp.sum(jhg.apply_hashgrid({"table": t}, xx,
                                                 backend=backend) * cot),
        argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))
    grid = _grid(table)
    xt = torch.tensor(x, requires_grad=True)
    (grid(xt) * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(grid.table.grad.numpy(), np.asarray(g_t_w),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x_w), atol=1e-4,
                               rtol=1e-4)
    assert np.abs(grid.table.grad.numpy()).max() > 0


def _inv_nets(seed=0, offset=False):
    cfg = dict(INV_CFG)
    if offset:
        cfg.update(xyz_offset=[0.1, -0.2, 0.3], xyz_scale=[1.5, 2.0, 0.5])
    params = init_inv_uv_net(jax.random.PRNGKey(seed), JCfg(cfg))
    params["hashgrid"]["table"] = params["hashgrid"]["table"] + 0.05 * jax.random.normal(
        jax.random.PRNGKey(seed + 1), params["hashgrid"]["table"].shape)
    net = InvUVNet(Cfg(cfg), device="cpu")
    net.load_jax_params(jax.tree.map(np.asarray, params))
    return JCfg(cfg), params, net


@pytest.mark.parametrize("offset", [False, True], ids=["plain", "xyz_scale"])
def test_inv_uv_net_matches_texgs(offset):
    cfg, params, net = _inv_nets(offset=offset)
    rng = np.random.default_rng(5)
    uv = rng.normal(size=(700, 3))
    uv = (uv / np.linalg.norm(uv, axis=-1, keepdims=True)).astype(np.float32)
    geo = rng.normal(size=16).astype(np.float32)
    cot = rng.normal(size=(700, 3)).astype(np.float32)

    def f(p, u, g):
        return jnp.sum(apply_inv_uv_net(p, cfg, u, g) * cot)

    want = apply_inv_uv_net(params, cfg, jnp.asarray(uv), jnp.asarray(geo))
    g_p, g_uv, g_geo = jax.grad(f, argnums=(0, 1, 2))(
        params, jnp.asarray(uv), jnp.asarray(geo))
    uv_t = torch.tensor(uv, requires_grad=True)
    geo_t = torch.tensor(geo, requires_grad=True)
    out = net(uv_t, geo_t)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    (out * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(uv_t.grad.numpy(), np.asarray(g_uv), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(geo_t.grad.numpy(), np.asarray(g_geo),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(net.hashgrid.table.grad.numpy(),
                               np.asarray(g_p["hashgrid"]["table"]),
                               atol=1e-5, rtol=1e-4)
    for part in ("pre_mlp", "mlp"):
        for lin, gw, gb in zip(getattr(net, part).layers, g_p[part]["w"],
                               g_p[part]["b"]):
            np.testing.assert_allclose(lin.weight.grad.numpy().T, np.asarray(gw),
                                       atol=1e-4, rtol=1e-4)
            np.testing.assert_allclose(lin.bias.grad.numpy(), np.asarray(gb),
                                       atol=1e-4, rtol=1e-4)


def test_inv_uv_net_params_round_trip():
    _, params, net = _inv_nets(seed=2)
    back = net.jax_params()
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
