"""Adam over named leaves with per-leaf learning rates (port of
texgs/train/optim.py).

Numerics of ``torch.optim.Adam`` with eps 1e-15 and betas (0.9, 0.999),
the optimizer texgs reproduces, written as texgs writes them:
    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2;
    p -= lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps).
Each leaf keeps its own step count, so a leaf's moments can be zeroed
(``zero_moments``) as texgs's min-scale reset does.  The leaves are named
by their dotted path in texgs's parameter trees ("uv_net.mlp.w.0"), which
makes ``to_jax`` / ``from_jax`` a direct conversion to and from texgs's
``AdamState`` schema (``mu``, ``nu``, per-leaf ``count``).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

BETA1 = 0.9
BETA2 = 0.999
EPS = 1e-15


def flatten_tree(tree: Any, prefix: str = "") -> dict:
    """{dotted path: leaf} of a tree of dicts and lists."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def nest_tree(flat: Mapping[str, Any]) -> dict:
    """Inverse of ``flatten_tree``: a node whose keys are 0..n-1 is a list."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and sorted(node) == sorted(str(i) for i in range(len(node))):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


class Adam:
    """Moments and step counts for a fixed set of named leaves.

    The parameters themselves live with the model; ``step`` takes them by
    name with their ``.grad`` set, so a leaf replaced by a load keeps its
    moments.  ``transposed`` names the leaves whose texgs layout is the
    transpose of the port's (``nn.Linear`` weights)."""

    def __init__(self, params: Mapping[str, torch.Tensor],
                 transposed=frozenset()):
        self.transposed = frozenset(transposed)
        self.mu = {k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for k, p in params.items()}
        self.count = {k: 0 for k in params}

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor],
             lrs: Mapping[str, float]) -> None:
        """One update of every named leaf from its ``.grad`` (zero where the
        leaf has none), in place."""
        for k, p in params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            c = self.count[k] + 1
            m, v = self.mu[k], self.nu[k]
            m.mul_(BETA1).add_((1 - BETA1) * g)
            v.mul_(BETA2).add_((1 - BETA2) * (g * g))
            m_hat = m / (1 - BETA1 ** c)
            v_hat = v / (1 - BETA2 ** c)
            p.sub_(lrs[k] * m_hat / (torch.sqrt(v_hat) + EPS))
            self.count[k] = c

    def zero_moments(self, key: str) -> None:
        """Zero one leaf's moments, keeping its step count (texgs
        ``zero_moments``)."""
        self.mu[key].zero_()
        self.nu[key].zero_()

    # ------------------------------------------------------------ schema
    def _jax_leaf(self, key: str, t: torch.Tensor) -> np.ndarray:
        a = t.detach().cpu().numpy().copy()   # not a view of the moment
        return a.T.copy() if key in self.transposed else a

    def to_jax(self) -> dict:
        """texgs's ``AdamState`` fields as nested numpy trees."""
        return dict(
            mu=nest_tree({k: self._jax_leaf(k, t) for k, t in self.mu.items()}),
            nu=nest_tree({k: self._jax_leaf(k, t) for k, t in self.nu.items()}),
            count=nest_tree({k: np.asarray(c, np.int32)
                             for k, c in self.count.items()}))

    def load_jax(self, state: Mapping[str, Any], rows: int | None = None,
                 row_keys=frozenset()) -> None:
        """Load texgs's ``AdamState`` fields (``to_jax``'s output or a texgs
        ``state_dict()["optim_state"][...]``).  The leaves in ``row_keys``
        keep their first ``rows`` rows (texgs pads Gaussians to a
        capacity)."""
        mu, nu = flatten_tree(state["mu"]), flatten_tree(state["nu"])
        count = flatten_tree(state["count"])
        for k in self.mu:
            for dst, src in ((self.mu[k], mu[k]), (self.nu[k], nu[k])):
                a = np.array(src, np.float32)
                if k in self.transposed:
                    a = a.T
                if k in row_keys and rows is not None:
                    a = a[:rows]
                if a.shape != tuple(dst.shape):
                    raise ValueError(f"optimizer state {k}: expected "
                                     f"{tuple(dst.shape)}, got {a.shape}")
                dst.copy_(torch.as_tensor(a))
            self.count[k] = int(np.asarray(count[k]))
