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

``adam_plain`` is the plain chain, one leaf at a time (14 device launches
a leaf on the card); ``Adam.step`` runs it for CPU leaves.  Its CUDA leaves
go to ``adam_step``: one launch of csrc/adam.cu for every ``MAX_LEAVES``
leaves that hold an element, the outputs the plain chain's bit for bit,
each launch adding one to ``adam_step.launches``.
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple

import numpy as np
import torch

from texgs_torch import _build
from texgs_torch.utils.spans import spanned

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


def adam_plain(p: torch.Tensor, g: torch.Tensor | None, m: torch.Tensor,
               v: torch.Tensor, lr: float, count: int) -> None:
    """One Adam update of leaf ``p`` and its moments in place, from its
    gradient ``g`` (None: zero) at step ``count``: csrc/adam.cu's plain
    version, any device."""
    if g is None:
        g = torch.zeros_like(p)
    m.mul_(BETA1).add_((1 - BETA1) * g)
    v.mul_(BETA2).add_((1 - BETA2) * (g * g))
    m_hat = m / (1 - BETA1 ** count)
    v_hat = v / (1 - BETA2 ** count)
    p.sub_(lr * m_hat / (torch.sqrt(v_hat) + EPS))


# csrc/adam.cu's table limit and elements a block
MAX_LEAVES = 64
BLOCK_ELEMS = 4096
# its constants: b1, 1 - b1, b2, 1 - b2 and eps as the chain's float32
# tensor operations round the Python numbers
_CONSTS = np.array([BETA1, 1 - BETA1, BETA2, 1 - BETA2, EPS], np.float32)


class AdamTable(NamedTuple):
    """One launch's table of csrc/adam.cu (its C entry's arguments)."""
    ptrs: np.ndarray     # (k, 4) int64: p, g (0: none), m, v
    sizes: np.ndarray    # (k,) int64: elements
    starts: np.ndarray   # (k + 1,) int32: each leaf's first block
    scalars: np.ndarray  # (k, 3) float32: lr, 1 / (1 - b1^c), 1 / (1 - b2^c)


def adam_tables(rows) -> list[AdamTable]:
    """The launch tables of csrc/adam.cu for leaves given as rows (p, g, m,
    v addresses, elements, lr, step count): the leaves with an element, in
    order, MAX_LEAVES a table; each leaf ceil(elements / BLOCK_ELEMS)
    blocks.  Each per-leaf scalar is rounded to float32 as the plain chain
    rounds it on the card: lr as a tensor operation's Python number, and a
    division by the Python number 1 - b^c as torch's CUDA kernels divide, a
    product with its reciprocal taken in double and rounded to float32 (an
    H100 with torch 2.11 matched that form on 2^20 elements at every count
    tried, where the float32 reciprocal of the float32 cast and a float32
    division both differed)."""
    rows = [r for r in rows if r[4] > 0]
    tables = []
    for i in range(0, len(rows), MAX_LEAVES):
        chunk = rows[i:i + MAX_LEAVES]
        sizes = np.array([r[4] for r in chunk], np.int64)
        blocks = np.cumsum(-(-sizes // BLOCK_ELEMS))
        if blocks[-1] >= 2 ** 31:
            raise ValueError(f"adam_step: {blocks[-1]} blocks, the kernel's "
                             "grid takes fewer than 2^31")
        scalars = np.array([(lr, 1 / (1 - BETA1 ** c), 1 / (1 - BETA2 ** c))
                            for *_, lr, c in chunk], np.float32)
        tables.append(AdamTable(
            ptrs=np.array([r[:4] for r in chunk], np.int64),
            sizes=sizes,
            starts=np.concatenate([[0], blocks]).astype(np.int32),
            scalars=scalars))
    return tables


@spanned("kernel.adam")
def adam_step(leaves: Mapping[str, tuple]) -> None:
    """One Adam update of CUDA leaves in place: {name: (p, g, m, v, lr,
    step count)}, g None where a leaf has no gradient (g = 0, no fill).
    One launch of csrc/adam.cu for each table of ``adam_tables`` (none where
    no leaf holds an element), the outputs ``adam_plain``'s bit for bit.
    Refuses with a ValueError, before any launch, a leaf that is not a
    contiguous float32 tensor on the first leaf's device, or a gradient or
    moment that is not one of the leaf's shape.  A leaf, gradient or moment
    that is not 16-byte aligned takes the kernel's scalar path."""
    like = next(iter(leaves.values()))[0]
    rows = []
    for k, (p, g, m, v, lr, c) in leaves.items():
        _build.require("adam_step", k, p, like=like)
        for arg, t in (("gradient", g), ("first moment", m),
                       ("second moment", v)):
            if t is not None:
                _build.require("adam_step", f"the {arg} of {k}", t,
                               like=like, shape=p.shape)
        rows.append((p.data_ptr(), 0 if g is None else g.data_ptr(),
                     m.data_ptr(), v.data_ptr(), p.numel(), lr, c))
    for t in adam_tables(rows):
        _build.launch("adam", "adam_step", "PPPPPi", t.ptrs, t.sizes,
                      t.starts, t.scalars, _CONSTS, len(t.sizes), like=like,
                      counter=adam_step)


adam_step.launches = 0


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
        leaf has none), in place: ``adam_plain`` for a CPU leaf, one
        ``adam_step`` for all CUDA leaves (which refuses, before anything
        moves, a leaf the kernel cannot take)."""
        counts = {k: self.count[k] + 1 for k in params}
        on_card = {k: (p, p.grad, self.mu[k], self.nu[k], lrs[k], counts[k])
                   for k, p in params.items() if p.is_cuda}
        if on_card:
            adam_step(on_card)
        for k, p in params.items():
            if k not in on_card:
                adam_plain(p, p.grad, self.mu[k], self.nu[k], lrs[k],
                           counts[k])
        self.count.update(counts)

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
