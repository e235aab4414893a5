"""Checkpoints in texgs's named schema (port of texgs/io/checkpoint.py).

``<path>`` is an .npz with keys ``<dotted.path>`` for every array leaf,
plus a ``<path>.npz.meta.json`` sidecar holding the non-array leaves
(iteration, hyperparams, list lengths).  A checkpoint written by either
package loads in the other.  numpy and json only.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np


def _flatten(prefix: str, obj: Any, arrays: dict, meta: dict):
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(f"{prefix}.{k}" if prefix else str(k), v, arrays, meta)
    elif isinstance(obj, (list, tuple)):
        meta[prefix + ".__len__"] = len(obj)
        meta[prefix + ".__tuple__"] = isinstance(obj, tuple)
        for i, v in enumerate(obj):
            _flatten(f"{prefix}.{i}", v, arrays, meta)
    elif isinstance(obj, np.ndarray):
        arrays[prefix] = obj
    elif hasattr(obj, "detach"):        # torch.Tensor
        arrays[prefix] = obj.detach().cpu().numpy()
    elif obj is None:
        meta[prefix + ".__none__"] = True
    else:
        meta[prefix] = obj


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _meta_path(path: str) -> str:
    return _npz_path(path) + ".meta.json"


def save(path: str, tree: dict, iteration: int | None = None):
    arrays: dict = {}
    meta: dict = {"__iteration__": iteration}
    _flatten("", tree, arrays, meta)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(_npz_path(path), **arrays)
    with open(_meta_path(path), "w") as f:
        json.dump(meta, f)


def load(path: str):
    """Returns (tree, iteration)."""
    npz_path = _npz_path(path)
    if not os.path.exists(npz_path) and os.path.exists(path):
        npz_path = path
    with np.load(npz_path) as data:
        arrays = {k: data[k] for k in data.files}
    with open(_meta_path(path)) as f:
        meta = json.load(f)

    tree: dict = {}

    def insert(key: str, value):
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    for k, v in arrays.items():
        insert(k, v)
    iteration = meta.pop("__iteration__", None)
    lists: dict[str, dict] = {}
    for k, v in meta.items():
        if k.endswith(".__len__"):
            lists.setdefault(k[: -len(".__len__")], {})["len"] = v
        elif k.endswith(".__tuple__"):
            lists.setdefault(k[: -len(".__tuple__")], {})["tuple"] = v
        elif k.endswith(".__none__"):
            insert(k[: -len(".__none__")], None)
        else:
            insert(k, v)

    # numbered dicts back into lists/tuples, deepest first so nested
    # sequences materialise before their parents
    for key in sorted(lists, key=lambda s: -s.count(".")):
        info = lists[key]
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node[p]
        d = node.get(parts[-1], {}) if parts[-1] else tree
        seq = [d[str(i)] for i in range(info["len"])]
        if info.get("tuple"):
            seq = tuple(seq)
        if parts[-1]:
            node[parts[-1]] = seq
        else:
            tree = seq  # top-level sequence
    return tree, iteration
