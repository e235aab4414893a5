"""Config system: YAML -> attribute dicts whose missing keys are falsy.

Port of texgs/config.py (kept as a copy: the port imports nothing of
texgs).  ``cfg.missing`` and ``cfg['missing']`` both return an empty,
falsy ``Cfg`` without inserting anything, so feature flags are tested
with plain truthiness, as the reference's addict configs are.
"""

from __future__ import annotations

import os
from typing import Any, Mapping


class Cfg(dict):
    """Attribute-accessible dict where missing keys yield an empty, falsy Cfg."""

    def __init__(self, mapping: Mapping[str, Any] | None = None, **kwargs: Any):
        super().__init__()
        if mapping is not None:
            for k, v in mapping.items():
                self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Cfg):
            return value
        if isinstance(value, Mapping):
            return Cfg(value)
        if isinstance(value, (list, tuple)):
            return type(value)(Cfg._wrap(v) for v in value)
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, Cfg._wrap(value))

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __getattr__(self, key: str) -> Any:
        if key.startswith("__"):  # keep pickling & copy protocols sane
            raise AttributeError(key)
        return self[key]

    def __missing__(self, key: str) -> "Cfg":
        return Cfg()

    def to_dict(self) -> dict:
        def unwrap(v: Any) -> Any:
            if isinstance(v, Cfg):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [unwrap(x) for x in v]
            return v

        return unwrap(self)

    def get_or(self, key: str, default: Any) -> Any:
        """Value if the key is present (even if falsy), else default."""
        return self[key] if key in self else default


def load_config(path: str | os.PathLike) -> Cfg:
    import yaml  # only config loading needs PyYAML

    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    return Cfg(raw or {})
