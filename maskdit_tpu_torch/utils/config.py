"""YAML configs as dot-accessible mappings.

The port's own copy of what it uses of maskdit_tpu/utils/config.py: the
``ConfigNode`` mapping and ``load``, which read the repository's YAML
configs (the reference's OmegaConf schema). PyYAML is imported inside
``load`` only: a machine without it still imports the port, and its CLIs
take the same schema as JSON there (``load_file``).
"""

from __future__ import annotations

import copy
import json
from typing import Any, Iterator, Mapping

_MISSING = object()


class ConfigNode(Mapping):
    """A dot-accessible, mutable mapping over nested dicts."""

    def __init__(self, data: dict | None = None):
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self[k] = v

    # -- mapping protocol -------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, Mapping) and not isinstance(value, ConfigNode):
            value = ConfigNode(dict(value))
        self._data[key] = value

    def __delitem__(self, key: str) -> None:
        del self._data[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: object) -> bool:
        return key in self._data

    # -- attribute access --------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self._data[key]
        except KeyError:
            raise AttributeError(
                f"config has no key '{key}' (available: {sorted(self._data)})"
            ) from None

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    # -- helpers -----------------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def select(self, path: str, default: Any = _MISSING) -> Any:
        """Fetch a dotted path, e.g. cfg.select('model.mask_ratio')."""
        node: Any = self
        for part in path.split("."):
            if isinstance(node, ConfigNode) and part in node:
                node = node[part]
            elif default is not _MISSING:
                return default
            else:
                raise KeyError(f"config path '{path}' not found at '{part}'")
        return node

    def set_path(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], ConfigNode):
                node[part] = ConfigNode()
            node = node[part]
        node[parts[-1]] = value

    def to_container(self) -> dict:
        out = {}
        for k, v in self._data.items():
            out[k] = v.to_container() if isinstance(v, ConfigNode) else copy.deepcopy(v)
        return out

    def __repr__(self) -> str:
        return f"ConfigNode({self.to_container()!r})"

    def __deepcopy__(self, memo):
        return ConfigNode(copy.deepcopy(self.to_container(), memo))


def load(path: str) -> ConfigNode:
    """Load a YAML file into a ConfigNode (OmegaConf.load equivalent)."""
    import yaml

    with open(path, "r") as f:
        data = yaml.safe_load(f) or {}
    return ConfigNode(data)


def load_file(path: str) -> ConfigNode:
    """A ``.json`` file, or else a YAML file, of the same schema."""
    if path.endswith(".json"):
        with open(path) as f:
            return ConfigNode(json.load(f))
    return load(path)
