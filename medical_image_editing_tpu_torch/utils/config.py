"""Configuration helpers: the port's own copy of the JSON config loading of
`medical_image_editing_tpu/utils/config.py` (reference
`src/utils/__init__.py:99-106`) and of `load_dotenv`.

A JSON config becomes recursive attribute-access `ConfigNode`s, with the
reference's object-hook quirk kept: `False` values become `None` (both are
falsy, so gated features behave the same). `getattr_else_none` is the
optional-field accessor of the reference's `src/trainers/base.py`.
"""

import json
import os
from typing import Any, Mapping


class ConfigNode:
    """Recursive attribute-access view over a dict. A missing key raises
    AttributeError; use `getattr_else_none`/`get` for optional fields."""

    def __init__(self, data: Mapping[str, Any]):
        object.__setattr__(self, "_data", dict(data))

    def __getattr__(self, name: str) -> Any:
        data = object.__getattribute__(self, "_data")
        if name not in data:
            raise AttributeError(f"config has no field {name!r}")
        return data[name]

    def __setattr__(self, name, value):
        object.__getattribute__(self, "_data")[name] = value

    def get(self, name: str, default=None) -> Any:
        return object.__getattribute__(self, "_data").get(name, default)

    def __repr__(self):
        return f"ConfigNode({object.__getattribute__(self, '_data')!r})"


def to_config(data: Any) -> Any:
    """Recursively wrap dicts in ConfigNode, `False` → `None`."""
    if isinstance(data, Mapping):
        return ConfigNode({k: to_config(v) for k, v in data.items()})
    if isinstance(data, list):
        return [to_config(v) for v in data]
    return None if data is False else data


def load_json(path: str):
    """Load a reference-format JSON config."""
    with open(path) as f:
        return to_config(json.load(f))


def getattr_else_none(config, name: str, default=None):
    """Optional-field accessor: the field, or `default` when it is missing."""
    try:
        if isinstance(config, ConfigNode):
            return config.get(name, default)
        return getattr(config, name, default)
    except AttributeError:
        return default


def load_dotenv(path: str = ".env") -> dict:
    """Minimal python-dotenv replacement (the reference loads `.env` for
    checkpoint paths — `run_recon.py:20-24`). Parses KEY=VALUE lines into
    os.environ (existing variables win) and returns the parsed dict."""
    parsed = {}
    if not os.path.exists(path):
        return parsed
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            key, value = key.strip(), value.strip().strip("'\"")
            parsed[key] = value
            os.environ.setdefault(key, value)
    return parsed
