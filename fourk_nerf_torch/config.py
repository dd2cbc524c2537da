"""Python-file config system with ``_base_`` inheritance.

The port's own copy of the JAX package's ``config.py``. It mirrors the
load-bearing behaviour of mmcv.Config as the reference uses it
(frozoul/4K-NeRF run.py:693, configs/default.py ->
configs/llff/llff_default_lg.py -> per-scene configs) without mmcv:

- A config is an executable Python file. Top-level names not starting with
  ``_`` become config entries.
- ``_base_`` is a relative path (or list of paths) to parent config(s); the
  child is deep-merged over the parents (nested dicts merge recursively,
  other values override).
- Entries support both attribute and item access (``cfg.data.ndc`` and
  ``cfg['data']['ndc']``), plus ``.get``/``.keys`` used by the CLIs.
"""

from __future__ import annotations

import copy
import os
import types
from typing import Any


class ConfigDict(dict):
    """Dict with attribute access, recursive over nested dicts."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            super().__setitem__(k, _wrap(v))

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __setitem__(self, name: str, value: Any) -> None:
        super().__setitem__(name, _wrap(value))

    def __deepcopy__(self, memo: dict) -> "ConfigDict":
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        return {k: (v.to_dict() if isinstance(v, ConfigDict) else v) for k, v in self.items()}


def _wrap(value: Any) -> Any:
    if isinstance(value, ConfigDict):
        return value
    if isinstance(value, dict):
        return ConfigDict(value)
    if isinstance(value, (list, tuple)):
        return type(value)(_wrap(v) for v in value)
    return value


def _deep_merge(base: dict, override: dict) -> dict:
    """Merge ``override`` into ``base`` recursively; override wins on leaves."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _exec_config_file(path: str) -> dict:
    path = os.path.abspath(path)
    with open(path, "r") as f:
        src = f.read()
    module = types.ModuleType(f"_cfg_{abs(hash(path))}")
    module.__file__ = path
    code = compile(src, path, "exec")
    exec(code, module.__dict__)
    cfg = {
        k: v
        for k, v in module.__dict__.items()
        if not k.startswith("_") and not isinstance(v, types.ModuleType) and not callable(v)
    }
    base = module.__dict__.get("_base_")
    if base is not None:
        bases = base if isinstance(base, (list, tuple)) else [base]
        merged: dict = {}
        for b in bases:
            parent = _exec_config_file(os.path.join(os.path.dirname(path), b))
            merged = _deep_merge(merged, parent)
        cfg = _deep_merge(merged, cfg)
    return cfg


def load_config(path: str) -> ConfigDict:
    """Load a config file, resolving ``_base_`` inheritance."""
    cfg = ConfigDict(_exec_config_file(path))
    cfg["_config_path"] = os.path.abspath(path)
    return cfg


def dump_config(cfg: ConfigDict, path: str) -> None:
    """Dump the resolved config to a Python file (experiment provenance, as
    frozoul/4K-NeRF run.py:641-646)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for k, v in cfg.items():
            if k.startswith("_"):
                continue
            f.write(f"{k} = {_format_value(v)}\n")


def _format_value(v: Any, indent: int = 0) -> str:
    pad = " " * indent
    if isinstance(v, dict):
        items = ",\n".join(
            f"{pad}    {k!r}: {_format_value(val, indent + 4)}" for k, val in v.items()
        )
        return "{\n" + items + f"\n{pad}}}"
    return repr(v)
