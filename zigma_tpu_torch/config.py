"""Hydra-style YAML config composition (own copy; no hydra dependency).

Counterpart of ``zigma_tpu/config.py``, kept the same: a root YAML with a
``defaults`` list of groups, group directories (``model/``, ``data/``,
``train/``, ``optim/``, ``ode/``, ``sde/``), CLI overrides ``group=name`` to
swap a group file and ``a.b.c=value`` to set a leaf (values YAML-parsed).
It reads the same ``configs/`` tree.  Missing group files resolve to ``{}``
with a warning (the reference's defaults list names files that do not exist).
"""

from __future__ import annotations

import copy
import logging
import os
from typing import Any, Optional, Sequence

import yaml

__all__ = ["load_config", "Config", "config_to_dict"]

log = logging.getLogger(__name__)


class Config(dict):
    """dict with attribute access, nested."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return v

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj

    def get_path(self, dotted: str, default=None):
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node


def config_to_dict(cfg) -> dict:
    if isinstance(cfg, dict):
        return {k: config_to_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, list):
        return [config_to_dict(v) for v in cfg]
    return cfg


def _deep_merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _load_yaml(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def _load_group(config_dir: str, group: str, name: str) -> dict:
    path = os.path.join(config_dir, group, f"{name}.yaml")
    if not os.path.exists(path):
        log.warning("config group file missing: %s (using {})", path)
        return {}
    return _load_yaml(path)


def _set_dotted(cfg: dict, dotted: str, value):
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def load_config(config_dir: str, name: str = "default",
                overrides: Optional[Sequence[str]] = None) -> Config:
    """Compose ``{config_dir}/{name}.yaml`` + its defaults list + overrides.

    Overrides: ``group=file`` swaps a group yaml (top-level groups from the
    defaults list), ``a.b=value`` sets a leaf (YAML-parsed value).
    """
    root = _load_yaml(os.path.join(config_dir, f"{name}.yaml"))
    defaults = root.pop("defaults", [])
    overrides = list(overrides or [])

    # group selections: defaults list, then CLI group overrides
    groups: dict = {}
    for entry in defaults:
        if entry == "_self_":
            continue
        if isinstance(entry, dict):
            groups.update({str(k): str(v) for k, v in entry.items()})
        else:  # hydra's plain '- groupname' form: group defaults to its name
            groups[str(entry)] = str(entry)
    value_overrides = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, val = ov.split("=", 1)
        is_group = "." not in key and (
            key in groups or os.path.isdir(os.path.join(config_dir, key)))
        if is_group:
            groups[key] = val
        else:
            value_overrides.append((key, val))

    cfg: dict = {}
    for group, fname in groups.items():
        cfg[group] = _load_group(config_dir, group, fname)
    cfg = _deep_merge(cfg, root)  # _self_ comes last, like the reference

    for key, val in value_overrides:
        parsed = yaml.safe_load(val)
        if isinstance(parsed, str):
            # YAML 1.1 misses dotless scientific floats like "3e-4"; only
            # coerce strings that look like them (plain ints/strings must
            # stay as YAML parsed — int(x, 0) would eat hex/underscore ids)
            import re as _re

            if _re.fullmatch(r"[+-]?\d+(\.\d*)?[eE][+-]?\d+", parsed):
                parsed = float(parsed)
        _set_dotted(cfg, key, parsed)
    return Config.wrap(cfg)
