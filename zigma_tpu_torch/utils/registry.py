"""Dotted-path instantiation: the reference's ``instantiate_from_config``
(utils/train_utils.py:33-38), where configs name classes as ``target:
pkg.mod.Class`` with ``params: {...}``.  Own copy of
``zigma_tpu/utils/registry.py``."""

from __future__ import annotations

import importlib
from typing import Any

__all__ = ["get_obj_from_str", "instantiate_from_config"]


def get_obj_from_str(path: str, reload: bool = False) -> Any:
    """The object at ``"pkg.mod.Name"`` (the module reloaded first with
    ``reload``)."""
    module, cls = path.rsplit(".", 1)
    mod = importlib.import_module(module)
    if reload:
        importlib.reload(mod)
    return getattr(mod, cls)


def instantiate_from_config(config: dict) -> Any:
    """``{"target": "a.b.Class", "params": {...}}`` -> an instance; a
    config without ``target`` raises KeyError."""
    if "target" not in config:
        raise KeyError("config must have a 'target' key")
    params = dict(config.get("params") or {})
    return get_obj_from_str(config["target"])(**params)
