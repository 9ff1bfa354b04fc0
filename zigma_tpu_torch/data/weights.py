"""Find pretrained weights in local caches; nothing is ever downloaded.

The VAE and CLIP loaders of the JAX package look in the same places
(``zigma_tpu/data/vae.py::_find_vae_state_dict``, ``data/text.py``): an
explicit file named by an environment variable, then the Hugging Face hub
cache (``$HF_HOME/hub``, default ``~/.cache/huggingface/hub``).  Files load
with ``torch.load(weights_only=True)``; ``.safetensors`` files only when the
``safetensors`` package imports.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Sequence

import torch

__all__ = ["WeightsNotFound", "find_state_dict"]


class WeightsNotFound(RuntimeError):
    """No local file held the weights asked for."""


def _load(path: str) -> dict:
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file  # ImportError: skip the file

        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return sd


def find_state_dict(model_id: str, patterns: Sequence[str],
                    env: Optional[str] = None):
    """``(state_dict, path)`` of the first readable candidate: the file named
    by ``$env``, then each glob of ``patterns`` under the model's hub-cache
    folder (``models--{org}--{name}/**/``).  Raises ``WeightsNotFound``."""
    paths = []
    if env and os.environ.get(env):
        paths.append(os.environ[env])
    cache = os.environ.get(
        "HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    tag = "models--" + model_id.replace("/", "--")
    for pat in patterns:
        paths += sorted(glob.glob(f"{cache}/hub/{tag}/**/{pat}",
                                  recursive=True))
    tried = []
    for cand in paths:
        try:
            return _load(cand), cand
        except (OSError, RuntimeError, ImportError, ValueError) as e:
            tried.append(f"{cand}: {e}")
    where = f"${env} or " if env else ""
    raise WeightsNotFound(
        f"weights for {model_id!r} not found locally ({where}the hub cache "
        f"under {cache}; nothing is downloaded)"
        + (f"; unreadable: {tried}" if tried else ""))
