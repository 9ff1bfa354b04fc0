"""Load a pretrained Mamba LM checkpoint (``state-spaces/mamba-*``).

Counterpart of ``zigma_tpu/convert/torch_mamba_lm.py::load_hf_mamba_lm``
(the reference's ``utils/hf.py`` and ``MambaLMHeadModel.from_pretrained``).
The port's ``models.lm.MambaLMHeadModel`` carries the reference's names, so
the state dict loads as it is (``strict=True``); only the config needs
mapping onto the constructor.

A directory is read directly (``config.json`` and ``pytorch_model.bin``).
A hub name is looked up in the local Hugging Face cache through
``transformers``, imported only then; nothing is ever downloaded, and
without ``transformers`` a hub name raises.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from zigma_tpu_torch.device import resolve_device
from zigma_tpu_torch.models.lm import MambaLMHeadModel

__all__ = ["load_mamba_lm", "lm_kwargs"]

_CTOR_KEYS = ("d_model", "n_layer", "vocab_size", "ssm_cfg", "rms_norm",
              "residual_in_fp32", "pad_vocab_size_multiple")
# the reference's choice of fused kernels; the math is the same
_IGNORED_KEYS = ("fused_add_norm",)


def lm_kwargs(config: dict) -> dict:
    """``MambaLMHeadModel`` keyword arguments from a ``state-spaces``
    ``config.json``.  Hybrid configs (MLP or attention layers) and untied
    heads raise: neither package has them."""
    cfg = dict(config)
    if cfg.pop("d_intermediate", 0):
        raise NotImplementedError("d_intermediate > 0 (MLP layers in the "
                                  "stack) is not part of the LM port")
    if cfg.pop("attn_layer_idx", None) or cfg.pop("attn_cfg", None):
        raise NotImplementedError("attention layers in the stack are not "
                                  "part of the LM port")
    if not cfg.pop("tie_embeddings", True):
        raise NotImplementedError("an untied LM head is not part of the LM "
                                  "port")
    for k in _IGNORED_KEYS:
        cfg.pop(k, None)
    unknown = set(cfg) - set(_CTOR_KEYS)
    if unknown:
        raise ValueError(f"unknown Mamba LM config keys {sorted(unknown)}")
    kw = {k: cfg[k] for k in _CTOR_KEYS if k in cfg}
    ssm_cfg = dict(kw.get("ssm_cfg") or {})
    layer = ssm_cfg.pop("layer", "Mamba1")  # mamba_ssm 2's mixer switch
    if layer not in ("Mamba1", "Mamba2"):
        raise ValueError(f"unknown ssm_cfg layer {layer!r}")
    if layer == "Mamba2":
        ssm_cfg["ssm_version"] = 2
    kw["ssm_cfg"] = ssm_cfg
    return kw


def _read(path: str):
    if os.path.isdir(path):
        cfg_file = os.path.join(path, "config.json")
        bin_file = os.path.join(path, "pytorch_model.bin")
    else:
        try:
            from transformers.utils import cached_file
        except ImportError as e:
            raise RuntimeError(
                f"{path!r} is not a directory, and looking it up as a hub "
                f"name in the local cache needs transformers, which is not "
                f"installed; pass a directory holding config.json and "
                f"pytorch_model.bin") from e
        cfg_file = cached_file(path, "config.json", local_files_only=True)
        bin_file = cached_file(path, "pytorch_model.bin",
                               local_files_only=True)
    with open(cfg_file) as f:
        config = json.load(f)
    sd = torch.load(bin_file, map_location="cpu", weights_only=True)
    return config, sd


def load_mamba_lm(path: str, device=None,
                  dtype: torch.dtype = torch.float32) -> MambaLMHeadModel:
    """The LM of a local ``state-spaces/mamba-*`` directory (or a hub name
    in the local cache) on ``device`` (None: CUDA), computing in ``dtype``
    with float32 parameters."""
    dev = resolve_device(device)
    config, sd = _read(path)
    model = MambaLMHeadModel(**lm_kwargs(config), dtype=dtype, device=dev)
    model.load_state_dict(sd, strict=True)
    return model.eval()
