"""Frozen CLIP text encoder for offline caption-feature preparation.

Counterpart of ``zigma_tpu/data/text.py``: the reference's
FrozenCLIPEmbedder (datasets/clip.py:13-48), 77 tokens -> (B, 77, 768),
here the port's ``CLIPTextTower`` on the card.  The tokenizer is
``transformers.CLIPTokenizer`` from the local cache, imported when an
embedder is made; the tower's weights come from the same cache
(``model.safetensors`` or ``pytorch_model.bin`` of the model's snapshot).
Without them it raises (``ImportError`` without transformers,
``RuntimeError`` without a cached tokenizer or weights); nothing is
downloaded and nothing else stands in.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from zigma_tpu_torch.data.clip_text import CONFIG, CLIPTextTower
from zigma_tpu_torch.data.weights import find_state_dict
from zigma_tpu_torch.device import resolve_device

__all__ = ["FrozenCLIPEmbedder"]

CLIP_FILES = ("model.safetensors", "pytorch_model.bin")


def _heads(weights_path: str) -> int:
    """num_attention_heads from the snapshot's config.json (the text config
    of a CLIPModel), else ViT-L/14's."""
    path = os.path.join(os.path.dirname(weights_path), "config.json")
    try:
        with open(path) as f:
            cfg = json.load(f)
    except (OSError, ValueError):
        return CONFIG["heads"]
    return int(cfg.get("text_config", cfg).get("num_attention_heads",
                                                CONFIG["heads"]))


class FrozenCLIPEmbedder:
    def __init__(self, version: str = "openai/clip-vit-large-patch14",
                 max_length: int = 77, device=None):
        from transformers import CLIPTokenizer

        try:
            self.tokenizer = CLIPTokenizer.from_pretrained(
                version, local_files_only=True)
        except Exception as e:
            raise RuntimeError(
                f"CLIP tokenizer for {version!r} not in the local HF cache "
                f"(nothing is downloaded): {e}") from e
        sd, path = find_state_dict(version, CLIP_FILES)
        self.device = resolve_device(device)
        self.tower = CLIPTextTower.from_state_dict(
            sd, heads=_heads(path), device=self.device).eval()
        self.tower.requires_grad_(False)
        self.max_length = max_length

    @torch.inference_mode()
    def __call__(self, texts: list) -> np.ndarray:
        batch = self.tokenizer(
            texts, truncation=True, max_length=self.max_length,
            padding="max_length", return_tensors="np")
        ids = torch.as_tensor(batch["input_ids"], device=self.device)
        return self.tower(ids).float().cpu().numpy()
