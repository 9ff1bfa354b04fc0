"""The CLIP ViT-L/14 text tower, as an ``nn.Module``.

Counterpart of ``zigma_tpu/data/clip_jax.py``: the transformer that turns
77 token ids into the (B, 77, 768) ``last_hidden_state`` the text-to-image
shards store as caption features (the reference's FrozenCLIPEmbedder,
datasets/clip.py:13-48).  Parameter names are those of Hugging Face's
``CLIPTextModel`` without the ``text_model.`` prefix (``load_hf_state_dict``
takes them with or without it); ``transformers`` is not imported.

- token embedding (vocab 49408) + learned positional embedding (77);
- 12 pre-norm blocks (LayerNorm eps 1e-5): causal self-attention, 12
  heads, and an MLP with quick-gelu (``x * sigmoid(1.702 x)``);
- the final LayerNorm.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["CLIPTextTower", "CONFIG", "load_hf_state_dict"]

# openai/clip-vit-large-patch14's text tower (clip_jax.CONFIG)
CONFIG = {"vocab": 49408, "dim": 768, "depth": 12, "heads": 12,
          "mlp": 3072, "ctx": 77}
LN_EPS = 1e-5


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, D = x.shape
        q, k, v = (p(x).reshape(B, N, self.heads, D // self.heads)
                   .transpose(1, 2) for p in (self.q_proj, self.k_proj,
                                              self.v_proj))
        o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.out_proj(o.transpose(1, 2).reshape(B, N, D))


class CLIPMLP(nn.Module):
    def __init__(self, dim: int, mlp: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, mlp)
        self.fc2 = nn.Linear(mlp, dim)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int, mlp: int):
        super().__init__()
        self.self_attn = CLIPAttention(dim, heads)
        self.layer_norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = CLIPMLP(dim, mlp)
        self.layer_norm2 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, vocab: int, dim: int, ctx: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab, dim)
        self.position_embedding = nn.Embedding(ctx, dim)

    def forward(self, input_ids):
        L = input_ids.shape[1]
        return (self.token_embedding(input_ids)
                + self.position_embedding.weight[:L])


class CLIPEncoder(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, mlp: int):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(dim, heads, mlp) for _ in range(depth)])

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class CLIPTextTower(nn.Module):
    """``cfg`` overrides ``CONFIG`` (vocab, dim, depth, heads, mlp, ctx)."""

    def __init__(self, cfg: Optional[Dict] = None, device=None):
        super().__init__()
        c = dict(CONFIG, **(cfg or {}))
        self.cfg = c
        self.embeddings = CLIPEmbeddings(c["vocab"], c["dim"], c["ctx"])
        self.encoder = CLIPEncoder(c["dim"], c["depth"], c["heads"], c["mlp"])
        self.final_layer_norm = nn.LayerNorm(c["dim"], eps=LN_EPS)
        if device is not None:
            self.to(device)

    @classmethod
    def from_state_dict(cls, state_dict: dict, heads: int = CONFIG["heads"],
                        device=None) -> "CLIPTextTower":
        """A tower of the state dict's sizes (the head count is not in the
        weights) with its weights, ``strict=True``."""
        sd = load_hf_state_dict(state_dict)
        vocab, dim = sd["embeddings.token_embedding.weight"].shape
        depth = len({k.split(".")[2] for k in sd
                     if k.startswith("encoder.layers.")})
        cfg = {"vocab": vocab, "dim": dim, "depth": depth, "heads": heads,
               "mlp": sd["encoder.layers.0.mlp.fc1.weight"].shape[0],
               "ctx": sd["embeddings.position_embedding.weight"].shape[0]}
        model = cls(cfg)
        model.load_state_dict(sd, strict=True)
        return model.to(device) if device is not None else model

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """``last_hidden_state`` (B, L, dim) for token ids (B, L), L <= ctx."""
        x = self.encoder(self.embeddings(input_ids))
        return self.final_layer_norm(x)


def load_hf_state_dict(state_dict: dict) -> dict:
    """The tower's part of a Hugging Face ``CLIPTextModel`` or ``CLIPModel``
    state dict: keys under ``text_model.`` with the prefix dropped (or every
    key, if none has it), without the ``position_ids`` buffer."""
    pre = "text_model."
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    if any(k.startswith(pre) for k in sd):
        sd = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    sd.pop("embeddings.position_ids", None)
    return sd
