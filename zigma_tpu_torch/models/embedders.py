"""Patch / timestep / label embedders and the sin-cos position table.

Counterpart of ``zigma_tpu/models/embedders.py``.  Parameters are float32
and keep the reference torch names (``x_embedder.proj``,
``t_embedder.mlp.0/2``, ``y_embedder.embedding_table``); each module computes
in the model's ``dtype``.  A text model's caption features go through a
plain Linear ``y_embedder`` (``models/zigma.py``); ``CaptionEmbedder``, the
caption MLP with a learned null caption, is the reference's capability that
no shipped config uses.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from zigma_tpu_torch.models.inits import normal_, torch_linear_init_, uniform_

__all__ = ["PatchEmbed", "TimestepEmbedder", "LabelEmbedder",
           "CaptionEmbedder", "get_2d_sincos_pos_embed", "dense"]


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype`` whatever the parameters' storage
    dtype (flax's ``nn.Dense(dtype=...)``: fp32 params, compute dtype)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class PatchEmbed(nn.Module):
    """Conv patchify: (B, C, H, W) -> (B, L, D), L = (H/p)*(W/p) row-major;
    video (B, T, C, H, W) -> (B, T*L, D), frame by frame."""

    def __init__(self, patch_size: int, in_channels: int, embed_dim: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        p = patch_size
        self.proj = nn.Conv2d(in_channels, embed_dim, p, stride=p, device=device)

    def reset_parameters(self, generator=None):
        # xavier-uniform over the (out, in*p*p) view, zero bias
        w = self.proj.weight
        fan_in, fan_out = int(np.prod(w.shape[1:])), w.shape[0]
        uniform_(w, math.sqrt(6.0 / (fan_in + fan_out)), generator)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x):
        video = x.dim() == 5
        if video:
            B, T = x.shape[:2]
            x = x.reshape(B * T, *x.shape[2:])
        p = self.proj
        h = F.conv2d(x.to(self.dtype), p.weight.to(self.dtype),
                     p.bias.to(self.dtype), stride=p.stride)
        h = h.flatten(2).transpose(1, 2)
        return h.reshape(B, -1, h.shape[-1]) if video else h


class TimestepEmbedder(nn.Module):
    """Sinusoidal embedding (float32) + 2-layer MLP in ``dtype``.  The
    caller scales t in [0, 1] by 1000, as the reference does."""

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.frequency_embedding_size = frequency_embedding_size
        self.mlp = nn.Sequential(
            nn.Linear(frequency_embedding_size, hidden_size, device=device),
            nn.SiLU(),
            nn.Linear(hidden_size, hidden_size, device=device))

    def reset_parameters(self, generator=None):
        for lin in (self.mlp[0], self.mlp[2]):
            normal_(lin.weight, 0.02, generator)
            nn.init.zeros_(lin.bias)

    @staticmethod
    def timestep_embedding(t, dim: int, max_period: int = 10000):
        half = dim // 2
        freqs = torch.exp(-math.log(max_period)
                          * torch.arange(half, dtype=torch.float32,
                                         device=t.device) / half)
        args = t[:, None].float() * freqs[None]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        if dim % 2:
            emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
        return emb

    def forward(self, t):
        emb = self.timestep_embedding(t, self.frequency_embedding_size)
        emb = F.silu(dense(self.mlp[0], emb, self.dtype))
        return dense(self.mlp[2], emb, self.dtype)


class LabelEmbedder(nn.Module):
    """Class-label table with the classifier-free-guidance label drop.

    The table has one extra null row (index ``num_classes``) only when
    ``dropout_prob > 0``.  Under training each label is replaced by the null
    one with probability ``dropout_prob``, drawn from ``generator``;
    ``force_drop_ids`` (1 = drop) replaces the draw.  The lookup stays
    float32, as in the JAX package."""

    def __init__(self, num_classes: int, hidden_size: int,
                 dropout_prob: float = 0.0, device=None):
        super().__init__()
        self.num_classes, self.dropout_prob = num_classes, dropout_prob
        self.embedding_table = nn.Embedding(
            num_classes + int(dropout_prob > 0), hidden_size, device=device)

    def reset_parameters(self, generator=None):
        normal_(self.embedding_table.weight, 0.02, generator)

    def forward(self, labels: torch.Tensor, train: bool = False,
                force_drop_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        use_cfg = self.dropout_prob > 0
        if (train and use_cfg) or force_drop_ids is not None:
            if not use_cfg:
                # without the null row, index num_classes does not exist
                raise ValueError(
                    "force_drop_ids requires dropout_prob > 0: the embedding "
                    "table has no null-class row at dropout_prob == 0")
            if force_drop_ids is None:
                drop = torch.rand(labels.shape, generator=generator,
                                  device=labels.device) < self.dropout_prob
            else:
                drop = force_drop_ids == 1
            labels = torch.where(drop, self.num_classes, labels)
        return self.embedding_table(labels)


class CaptionEmbedder(nn.Module):
    """Caption-feature MLP with a learned null caption for the CFG drop:
    ``zigma_tpu/models/embedders.py::CaptionEmbedder``.  ``y_proj.fc1`` /
    ``y_proj.fc2`` (the reference's names) with a tanh-approximate GELU
    between, in ``dtype``; ``y_embedding`` (token_num, in_channels), N(0,
    1 / in_channels), replaces a caption dropped under training (each with
    probability ``uncond_prob``, drawn from ``generator``) or where
    ``force_drop_ids`` is 1."""

    def __init__(self, in_channels: int, hidden_size: int,
                 uncond_prob: float = 0.0, token_num: int = 120,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.uncond_prob, self.dtype = uncond_prob, dtype
        self.y_embedding = nn.Parameter(
            torch.empty(token_num, in_channels, device=device))
        self.y_proj = nn.Module()
        self.y_proj.fc1 = nn.Linear(in_channels, hidden_size, device=device)
        self.y_proj.fc2 = nn.Linear(hidden_size, hidden_size, device=device)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        normal_(self.y_embedding, self.y_embedding.shape[-1] ** -0.5,
                generator)
        for lin in (self.y_proj.fc1, self.y_proj.fc2):
            torch_linear_init_(lin.weight, generator)
            nn.init.zeros_(lin.bias)

    def forward(self, caption, train: bool = False,
                force_drop_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """caption (B, token_num, in_channels) -> (B, token_num,
        hidden_size)."""
        if (train and self.uncond_prob > 0) or force_drop_ids is not None:
            if force_drop_ids is None:
                drop = torch.rand((caption.shape[0],), generator=generator,
                                  device=caption.device) < self.uncond_prob
            else:
                drop = force_drop_ids == 1
            caption = torch.where(drop[:, None, None],
                                  self.y_embedding.to(caption.dtype), caption)
        h = F.gelu(dense(self.y_proj.fc1, caption, self.dtype),
                   approximate="tanh")
        return dense(self.y_proj.fc2, h, self.dtype)


def _get_1d_sincos(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int,
                            device: Optional[torch.device] = None) -> torch.Tensor:
    """(grid_size^2, embed_dim) float64 fixed table (the MAE/reference one)."""
    assert embed_dim % 2 == 0
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)  # w first, like the reference
    grid = np.stack(grid, axis=0).reshape(2, 1, grid_size, grid_size)
    emb_h = _get_1d_sincos(embed_dim // 2, grid[0])
    emb_w = _get_1d_sincos(embed_dim // 2, grid[1])
    return torch.from_numpy(np.concatenate([emb_h, emb_w], axis=1)).to(device)
