"""DINOv2 ViT as a torch module, for the Fréchet DINOv2 distance (FDD).

Counterpart of ``zigma_tpu/metrics/dinov2_jax.py``.  The reference scores
FDD with ``torch.hub.load("facebookresearch/dinov2", "dinov2_vitl14")``:
images bicubic-resized to 224, ImageNet-normalised, the class-token
embedding (reference: utils/torchmetric_fdd.py:82-105).  This module has the
hub model's state-dict names (``patch_embed.proj``, ``cls_token``,
``pos_embed``, ``blocks.{i}.{norm1,attn.qkv,attn.proj,ls1.gamma,norm2,
mlp.fc1,mlp.fc2,ls2.gamma}``, ``norm``) and the vits14 / vitb14 / vitl14
presets (``ARCHS``):

- patch embed: 14x14 stride-14 conv, flattened row-major, class token
  prepended;
- the position embedding is trained at 518 px (a 37 x 37 grid + cls); at
  another grid its grid part is bicubic-resized with dinov2's 0.1 offset
  (``scale_factor = (grid + 0.1) / 37``, ``F.interpolate(mode="bicubic")``,
  no antialias);
- 24 pre-norm blocks (LayerNorm eps 1e-6): attention with a qkv bias
  through ``F.scaled_dot_product_attention``, LayerScale, then an MLP (x4,
  exact GELU) with LayerScale;
- the final LayerNorm's class token is the feature.

The image resize to 224 is ``F.interpolate(mode="bicubic",
antialias=False)``, the torch function the JAX package emulates
(``torch_bicubic_resize``, a = -0.75); the tests hold the two together.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["DinoV2", "dinov2_extractor", "from_state_dict", "fdd_preprocess",
           "interp_pos_embed", "ARCHS"]

# arch -> (embed_dim, depth, num_heads)
ARCHS = {
    "vits14": (384, 12, 6),
    "vitb14": (768, 12, 12),
    "vitl14": (1024, 24, 16),
}
PATCH = 14
TRAIN_GRID = 37  # 518 / 14: the pretrained position-embedding grid
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def interp_pos_embed(pos_embed: torch.Tensor, grid_h: int, grid_w: int):
    """(cls part, grid part) of the position embedding for a grid_h x
    grid_w patch grid (dinov2's ``interpolate_pos_encoding`` with its
    ``interpolate_offset`` 0.1: the scale factor, not the size, is given,
    so torch maps coordinates by side / (grid + 0.1))."""
    cls_pe, grid_pe = pos_embed[:, :1], pos_embed[:, 1:]
    side = int(round(float(np.sqrt(grid_pe.shape[1]))))
    if (grid_h, grid_w) != (side, side):
        g = grid_pe.reshape(1, side, side, -1).permute(0, 3, 1, 2)
        g = F.interpolate(g, scale_factor=((grid_h + 0.1) / side,
                                           (grid_w + 0.1) / side),
                          mode="bicubic", align_corners=False,
                          antialias=False)
        grid_pe = g.permute(0, 2, 3, 1).reshape(1, grid_h * grid_w, -1)
    return cls_pe, grid_pe


class PatchEmbed(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, PATCH, PATCH)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, D = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.heads, D // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(B, N, D))


class LayerScale(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class Mlp(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DinoV2(nn.Module):
    """``forward(x)``: ImageNet-normalised (B, 3, H, W) floats, H and W
    multiples of 14 -> (B, embed_dim) class-token features."""

    def __init__(self, arch: str = "vitl14"):
        super().__init__()
        dim, depth, heads = ARCHS[arch]
        self.arch = arch
        self.patch_embed = PatchEmbed(dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + TRAIN_GRID * TRAIN_GRID, dim))
        self.blocks = nn.ModuleList(Block(dim, heads) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x):
        B, _, H, W = x.shape
        x = self.patch_embed(x.float())
        cls_pe, grid_pe = interp_pos_embed(self.pos_embed, H // PATCH,
                                           W // PATCH)
        cls = (self.cls_token + cls_pe).expand(B, -1, -1)
        x = torch.cat([cls, x + grid_pe], 1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)[:, 0]


def fdd_preprocess(imgs: torch.Tensor, resolution: int = 224):
    """(B, C, H, W) [0, 255] -> bicubic resize to ``resolution`` and
    ImageNet normalisation (torchmetric_fdd.py:93-105)."""
    x = imgs.float() / 255.0
    x = F.interpolate(x, size=(resolution, resolution), mode="bicubic",
                      align_corners=False, antialias=False)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def from_state_dict(state_dict: dict, arch: str = "vitl14",
                    device=None) -> DinoV2:
    """A ``DinoV2`` on ``device`` (default CPU) from the torch hub state
    dict; the hub's ``mask_token`` (used only in training) is dropped,
    every other key must match (``strict=True``)."""
    sd = {k: torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v))
          for k, v in state_dict.items() if k != "mask_token"}
    net = DinoV2(arch)
    net.load_state_dict(sd, strict=True)
    return net.to(device or "cpu").eval().requires_grad_(False)


def dinov2_extractor(net: DinoV2, batch: int = 32, resolution: int = 224):
    """(B, C, H, W) uint8 [0, 255] -> (B, embed_dim) numpy FDD features on
    the net's device: bicubic resize to 224 + ImageNet normalisation, then
    the net."""
    from zigma_tpu_torch.metrics.features import NetExtractor

    return NetExtractor("dinov2", net,
                        lambda x: net(fdd_preprocess(x, resolution)),
                        next(net.parameters()).device, batch)
