"""ZigMa denoiser: DiT-style adaLN blocks with Mamba zigzag-scan mixers.

Counterpart of ``zigma_tpu/models/zigma.py``.  Per block:

    x, residual = add_norm(x, residual, prenorm=True)
    shift, scale, gate[, shift_msa, scale_msa, gate_msa] = adaLN(silu(c))
    x = x + gate * Mixer(modulate(x, shift, scale))
    x = x + gate_msa * CrossAttn(modulate(LN(x), shift_msa, scale_msa), text)
                                                         # with has_text

then a final add-norm, the FinalLayer linear and unpatchify.  The stack is a
list of per-layer ``blocks.{i}`` (no counterpart of JAX's ``nn.scan`` over
layers); parameter names are the reference torch ones, so a reference
``.pt`` state dict loads with ``load_state_dict``.  Parameters are stored in
float32; ``dtype`` is the compute dtype, and each GEMM casts its weight where
it is used, so a model being trained keeps float32 master weights
(``utils.inference`` pre-casts the GEMM weights for serving only).

Training (``train=True``): stochastic depth on the JAX schedule (block i at
``concat([0], linspace(0, rate, depth))[i]`` on its input, ``rate`` on the
last hidden state) and, with ``use_checkpoint``, per-block remat through
``torch.utils.checkpoint``.  The keep masks of every block and of the final
drop-path are drawn from the caller's generator *before* the block stack and
passed in as tensors: a recomputed block then sees the same mask, whereas a
mask drawn inside it would come out different (checkpoint restores the
global RNG state, not an explicit generator).

Video models (``video_frames > 0``) take (B, T, C, H, W) latents: the
frames are patchified one by one into T*L tokens, the position table covers
all of them (``use_pe`` 1 tiles the 2-D table over the frames, 2 learns
``num_patches * T`` rows), ``tpe`` adds a learned per-frame embedding, each
layer's mixer folds the frames as its 's' / 't' pattern says, and the output
is unpatchified back to (B, T, C, H, W).  Class labels are dropped to the
null class under training (CFG training), drawn from the same generator as
the drop-path masks; ``forward_with_cfg`` runs the guided forward.

The mixer is ``Mamba`` (Mamba-1, the selective scan) or, with
``ssm_cfg={"ssm_version": 2, ...}``, ``Mamba2`` (the SSD recurrence).

Text models (``has_text``) take y as (B, n_context_token, d_context)
caption features: the ``y_embedder`` Linear projects them to the embed
width, their mean over tokens joins the timestep embedding in c, and the
projected tokens are the context of every block's cross-attention
(``msa``, 8 heads of 64, the reference names ``msa.{to_q,to_k,to_v,
to_out.0}``).  ``use_pe=3`` adds a learned zero-init (1, n_pe, embed) table
before each block i, ``pos_embed_layers.{i}`` (the reference aliased one
unregistered tensor, so it has no name for them; this one matches the
JAX package's stacked ``pos_embed_layers``).

Selective remat policies are a later slice: asking for one raises.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from zigma_tpu_torch.models.embedders import (LabelEmbedder, PatchEmbed,
                                              TimestepEmbedder, dense,
                                              get_2d_sincos_pos_embed)
from zigma_tpu_torch.models.inits import torch_linear_init_
from zigma_tpu_torch.models.mamba import Mamba
from zigma_tpu_torch.models.mamba2 import Mamba2
from zigma_tpu_torch.ops.norms import add_norm, layer_norm
from zigma_tpu_torch.ops.paths import build_layer_paths, parallel_scan_perms

__all__ = ["ZigMa", "ZigMaBlock", "CrossAttention", "FinalLayer",
           "ZIGMA_PRESETS", "zigma_flops", "modulate", "drop_path",
           "drop_path_rates"]


def modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


def drop_path_rates(rate: float, depth: int) -> np.ndarray:
    """Per-block stochastic-depth rates, the JAX (and reference) schedule:
    block 0 gets 0, block i gets ``linspace(0, rate, depth)[i - 1]``."""
    return np.concatenate([[0.0], np.linspace(0, rate, depth)])[:depth]


def drop_path(x, rate: float, keep_mask):
    """Stochastic depth with a given per-sample keep mask (batch,) bool:
    dropped samples become 0, kept ones are divided by ``1 - rate`` in x's
    dtype (``zigma_tpu/models/zigma.py::drop_path``, which draws the mask
    itself)."""
    mask = keep_mask.reshape((-1,) + (1,) * (x.dim() - 1))
    x = torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))
    keep = torch.tensor(max(1.0 - rate, 1e-6), dtype=x.dtype, device=x.device)
    return x / keep


class CrossAttention(nn.Module):
    """Cross-attention of the tokens to a context (the text tokens):
    ``zigma_tpu/models/zigma.py::CrossAttention``.  ``to_q``/``to_k``/
    ``to_v`` without bias, ``to_out.0`` with one (the reference names);
    ``heads`` x ``dim_head`` inner width whatever the embed.  The attention
    itself is ``F.scaled_dot_product_attention`` at scale 1/sqrt(dim_head),
    as JAX leaves it to XLA's fused attention."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        self.context_dim = context_dim or query_dim
        inner = heads * dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False, device=device)
        self.to_k = nn.Linear(self.context_dim, inner, bias=False, device=device)
        self.to_v = nn.Linear(self.context_dim, inner, bias=False, device=device)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim, device=device))

    def reset_parameters(self, generator=None):
        for lin in (self.to_q, self.to_k, self.to_v, self.to_out[0]):
            torch_linear_init_(lin.weight, generator)
        nn.init.zeros_(self.to_out[0].bias)

    def forward(self, x, context):
        """x (B, L, query_dim), context (B, S, context_dim) -> (B, L,
        query_dim)."""
        if context.shape[-1] != self.context_dim:
            raise ValueError(
                f"CrossAttention got context with feature dim "
                f"{context.shape[-1]}, expected context_dim={self.context_dim}")
        B, L, _ = x.shape
        S = context.shape[1]
        # (B, L, H, Dh) as JAX lays the heads out, then (B, H, L, Dh) for SDPA
        q = dense(self.to_q, x, self.dtype).reshape(B, L, self.heads, -1)
        k = dense(self.to_k, context, self.dtype).reshape(B, S, self.heads, -1)
        v = dense(self.to_v, context, self.dtype).reshape(B, S, self.heads, -1)
        o = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            scale=self.dim_head ** -0.5)
        o = o.transpose(1, 2).reshape(B, L, self.heads * self.dim_head)
        return dense(self.to_out[0], o, self.dtype)


class _Norm(nn.Module):
    """Parameter holder of a block norm (``weight``, and ``bias`` for
    LayerNorm); the math is ``ops.norms.add_norm``."""

    def __init__(self, dim: int, bias: bool, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device)) if bias else None

    def reset_parameters(self, generator=None):
        nn.init.ones_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class ZigMaBlock(nn.Module):
    """adaLN Mamba block with the prenorm-residual contract; the mixer is
    ``Mamba`` or, with ``mixer_cfg["ssm_version"] == 2``, ``Mamba2``;
    ``has_text`` adds the cross-attention (``msa``) and three more adaLN
    parts."""

    def __init__(self, dim: int, mixer_cfg: dict, has_text: bool = False,
                 rms_norm: bool = True, norm_epsilon: float = 1e-5,
                 residual_in_fp32: bool = True, n_layer: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype, self.has_text = dtype, has_text
        self.kind = "rms" if rms_norm else "layer"
        self.eps, self.residual_in_fp32 = norm_epsilon, residual_in_fp32
        self.norm = _Norm(dim, bias=not rms_norm, device=device)
        n_mod = 6 if has_text else 3
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), nn.Linear(dim, n_mod * dim, device=device))
        mixer_cfg = dict(mixer_cfg)
        mixer_cls = {1: Mamba, 2: Mamba2}[int(mixer_cfg.pop("ssm_version", 1))]
        self.mixer = mixer_cls(dim, n_layer=n_layer, dtype=dtype,
                               device=device, **mixer_cfg)
        if has_text:
            self.msa = CrossAttention(dim, dim, dtype=dtype, device=device)

    def reset_parameters(self, generator=None):
        self.norm.reset_parameters()
        nn.init.zeros_(self.adaLN_modulation[1].weight)  # DiT zero-init
        nn.init.zeros_(self.adaLN_modulation[1].bias)
        self.mixer.reset_parameters(generator)
        if self.has_text:
            self.msa.reset_parameters(generator)

    def forward(self, x, residual, c, drop=None, text=None):
        """``drop``: optional ``(rate, keep_mask)`` stochastic depth on x;
        ``text``: the (B, S, dim) context of a text block."""
        if drop is not None:
            x = drop_path(x, *drop)
        x, residual = add_norm(x, self.norm.weight, self.norm.bias, residual,
                               kind=self.kind, eps=self.eps, prenorm=True,
                               residual_in_fp32=self.residual_in_fp32)
        mod = dense(self.adaLN_modulation[1], F.silu(c), self.dtype)
        parts = mod.chunk(6 if self.has_text else 3, dim=-1)
        x = x + parts[2][:, None] * self.mixer(modulate(x, parts[0], parts[1]))
        if self.has_text:
            h = modulate(layer_norm(x, eps=1e-6), parts[3], parts[4])
            x = x + parts[5][:, None] * self.msa(h, text)
        return x, residual


class FinalLayer(nn.Module):
    """LayerNorm without affine (eps 1e-6) + linear to patch pixels."""

    def __init__(self, hidden: int, patch_size: int, out_channels: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.linear = nn.Linear(hidden, patch_size * patch_size * out_channels,
                                device=device)

    def reset_parameters(self, generator=None):
        torch_linear_init_(self.linear.weight, generator)
        nn.init.zeros_(self.linear.bias)

    def forward(self, x):
        return dense(self.linear, layer_norm(x, eps=1e-6), self.dtype)


class ZigMa(nn.Module):
    """The denoiser: ``model(x, t, y=None)`` with x (B, C, H, W) latents or
    (B, T, C, H, W) video latents, t (B,) in [0, 1], y optional class
    labels (B,) or, for a text model, caption features (B,
    n_context_token, d_context)."""

    def __init__(self, in_channels: int, embed_dim: int, depth: int,
                 img_dim: int, patch_size: int = 1, num_classes: int = -1,
                 class_dropout_prob: float = 0.0, norm_epsilon: float = 1e-5,
                 rms_norm: bool = True, residual_in_fp32: bool = True,
                 drop_path_rate: float = 0.1, scan_type: str = "v2",
                 use_pe: int = 0, use_checkpoint: bool = False,
                 remat_policy: Optional[str] = None,
                 ssm_cfg: Optional[dict] = None, path_seed: int = 0,
                 scan_backend: str = "auto", has_text: bool = False,
                 d_context: int = 0, n_context_token: int = 0,
                 video_frames: int = 0, tpe: bool = False,
                 dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None,
                 **unsupported):
        super().__init__()
        ssm_cfg = dict(ssm_cfg or {})
        if unsupported:
            raise NotImplementedError(
                f"{unsupported}: lands in a later slice of the port")
        if use_pe not in (0, 1, 2, 3):
            raise ValueError(f"unknown use_pe {use_pe} (0 none, 1 sin-cos, "
                             f"2 learned, 3 learned per layer)")
        if int(ssm_cfg.get("ssm_version", 1)) not in (1, 2):
            raise ValueError(f"unknown ssm_version {ssm_cfg['ssm_version']}")
        if has_text and d_context <= 0:
            raise ValueError("a text model (has_text) needs d_context > 0, "
                             "the caption features' width")
        self.in_channels, self.embed_dim, self.depth = in_channels, embed_dim, depth
        self.has_text, self.d_context = has_text, d_context
        self.n_context_token = n_context_token
        self.img_dim, self.patch_size = img_dim, patch_size
        self.num_classes, self.use_pe, self.dtype = num_classes, use_pe, dtype
        self.rms_norm, self.norm_epsilon = rms_norm, norm_epsilon
        self.residual_in_fp32 = residual_in_fp32
        self.drop_path_rate, self.use_checkpoint = drop_path_rate, use_checkpoint
        self.class_dropout_prob = class_dropout_prob
        self.video_frames, self.tpe = video_frames, tpe
        if remat_policy is not None:
            if remat_policy not in ("scan_out", "dots", "scan_out+dots"):
                raise ValueError(f"unknown remat_policy {remat_policy!r}; one "
                                 f"of dots, scan_out, scan_out+dots or None")
            raise NotImplementedError(
                f"remat_policy={remat_policy!r} (selective remat) lands in a "
                f"later slice of the port; None remats whole blocks")

        side = img_dim // patch_size
        n_patches = side * side
        n_frames = max(video_frames, 1)
        self.x_embedder = PatchEmbed(patch_size, in_channels, embed_dim,
                                     dtype=dtype, device=device)
        self.t_embedder = TimestepEmbedder(embed_dim, dtype=dtype, device=device)
        if has_text:  # the reference's plain Linear
            self.y_embedder = nn.Linear(d_context, embed_dim, device=device)
        elif num_classes > 0:
            self.y_embedder = LabelEmbedder(num_classes, embed_dim,
                                            class_dropout_prob, device=device)
        if use_pe == 1:
            self.register_buffer(
                "pe_table", get_2d_sincos_pos_embed(embed_dim, side, device)
                .repeat(n_frames, 1), persistent=False)
        elif use_pe == 2:
            self.pos_embed = nn.Parameter(
                torch.zeros(1, n_patches * n_frames, embed_dim, device=device))
        elif use_pe == 3:
            self.pos_embed_layers = nn.ParameterList(
                nn.Parameter(torch.zeros(1, n_patches * n_frames, embed_dim,
                                         device=device))
                for _ in range(depth))
        if video_frames > 0 and tpe:
            self.temporal_pos_embedding = nn.Parameter(
                torch.zeros(1, video_frames, embed_dim, device=device))
        paths, paths_rev, st_order = build_layer_paths(
            scan_type, depth, side, video_frames=video_frames, seed=path_seed)
        parallel_perms = (parallel_scan_perms(scan_type, side)
                          if scan_type.startswith("parallelN") else None)
        self.blocks = nn.ModuleList([
            ZigMaBlock(embed_dim, dict(scan_type=scan_type, perm=paths[i],
                                       perm_rev=paths_rev[i],
                                       video_frames=video_frames,
                                       st=None if st_order is None
                                       else st_order[i],
                                       parallel_perms=parallel_perms,
                                       scan_backend=scan_backend, **ssm_cfg),
                       has_text=has_text, rms_norm=rms_norm, norm_epsilon=norm_epsilon,
                       residual_in_fp32=residual_in_fp32, n_layer=depth,
                       dtype=dtype, device=device)
            for i in range(depth)])
        self.norm_f = _Norm(embed_dim, bias=not rms_norm, device=device)
        self.final_layer = FinalLayer(embed_dim, patch_size, in_channels,
                                      dtype=dtype, device=device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The JAX package's init (zero adaLN, zero pos_embed, ...)."""
        with torch.no_grad():
            for m in (self.x_embedder, self.t_embedder, *self.blocks,
                      self.norm_f, self.final_layer):
                m.reset_parameters(generator)
            if self.has_text:
                torch_linear_init_(self.y_embedder.weight, generator)
                self.y_embedder.bias.zero_()
            elif self.num_classes > 0:
                self.y_embedder.reset_parameters(generator)
            if self.use_pe == 2:
                self.pos_embed.zero_()
            elif self.use_pe == 3:
                for pe in self.pos_embed_layers:
                    pe.zero_()
            if self.video_frames > 0 and self.tpe:
                self.temporal_pos_embedding.zero_()

    def forward(self, x, t, y=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """x (B, C, H, W) or (B, T, C, H, W), t (B,) in [0, 1], y (B,)
        labels, (B, n_context_token, d_context) caption features or None.
        ``train`` turns on stochastic depth and the label drop, whose draws
        come from ``generator`` (the default generator when None)."""
        h = self.x_embedder(x)
        B, L, E = h.shape
        c = self.t_embedder((t * 1000.0).float())
        text = None
        if self.has_text:  # the projected tokens are every block's context
            text = dense(self.y_embedder, y, self.dtype)
            c = c + text.mean(1)
        elif self.num_classes > 0:
            c = c + self.y_embedder(y, train=train, generator=generator)
        if self.use_pe == 1:
            h = h + self.pe_table.to(self.dtype)[None]
        elif self.use_pe == 2:
            h = h + self.pos_embed.to(self.dtype)
        if self.video_frames > 0 and self.tpe:
            tpe = self.temporal_pos_embedding.to(self.dtype)[:, :, None]
            h = (h.reshape(B, self.video_frames, -1, E) + tpe).reshape(B, L, E)
        drops = [None] * (self.depth + 1)
        if train and self.drop_path_rate > 0:
            # every mask before the stack: a remat recompute must see the same
            rates = [*drop_path_rates(self.drop_path_rate, self.depth),
                     self.drop_path_rate]
            u = torch.rand((len(rates), x.shape[0]), generator=generator,
                           device=x.device)
            drops = [(float(r), u[i] < 1.0 - r) for i, r in enumerate(rates)]
        remat = self.use_checkpoint and torch.is_grad_enabled()
        residual = None
        for i, (block, drop) in enumerate(zip(self.blocks, drops)):
            if self.use_pe == 3:
                h = h + self.pos_embed_layers[i].to(self.dtype)
            if remat:
                h, residual = checkpoint(block, h, residual, c, drop, text,
                                         use_reentrant=False)
            else:
                h, residual = block(h, residual, c, drop, text)
        if drops[-1] is not None:
            h = drop_path(h, *drops[-1])
        h = add_norm(h, self.norm_f.weight, self.norm_f.bias, residual,
                     kind="rms" if self.rms_norm else "layer",
                     eps=self.norm_epsilon, prenorm=False,
                     residual_in_fp32=self.residual_in_fp32)
        h = self.final_layer(h)
        if self.video_frames > 0:
            return self._unpatchify_video(h)
        return self._unpatchify(h)

    def forward_with_cfg(self, x, t, y, cfg_scale: float, y_null=None,
                         cfg_channels: Optional[int] = None):
        """Classifier-free guidance: cond and uncond as one doubled batch,
        ``uncond + cfg_scale * (cond - uncond)``; with ``cfg_channels`` only
        the first channels are guided, the rest stay conditional.  y_null
        defaults to the null class for labels (which needs the null row,
        ``class_dropout_prob > 0``) and to zeros for float conditioning."""
        if y_null is None:
            if self.num_classes > 0 and not y.is_floating_point():
                if self.class_dropout_prob <= 0:
                    raise ValueError(
                        "forward_with_cfg needs a null-class embedding row: "
                        "the model was built with class_dropout_prob <= 0, "
                        "so label index num_classes does not exist; pass "
                        "y_null explicitly or train with dropout_prob > 0")
                y_null = torch.full_like(y, self.num_classes)
            else:
                y_null = torch.zeros_like(y)
        out = self(torch.cat([x, x]), torch.cat([t, t]), torch.cat([y, y_null]))
        cond, uncond = out.chunk(2)
        guided = uncond + cfg_scale * (cond - uncond)
        # the channel axis is -3 for images (B, C, H, W) and video
        # (B, T, C, H, W) alike
        if cfg_channels is not None and cfg_channels < out.shape[-3]:
            guided = torch.cat([guided[..., :cfg_channels, :, :],
                                cond[..., cfg_channels:, :, :]], dim=-3)
        return guided

    def _unpatchify_video(self, x):
        """(B, T*L, p*p*C) -> (B, T, C, H, W)."""
        c, p, T = self.in_channels, self.patch_size, self.video_frames
        hw = int((x.shape[1] // T) ** 0.5)
        x = x.reshape(x.shape[0], T, hw, hw, p, p, c)
        x = torch.einsum("nthwpqc->ntchpwq", x)
        return x.reshape(x.shape[0], T, c, hw * p, hw * p)

    def _unpatchify(self, x):
        """(B, L, p*p*C) -> (B, C, H, W)."""
        c, p = self.in_channels, self.patch_size
        hw = int(x.shape[1] ** 0.5)
        x = x.reshape(x.shape[0], hw, hw, p, p, c)
        x = torch.einsum("nhwpqc->nchpwq", x)
        return x.reshape(x.shape[0], c, hw * p, hw * p)


ZIGMA_PRESETS = {
    "zigma_s_1": dict(patch_size=1, embed_dim=368, depth=24),
    "zigma_s_2": dict(patch_size=2, embed_dim=368, depth=24),
    "zigma_s_4": dict(patch_size=4, embed_dim=368, depth=24),
    "zigma_b_1": dict(patch_size=1, embed_dim=768, depth=24),
    "zigma_b_2": dict(patch_size=2, embed_dim=768, depth=24),
    "zigma_b_4": dict(patch_size=4, embed_dim=768, depth=24),
    "zigma_m_2": dict(patch_size=2, embed_dim=768, depth=48),
    "zigma_m_4": dict(patch_size=4, embed_dim=768, depth=48),
    "zigma_l_1": dict(patch_size=1, embed_dim=1024, depth=48),
    "zigma_l_2": dict(patch_size=2, embed_dim=1024, depth=48),
    "zigma_l_4": dict(patch_size=4, embed_dim=1024, depth=48),
    "zigma_h_1": dict(patch_size=1, embed_dim=1536, depth=48),
    "zigma_h_2": dict(patch_size=2, embed_dim=1536, depth=48),
    "zigma_h_4": dict(patch_size=4, embed_dim=1536, depth=48),
}


def zigma_flops(batch: int, seq: int, embed_dim: int, depth: int,
                d_state: int = 16, expand: int = 2,
                bidirectional: bool = False) -> int:
    """Analytic FLOPs of the Mamba stack: GEMMs + the reference's scan rule
    9*B*L*D*N (the JAX package's count)."""
    d_inner = expand * embed_dim
    dt_rank = math.ceil(embed_dim / 16)
    ndir = 2 if bidirectional else 1
    per_layer = 0
    per_layer += 2 * batch * seq * embed_dim * 2 * d_inner            # in_proj
    per_layer += ndir * 2 * batch * seq * d_inner * (dt_rank + 2 * d_state)  # x_proj
    per_layer += ndir * 2 * batch * seq * dt_rank * d_inner           # dt_proj
    per_layer += ndir * 9 * batch * seq * d_inner * d_state           # scan
    per_layer += 2 * batch * seq * d_inner * embed_dim                # out_proj
    return per_layer * depth
