"""Mamba-2 token mixer: scalar-decay heads over the SSD recurrence.

Counterpart of ``zigma_tpu/models/mamba2.py`` (``Mamba2`` and its
``_SSDBranch``), a drop-in for ``Mamba`` in ``ZigMaBlock`` selected by
``ssm_cfg: {ssm_version: 2}``.  Per layer:

- one ``in_proj`` GEMM gives ``(z, xBC, dt)``: d_inner, d_inner + 2 G N
  and H channels (H = d_inner / headdim heads, G = ngroups);
- the causal depthwise conv with silu over the xBC channels
  (``ops.causal_conv1d``);
- ``ssd_scan`` of (x, dt, A = -exp(A_log), B, C, D) with ``dt_bias`` under
  softplus (``ops.ssd``);
- ``v2`` runs a second direction with its own conv, A, dt bias and D on
  the flipped sequence and adds it back flipped; the projections are
  shared;
- the gated RMSNorm ``RMSNorm(y * silu(z))`` with per-group fp32
  statistics, then ``out_proj``.

The scan-path permutations and the video folds are ``Mamba``'s: tokens are
permuted before ``in_proj`` and back after ``out_proj`` through
``permute_tokens``, whose backward takes ``vjp_inverse``.  ``parallelN``
is a Mamba-1 construct and raises, as in JAX.  The decode ``step`` and
``prefill`` come with the LM stack, in a later slice.

Parameter names (the reference has no Mamba-2, so these follow the public
``mamba_ssm`` Mamba2 module): ``in_proj.weight``, ``conv1d.weight``
(conv_dim, 1, d_conv), ``conv1d.bias``, ``A_log`` (H,), ``dt_bias`` (H,),
``D`` (H,), ``norm.weight`` (d_inner,), ``out_proj.weight``; the second
direction's take ``_b`` after their first word, as the port's Mamba-1 v2
branch does: ``conv1d_b.{weight,bias}``, ``A_b_log``, ``dt_b_bias``,
``D_b``.  ``convert.state_dict_from_jax`` maps the JAX tree onto them.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from zigma_tpu_torch.models.embedders import dense
from zigma_tpu_torch.models.inits import (rescaled_linear_init_,
                                          torch_linear_init_, uniform_)
from zigma_tpu_torch.models.mamba import (_VIDEO_SCANS, fold_frames,
                                          permute_tokens, register_path_tables,
                                          unfold_frames)
from zigma_tpu_torch.ops.causal_conv1d import causal_conv1d
from zigma_tpu_torch.ops.ssd import ssd_scan

__all__ = ["Mamba2"]


class _Weight(nn.Module):
    """Holder of the gated norm's ``weight`` (the ``norm.weight`` name)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))


class Mamba2(nn.Module):
    """Mamba-2 mixer; the ``Mamba`` constructor's scan-type arguments
    (``perm``/``perm_rev`` numpy tables or None, ``video_frames``, ``st``)
    and the public Mamba-2 defaults (d_state 64, headdim 64, one group,
    A_log init log U[1, 16])."""

    def __init__(self, d_model: int, d_state: int = 64, d_conv: int = 4,
                 expand: int = 2, headdim: int = 64, ngroups: int = 1,
                 a_init_range: tuple = (1.0, 16.0), dt_min: float = 0.001,
                 dt_max: float = 0.1, dt_init_floor: float = 1e-4,
                 conv_bias: bool = True, bias: bool = False,
                 rms_norm_eps: float = 1e-5, scan_type: str = "v1",
                 perm: Optional[np.ndarray] = None,
                 perm_rev: Optional[np.ndarray] = None, video_frames: int = 0,
                 st: Optional[str] = None,
                 parallel_perms: Optional[tuple] = None, n_layer: int = 1,
                 dtype: torch.dtype = torch.float32, scan_backend: str = "auto",
                 scan_chunk: int = 128, conv_fp32_taps: bool = False,
                 device=None):
        super().__init__()
        d_inner = int(expand * d_model)
        if d_inner % headdim:
            raise ValueError(f"d_inner {d_inner} not divisible by headdim "
                             f"{headdim}")
        nheads = d_inner // headdim
        if nheads % ngroups:
            raise ValueError(f"nheads {nheads} not divisible by ngroups "
                             f"{ngroups}")
        if scan_type.startswith("parallelN"):
            raise ValueError(
                "parallelN is a Mamba-1 construct (dead code in the "
                "reference); Mamba2 supports v1/v2/zigzagN/hilbertN/"
                "randomN/video_* scan types")
        self.video = scan_type.startswith(_VIDEO_SCANS)
        if self.video and (st not in ("s", "t") or video_frames <= 0):
            raise ValueError(
                f"video scan_type {scan_type!r} requires st='s' or 't' and "
                f"video_frames > 0, got st={st!r}, video_frames={video_frames}")
        self.d_model, self.d_state, self.d_conv = d_model, d_state, d_conv
        self.d_inner, self.nheads, self.headdim = d_inner, nheads, headdim
        self.ngroups, self.conv_dim = ngroups, d_inner + 2 * ngroups * d_state
        self.a_init_range = a_init_range
        self.dt_min, self.dt_max, self.dt_init_floor = dt_min, dt_max, dt_init_floor
        self.rms_norm_eps, self.scan_type, self.n_layer = rms_norm_eps, scan_type, n_layer
        self.video_frames, self.st, self.dtype = video_frames, st, dtype
        self.scan_backend, self.scan_chunk = scan_backend, scan_chunk
        self.conv_accum = torch.float32 if conv_fp32_taps else None
        self.directions = ("", "_b") if scan_type == "v2" else ("",)

        self.in_proj = nn.Linear(d_model, d_inner + self.conv_dim + nheads,
                                 bias=bias, device=device)
        for s in self.directions:
            setattr(self, f"conv1d{s}", nn.Conv1d(
                self.conv_dim, self.conv_dim, d_conv, groups=self.conv_dim,
                bias=conv_bias, device=device))
            setattr(self, f"A{s}_log", nn.Parameter(torch.empty(nheads, device=device)))
            setattr(self, f"dt{s}_bias", nn.Parameter(torch.empty(nheads, device=device)))
            setattr(self, f"D{s}", nn.Parameter(torch.empty(nheads, device=device)))
        self.norm = _Weight(d_inner, device=device)
        self.out_proj = nn.Linear(d_inner, d_model, bias=bias, device=device)
        register_path_tables(self, perm, perm_rev, self.video, device)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The JAX package's inits: torch-default GEMMs with zero biases,
        out_proj rescaled by sqrt(n_layer), U(+-1/sqrt(d_conv)) conv taps,
        A_log = log U[a_init_range], the inverse-softplus dt bias of Mamba-1,
        D = 1 and a unit norm weight."""
        torch_linear_init_(self.in_proj.weight, generator)
        rescaled_linear_init_(self.out_proj.weight, self.n_layer, generator)
        for lin in (self.in_proj, self.out_proj):
            if lin.bias is not None:
                lin.bias.zero_()
        lo, hi = self.a_init_range
        for s in self.directions:
            conv = getattr(self, f"conv1d{s}")
            uniform_(conv.weight, (1.0 / self.d_conv) ** 0.5, generator)
            if conv.bias is not None:
                uniform_(conv.bias, (1.0 / self.d_conv) ** 0.5, generator)
            A_log = getattr(self, f"A{s}_log")
            A_log.copy_(torch.log(torch.empty_like(A_log).uniform_(
                lo, hi, generator=generator)))
            dt = torch.exp(
                torch.rand(self.nheads, generator=generator,
                           device=A_log.device)
                * (math.log(self.dt_max) - math.log(self.dt_min))
                + math.log(self.dt_min)).clamp(min=self.dt_init_floor)
            getattr(self, f"dt{s}_bias").copy_(dt + torch.log(-torch.expm1(-dt)))
            getattr(self, f"D{s}").fill_(1.0)
        self.norm.weight.fill_(1.0)

    def _branch(self, s: str, xbc, dt):
        """conv -> SSD for direction ``s`` ('' or '_b'): xbc (b, L,
        conv_dim), dt (b, L, H) -> (b, L, d_inner)."""
        B_, L, _ = xbc.shape
        G, N = self.ngroups, self.d_state
        conv = getattr(self, f"conv1d{s}")
        xbc = causal_conv1d(xbc, conv.weight[:, 0, :], conv.bias,
                            activation="silu", accum_dtype=self.conv_accum)
        x, Bv, Cv = xbc.split([self.d_inner, G * N, G * N], dim=-1)
        y = ssd_scan(x.reshape(B_, L, self.nheads, self.headdim), dt,
                     -torch.exp(getattr(self, f"A{s}_log").float()),
                     Bv.reshape(B_, L, G, N), Cv.reshape(B_, L, G, N),
                     getattr(self, f"D{s}"), dt_bias=getattr(self, f"dt{s}_bias"),
                     dt_softplus=True, backend=self.scan_backend,
                     chunk=self.scan_chunk)
        return y.reshape(B_, L, self.d_inner)

    def _gated_norm(self, y, z):
        """``RMSNorm(y * silu(z))`` with per-group fp32 statistics, in the
        compute dtype."""
        y = y.float() * F.silu(z.float())
        g = y.reshape(*y.shape[:-1], self.ngroups, self.d_inner // self.ngroups)
        g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + self.rms_norm_eps)
        return (g.reshape(y.shape) * self.norm.weight).to(self.dtype)

    def forward(self, x):
        """x: (batch, L, d_model) -> (batch, L, d_model)."""
        B_ = x.shape[0]
        if self.video:
            x = fold_frames(x, self.video_frames, self.st)
        if self.perm is not None:
            x = permute_tokens(x, self.perm, self.perm_bwd)
        z, xbc, dt = dense(self.in_proj, x, self.dtype).split(
            [self.d_inner, self.conv_dim, self.nheads], dim=-1)
        y = self._branch("", xbc, dt)
        if self.scan_type == "v2":
            y = y + self._branch("_b", xbc.flip(1), dt.flip(1)).flip(1)
        out = dense(self.out_proj, self._gated_norm(y, z), self.dtype)
        if self.perm_rev is not None:
            out = permute_tokens(out, self.perm_rev, self.perm_rev_bwd)
        if self.video:
            out = unfold_frames(out, B_, self.video_frames, self.st)
        return out
