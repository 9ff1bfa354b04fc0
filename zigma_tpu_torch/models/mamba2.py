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

Under tensor parallelism (``parallel.mesh.apply_tensor_parallel``) each
rank holds its share of ``in_proj``'s outputs, gathered whole after the
GEMM, and of ``out_proj``'s inputs; the conv, the SSD and the gated norm
run whole on every rank, as the JAX rules replicate their parameters.

The scan-path permutations and the video folds are ``Mamba``'s: tokens are
permuted before ``in_proj`` and back after ``out_proj`` through
``permute_tokens``, whose backward takes ``vjp_inverse``.  ``parallelN``
is a Mamba-1 construct and raises, as in JAX.

Decode (the LM's): ``step`` takes one token and a ``Mamba2Cache`` (the
last ``d_conv`` xBC inputs and the fp32 (H, P, N) state) over
``ssd_state_update``; ``prefill`` runs a v1 prompt through ``ssd_scan(...,
return_last_state=True)``.  The prefill's conv window takes the dtype
``Mamba2Cache.init`` allocates (the JAX prefill gives it the activations'
dtype, so its caches change dtype between an empty start and a prefill).

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
from zigma_tpu_torch.models.mamba import (_VIDEO_SCANS, conv_window,
                                          fold_frames, permute_tokens,
                                          register_path_tables, unfold_frames)
from zigma_tpu_torch.ops.causal_conv1d import (causal_conv1d,
                                               causal_conv1d_update)
from zigma_tpu_torch.ops.ssd import ssd_scan, ssd_state_update
from zigma_tpu_torch.parallel.collectives import (copy_to_group, gather_last,
                                                  row_parallel_linear,
                                                  split_last)

__all__ = ["Mamba2", "Mamba2Cache", "scan_out"]


@torch.library.custom_op("zigma::scan_out", mutates_args=())
def scan_out(y: torch.Tensor) -> torch.Tensor:
    """The SSD's output under a name a selective-remat policy can keep
    (``checkpoint_name(y, "scan_out")`` in the JAX package): a copy, since
    an operator's output may not alias its input; its gradient passes
    through."""
    return y.clone()


scan_out.register_fake(lambda y: torch.empty_like(y))
scan_out.register_autograd(lambda ctx, g: g)


class Mamba2Cache:
    """Per-layer decode cache: ``(conv_state (batch, d_conv, conv_dim) in
    CONV_DTYPE, ssm_state (batch, nheads, headdim, d_state) fp32)``."""

    CONV_DTYPE = torch.float32

    @staticmethod
    def init(batch: int, conv_dim: int, d_conv: int, nheads: int,
             headdim: int, d_state: int, device=None):
        return (torch.zeros((batch, d_conv, conv_dim),
                            dtype=Mamba2Cache.CONV_DTYPE, device=device),
                torch.zeros((batch, nheads, headdim, d_state),
                            dtype=torch.float32, device=device))


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
        # tensor parallelism (parallel.mesh.apply_tensor_parallel): the
        # group over which in_proj's outputs and out_proj's inputs are split
        self.tp_group = None
        # ZigMa sets it under remat_policy scan_out: each branch's SSD
        # output goes through ``scan_out``, which the policy keeps
        self.name_scan_out = False
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

    def _split(self, xbc_c):
        """The conv's output (..., conv_dim) -> x (..., H, P), B and C (...,
        G, N)."""
        G, N, lead = self.ngroups, self.d_state, xbc_c.shape[:-1]
        x, Bv, Cv = xbc_c.split([self.d_inner, G * N, G * N], dim=-1)
        return (x.reshape(*lead, self.nheads, self.headdim),
                Bv.reshape(*lead, G, N), Cv.reshape(*lead, G, N))

    def _branch(self, s: str, xbc, dt, return_last_state: bool = False):
        """conv -> SSD for direction ``s`` ('' or '_b'): xbc (b, L,
        conv_dim), dt (b, L, H) -> (b, L, d_inner) (and the final
        state)."""
        B_, L, _ = xbc.shape
        conv = getattr(self, f"conv1d{s}")
        x, Bv, Cv = self._split(causal_conv1d(
            xbc, conv.weight[:, 0, :], conv.bias, activation="silu",
            accum_dtype=self.conv_accum))
        out = ssd_scan(x, dt, -torch.exp(getattr(self, f"A{s}_log").float()),
                       Bv, Cv, getattr(self, f"D{s}"),
                       dt_bias=getattr(self, f"dt{s}_bias"), dt_softplus=True,
                       return_last_state=return_last_state,
                       backend=self.scan_backend, chunk=self.scan_chunk)
        if return_last_state:
            return out[0].reshape(B_, L, self.d_inner), out[1]
        out = out.reshape(B_, L, self.d_inner)
        return scan_out(out) if self.name_scan_out else out

    def _in(self, x):
        """``in_proj`` -> (z, xBC, dt).  Under tensor parallelism it is
        column-parallel and its output is gathered whole on every rank:
        the SSD's own parameters stay replicated, as the JAX rules leave
        them."""
        if self.tp_group is not None:
            x = copy_to_group(x, self.tp_group)
        zxbcdt = dense(self.in_proj, x, self.dtype)
        if self.tp_group is not None:
            zxbcdt = gather_last(zxbcdt, self.tp_group)
        return zxbcdt.split([self.d_inner, self.conv_dim, self.nheads],
                            dim=-1)

    def _out(self, y):
        """``out_proj``; row-parallel on this rank's slice of its input
        under tensor parallelism."""
        if self.tp_group is not None:
            return row_parallel_linear(
                self.out_proj, split_last(y, self.tp_group), self.dtype,
                self.tp_group)
        return dense(self.out_proj, y, self.dtype)

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
        z, xbc, dt = self._in(x)
        y = self._branch("", xbc, dt)
        if self.scan_type == "v2":
            y = y + self._branch("_b", xbc.flip(1), dt.flip(1)).flip(1)
        out = self._out(self._gated_norm(y, z))
        if self.perm_rev is not None:
            out = permute_tokens(out, self.perm_rev, self.perm_rev_bwd)
        if self.video:
            out = unfold_frames(out, B_, self.video_frames, self.st)
        return out

    def step(self, x, cache):
        """One decode token.  x: (batch, 1, d_model); cache from
        ``Mamba2Cache.init`` or ``prefill``.  Direction-less, like
        ``Mamba.step``.  Returns (out (batch, 1, d_model), new cache)."""
        conv_state, ssm_state = cache
        z, xbc, dt = self._in(x[:, 0])
        xbc_c, conv_state = causal_conv1d_update(
            xbc, conv_state, self.conv1d.weight[:, 0, :], self.conv1d.bias,
            accum_dtype=self.conv_accum)
        x_, Bv, Cv = self._split(xbc_c)
        y, ssm_state = ssd_state_update(
            ssm_state, x_, dt, -torch.exp(self.A_log.float()), Bv, Cv, self.D,
            dt_bias=self.dt_bias, dt_softplus=True)
        out = self._out(self._gated_norm(y.reshape(-1, self.d_inner), z))
        return out[:, None], (conv_state, ssm_state)

    def prefill(self, x):
        """A v1 prompt through the chunked SSD: (out (batch, L, d_model),
        the cache ``step`` continues from)."""
        if self.scan_type != "v1":
            raise ValueError(
                f"prefill/decode requires scan_type='v1', got "
                f"{self.scan_type!r}")
        z, xbc, dt = self._in(x)
        y, ssm_state = self._branch("", xbc, dt, return_last_state=True)
        conv_state = conv_window(xbc, self.d_conv, Mamba2Cache.CONV_DTYPE)
        return self._out(self._gated_norm(y, z)), (conv_state, ssm_state)
