"""Mamba sequence mixer with ZigMa scan-type dispatch.

Counterpart of ``zigma_tpu/models/mamba.py``.  Layout is channels-last
(batch, L, d) throughout.  Parameters carry the reference torch names
(``in_proj``, ``out_proj``, ``conv1d``, ``x_proj``, ``dt_proj``, ``A_log``,
``D``, the ``_b`` set for the v2 backward direction and the ``*_b_list.{j}``
sets of the parallelN branches), so a reference state dict loads as it is.

As in the JAX package:
- the scan-path permutation is applied at d_model before ``in_proj`` and
  inverted after ``out_proj`` (the ops between are per token);
- v2 runs a second direction on the flipped input and adds it back flipped;
- parallelN runs k more branches, each on its own zigzag path, and sums them
  into the forward branch before ``out_proj``;
- video layers fold the frames: a spatial layer (``st='s'``) scans each
  frame's tokens, ``(b, (t k), d) -> ((b t), k, d)``, a temporal layer
  (``st='t'``) each token's frames, ``(b, (t k), d) -> ((b k), t, d)``;
- the dt_proj bias enters the scan as ``delta_bias`` under softplus, not in
  the GEMM.

On CUDA the scan is the hand-written kernels (K1 forward, K2 backward) with
the ``(y + u*D)*silu(z)`` gate fused in.  The scan-path gathers go through
``permute_tokens``, whose backward is the gather by the functional inverse
of the permutation (``vjp_inverse``), not torch indexing's scatter-add.
The decode ``step``/``prefill`` is a later slice of the port.
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
from zigma_tpu_torch.ops.causal_conv1d import causal_conv1d
from zigma_tpu_torch.ops.selective_scan import selective_scan

__all__ = ["Mamba", "permute_tokens", "vjp_inverse", "fold_frames",
           "unfold_frames", "register_path_tables"]

_VIDEO_SCANS = ("video_", "zzvideo_")
_SCANS = ("v1", "v2", "zigzagN", "hilbertN", "randomN", "parallelN",
          *_VIDEO_SCANS)


class _PermuteTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, inv_perm):
        ctx.save_for_backward(inv_perm)
        return x.index_select(1, perm)

    @staticmethod
    def backward(ctx, g):
        (inv_perm,) = ctx.saved_tensors
        return g.index_select(1, inv_perm), None, None


def permute_tokens(x, perm, inv_perm):
    """``x[:, perm]`` whose backward is the gather ``g[:, inv_perm]``.

    Counterpart of ``zigma_tpu/models/mamba.py::permute_tokens``.  Torch
    indexing would differentiate into an ``index_put_`` with accumulate (a
    sort and a scatter-add on the card), because it cannot know the index
    set is a bijection; for a permutation every output row takes exactly one
    input row, so the inverse gather is the same gradient.  ``inv_perm``
    must be the functional inverse of ``perm`` (argsort(perm)), not blindly
    the model's paired ``perm_rev``: a temporal video layer pairs the two
    frame orders, which are not inverses, and that pair here would flip
    every temporal gradient.  ``vjp_inverse`` gives the right argument.
    """
    return _PermuteTokens.apply(x, perm, inv_perm)


def vjp_inverse(perm, paired_rev, trust_pair: bool):
    """The functional inverse of ``perm`` for ``permute_tokens``' backward:
    the paired table where the pair is known to be mutual inverses (image
    scans, ``trust_pair``), else ``argsort(perm)`` (video layers)."""
    if trust_pair:
        return paired_rev
    return np.argsort(np.asarray(perm))


def fold_frames(x, frames: int, st: str):
    """A video layer's fold: spatial (``st='s'``) ``(b, (t k), d) -> ((b t),
    k, d)``, each frame's tokens a sequence; temporal (``'t'``) ``(b, (t k),
    d) -> ((b k), t, d)``, each token's frames a sequence."""
    B_, L, d = x.shape
    if st == "s":
        return x.reshape(B_ * frames, L // frames, d)
    return x.reshape(B_, frames, L // frames, d).transpose(1, 2).reshape(
        B_ * (L // frames), frames, d)


def unfold_frames(out, batch: int, frames: int, st: str):
    """The inverse of ``fold_frames``: back to (batch, (t k), d)."""
    d = out.shape[-1]
    L = out.shape[0] * out.shape[1] // batch
    if st == "s":
        return out.reshape(batch, L, d)
    return out.reshape(batch, L // frames, frames, d).transpose(1, 2).reshape(
        batch, L, d)


def register_path_tables(module: nn.Module, perm, perm_rev, video: bool,
                         device=None, **extra):
    """The scan-path tables of a mixer as non-persistent long buffers (not
    state: reference checkpoints have no such keys): ``perm`` /
    ``perm_rev`` and the functional inverses their gathers' backward takes
    (``perm_bwd`` / ``perm_rev_bwd``, ``vjp_inverse``), plus ``extra``
    tables; a None table stays None."""
    if (perm is None) != (perm_rev is None):
        raise ValueError("perm and its inverse perm_rev come together")
    tables = dict(perm=perm, perm_rev=perm_rev, perm_bwd=None,
                  perm_rev_bwd=None, **extra)
    if perm is not None:
        tables["perm_bwd"] = vjp_inverse(perm, perm_rev, not video)
        tables["perm_rev_bwd"] = vjp_inverse(perm_rev, perm, not video)
    for name, p in tables.items():
        module.register_buffer(
            name, None if p is None else torch.as_tensor(
                np.asarray(p), dtype=torch.long, device=device),
            persistent=False)


class Mamba(nn.Module):
    """Selective-SSM token mixer.  ``perm``/``perm_rev`` are this layer's
    scan path and its paired table (numpy int arrays) or None: the inverse
    for image scans, the other frame order for a temporal video layer.
    ``video_frames`` and ``st`` ('s' | 't') configure a video layer's fold;
    ``parallel_perms`` are a parallelN mixer's ``(perm, perm_rev)`` pairs."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4,
                 expand: int = 2, dt_rank="auto", dt_min: float = 0.001,
                 dt_max: float = 0.1, dt_init: str = "random",
                 dt_scale: float = 1.0, dt_init_floor: float = 1e-4,
                 conv_bias: bool = True, bias: bool = False,
                 scan_type: str = "v2", perm: Optional[np.ndarray] = None,
                 perm_rev: Optional[np.ndarray] = None, video_frames: int = 0,
                 st: Optional[str] = None,
                 parallel_perms: Optional[tuple] = None, n_layer: int = 1,
                 dtype: torch.dtype = torch.float32, scan_backend: str = "auto",
                 conv_fp32_taps: bool = False, device=None):
        super().__init__()
        if not scan_type.startswith(_SCANS):
            raise ValueError(f"unknown scan_type: {scan_type!r}")
        self.video = scan_type.startswith(_VIDEO_SCANS)
        if self.video and (st not in ("s", "t") or video_frames <= 0):
            raise ValueError(
                f"video scan_type {scan_type!r} requires st='s' or 't' and "
                f"video_frames > 0, got st={st!r}, video_frames={video_frames}")
        n_par = 0
        if scan_type.startswith("parallelN"):
            try:
                n_par = int(scan_type[len("parallelN"):])
            except ValueError as e:
                raise ValueError(f"scan_type {scan_type!r} needs a branch "
                                 f"count, e.g. 'parallelN4'") from e
            if parallel_perms is None or len(parallel_perms) != n_par:
                raise ValueError(
                    f"scan_type {scan_type!r} requires parallel_perms with "
                    f"{n_par} (perm, perm_rev) pairs, got "
                    f"{None if parallel_perms is None else len(parallel_perms)}")
        self.d_model, self.d_state, self.d_conv = d_model, d_state, d_conv
        self.d_inner = int(expand * d_model)
        self.dt_rank = math.ceil(d_model / 16) if dt_rank == "auto" else int(dt_rank)
        self.dt_min, self.dt_max = dt_min, dt_max
        self.dt_init, self.dt_scale, self.dt_init_floor = dt_init, dt_scale, dt_init_floor
        self.scan_type, self.n_layer = scan_type, n_layer
        self.video_frames, self.st = video_frames, st
        self.dtype, self.scan_backend = dtype, scan_backend
        self.conv_accum = torch.float32 if conv_fp32_taps else None
        self.directions = ("", "_b") if scan_type == "v2" else ("",)

        di, R, N = self.d_inner, self.dt_rank, d_state
        self.in_proj = nn.Linear(d_model, 2 * di, bias=bias, device=device)
        for s in self.directions:
            setattr(self, f"conv1d{s}", nn.Conv1d(di, di, d_conv, groups=di,
                                                  bias=conv_bias, device=device))
            setattr(self, f"x_proj{s}", nn.Linear(di, R + 2 * N, bias=False,
                                                  device=device))
            setattr(self, f"dt_proj{s}", nn.Linear(R, di, bias=True, device=device))
            setattr(self, f"A{s}_log", nn.Parameter(torch.empty(di, N, device=device)))
            setattr(self, f"D{s}", nn.Parameter(torch.empty(di, device=device)))
        if n_par:
            self.conv1d_b_list = nn.ModuleList(
                nn.Conv1d(di, di, d_conv, groups=di, bias=conv_bias,
                          device=device) for _ in range(n_par))
            self.x_proj_b_list = nn.ModuleList(
                nn.Linear(di, R + 2 * N, bias=False, device=device)
                for _ in range(n_par))
            self.dt_proj_b_list = nn.ModuleList(
                nn.Linear(R, di, bias=True, device=device)
                for _ in range(n_par))
            self.A_b_log_list = nn.ParameterList(
                nn.Parameter(torch.empty(di, N, device=device))
                for _ in range(n_par))
            self.D_b_list = nn.ParameterList(
                nn.Parameter(torch.empty(di, device=device))
                for _ in range(n_par))
        self.out_proj = nn.Linear(di, d_model, bias=bias, device=device)
        register_path_tables(
            self, perm, perm_rev, self.video, device,
            parallel_perm=(np.stack([p for p, _ in parallel_perms])
                           if n_par else None),
            parallel_perm_rev=(np.stack([pr for _, pr in parallel_perms])
                               if n_par else None))

    def _branches(self):
        """(conv1d, x_proj, dt_proj, A_log, D) of every scan branch: the
        forward one, then v2's ``_b`` or parallelN's ``*_b_list.{j}``."""
        out = [(getattr(self, f"conv1d{s}"), getattr(self, f"x_proj{s}"),
                getattr(self, f"dt_proj{s}"), getattr(self, f"A{s}_log"),
                getattr(self, f"D{s}")) for s in self.directions]
        if self.parallel_perm is not None:
            out += list(zip(self.conv1d_b_list, self.x_proj_b_list,
                            self.dt_proj_b_list, self.A_b_log_list,
                            self.D_b_list))
        return out

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The JAX package's inits: torch-default GEMMs with zero biases,
        out_proj rescaled by sqrt(n_layer), S4D-real A, inverse-softplus dt
        bias, U(+-1/sqrt(d_conv)) conv taps, D = 1."""
        torch_linear_init_(self.in_proj.weight, generator)
        rescaled_linear_init_(self.out_proj.weight, self.n_layer, generator)
        for lin in (self.in_proj, self.out_proj):
            if lin.bias is not None:
                lin.bias.zero_()
        for conv, x_proj, dt_proj, A_log, D in self._branches():
            uniform_(conv.weight, (1.0 / self.d_conv) ** 0.5, generator)
            if conv.bias is not None:
                uniform_(conv.bias, (1.0 / self.d_conv) ** 0.5, generator)
            torch_linear_init_(x_proj.weight, generator)
            std = self.dt_rank ** -0.5 * self.dt_scale
            if self.dt_init == "constant":
                dt_proj.weight.fill_(std)
            elif self.dt_init == "random":
                uniform_(dt_proj.weight, std, generator)
            else:
                raise NotImplementedError(self.dt_init)
            dt = torch.exp(
                torch.rand(self.d_inner, generator=generator,
                           device=dt_proj.bias.device)
                * (math.log(self.dt_max) - math.log(self.dt_min))
                + math.log(self.dt_min)).clamp(min=self.dt_init_floor)
            dt_proj.bias.copy_(dt + torch.log(-torch.expm1(-dt)))
            A = torch.arange(1, self.d_state + 1, dtype=torch.float32,
                             device=dt.device).repeat(self.d_inner, 1)
            A_log.copy_(torch.log(A))
            D.fill_(1.0)

    def _scan_branch(self, branch, x_in, z):
        """conv -> x_proj -> dt_proj -> selective scan for one branch of
        ``_branches()``; returns the gated scan output."""
        conv, x_proj, dt_proj, A_log, D = branch
        x_c = causal_conv1d(x_in, conv.weight[:, 0, :], conv.bias,
                            activation="silu", accum_dtype=self.conv_accum)
        x_dbl = F.linear(x_c, x_proj.weight.to(self.dtype))
        dt, Bv, Cv = x_dbl.split([self.dt_rank, self.d_state, self.d_state], -1)
        delta = F.linear(dt, dt_proj.weight.to(self.dtype))  # bias: in the scan
        A = -torch.exp(A_log.float())
        return selective_scan(x_c, delta, A, Bv, Cv, D.float(), z=z,
                              delta_bias=dt_proj.bias.float(),
                              delta_softplus=True, backend=self.scan_backend)

    def forward(self, x):
        """x: (batch, L, d_model) -> (batch, L, d_model)."""
        B_ = x.shape[0]
        if self.video:
            x = fold_frames(x, self.video_frames, self.st)
        if self.perm is not None:
            x = permute_tokens(x, self.perm, self.perm_bwd)
        xz = dense(self.in_proj, x, self.dtype)
        x_in, z = xz.chunk(2, dim=-1)
        branches = self._branches()
        y = self._scan_branch(branches[0], x_in, z)
        if self.scan_type == "v2":
            y_b = self._scan_branch(branches[1], x_in.flip(1), z.flip(1))
            y = y + y_b.flip(1)
        elif self.parallel_perm is not None:
            for br, p, pr in zip(branches[1:], self.parallel_perm,
                                 self.parallel_perm_rev):
                yi = self._scan_branch(br, permute_tokens(x_in, p, pr),
                                       permute_tokens(z, p, pr))
                y = y + permute_tokens(yi, pr, p)
        out = dense(self.out_proj, y, self.dtype)
        if self.perm_rev is not None:
            out = permute_tokens(out, self.perm_rev, self.perm_rev_bwd)
        if self.video:
            out = unfold_frames(out, B_, self.video_frames, self.st)
        return out
