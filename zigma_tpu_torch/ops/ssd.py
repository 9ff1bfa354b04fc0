"""State-space duality (SSD, the Mamba-2 recurrence) in torch ops.

Counterpart of ``zigma_tpu/ops/ssd.py``.  Per head h, with a scalar decay
per (token, head) and an (P, N) state:

    S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * (x_t ⊗ B_t)
    y_t = S_t @ C_t (+ D_h * x_t) (* silu(z_t))

- ``ssd_scan_ref``: the plain sequential recurrence, step by step over L, in
  float32 (float64 for float64 inputs: a truth to hold the chunked form
  against on the card).
- ``ssd_scan`` (``backend="chunked"``, the default): the chunked form, as
  the JAX package computes it.  Within a chunk of Q tokens the recurrence
  is a masked matrix product, ``Y_intra = ((C Bᵀ) ⊙ M) X`` with
  ``M[t, s] = exp(cum_t - cum_s) dt_s`` for s <= t; each chunk's state
  ``(B · decay to its end · dt)ᵀ X`` enters an fp32 recurrence over the
  L/Q chunks, and ``Y_inter = (C · decay from its start) S_prev``.
- ``ssd_state_update``: one decode step, with the shape checks the JAX
  function skips.

JAX has no Pallas kernel here (XLA tiles the einsums), so neither has the
port: the contractions are batched ``torch.matmul`` calls, each written as
one pair of operands (the three-operand chunk aggregate too), and the
gradient is plain autograd.  Of the (b, L/Q, heads, Q, Q) fp32
intermediates (200 MB each at the ssm2 flagship's scan), autograd keeps
the decays and their product with C Bᵀ, the residuals JAX's VJP keeps, and
the scores in the matmul dtype; the segment sums and masked copies are
freed as soon as the decays exist.

Precision, as the JAX package's: cumulative log-decays, the masks and the
inter-chunk recurrence in fp32 whatever the input dtype.  For fp32 inputs
every product is fp32 (TF32 is off on the card, ``device.py``).  For bf16
inputs the two contractions JAX asks fp32 outputs of (the C Bᵀ scores and
the chunk aggregates, ``preferred_element_type``) take fp32 copies of the
bf16 operands -- the upcast is exact, so these are JAX's bf16 products
summed in fp32 -- and the two Y contractions multiply bf16 operands into
bf16 outputs, which are summed in fp32, as JAX's do.

Shapes (channels-last, G groups of B/C shared by H/G heads each):
x (batch, L, H, P); dt (batch, L, H); A (H,) negative; B, C (batch, L, G,
N); D (H,) or (H, P); z (batch, L, H, P); states (batch, H, P, N).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["ssd_scan", "ssd_scan_ref", "ssd_state_update"]


def _acc_dtype(x):
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _dt_values(dt, dt_bias, dt_softplus, H, acc):
    if dt_bias is not None:
        if tuple(dt_bias.shape) != (H,):
            raise ValueError(f"dt_bias shape {tuple(dt_bias.shape)} != ({H},)")
        dt = dt.to(acc) + dt_bias.to(acc)
    else:
        dt = dt.to(acc)
    return F.softplus(dt) if dt_softplus else dt


def _prep(x, dt, A, B, C, D, dt_bias, dt_softplus):
    """The JAX ``_prep``: shape checks, then dt (+ bias, softplus) in the
    accumulation dtype.  Returns ``(dt, G, N)``."""
    batch, L, H, P = x.shape
    if tuple(dt.shape) != (batch, L, H):
        raise ValueError(f"dt shape {tuple(dt.shape)} != {(batch, L, H)}")
    if tuple(A.shape) != (H,):
        raise ValueError(f"A shape {tuple(A.shape)} != ({H},)")
    if B.dim() != 4 or C.dim() != 4:
        raise ValueError("B/C must be (batch, L, G, N)")
    if tuple(B.shape[:2]) != (batch, L):
        raise ValueError(f"B shape {tuple(B.shape)} does not start with "
                         f"{(batch, L)}")
    G, N = B.shape[2], B.shape[3]
    if C.shape != B.shape:
        raise ValueError(f"C shape {tuple(C.shape)} != B shape {tuple(B.shape)}")
    if H % G != 0:
        raise ValueError(f"heads {H} not divisible by groups {G}")
    if D is not None and tuple(D.shape) not in ((H,), (H, P)):
        raise ValueError(f"D shape {tuple(D.shape)} must be ({H},) or ({H},{P})")
    return _dt_values(dt, dt_bias, dt_softplus, H, _acc_dtype(x)), G, N


def _skip_gate(y, x, D, z):
    """``(y + D x) * silu(z)``, each factor only where given, in y's dtype."""
    if D is not None:
        d = D.to(y.dtype)
        d = d[:, None] if D.dim() == 1 else d  # (H, 1) | (H, P)
        y = y + d * x.to(y.dtype)
    if z is not None:
        y = y * F.silu(z.to(y.dtype))
    return y


def ssd_scan_ref(x, dt, A, B, C, D: Optional[torch.Tensor] = None,
                 z: Optional[torch.Tensor] = None,
                 dt_bias: Optional[torch.Tensor] = None,
                 dt_softplus: bool = False,
                 initial_state: Optional[torch.Tensor] = None,
                 return_last_state: bool = False):
    """The plain sequential recurrence, one step a token.  Returns y in x's
    dtype and, with ``return_last_state``, the final (batch, H, P, N) state
    in the accumulation dtype (float32, or float64 for float64 x)."""
    batch, L, H, P = x.shape
    dtv, G, N = _prep(x, dt, A, B, C, D, dt_bias, dt_softplus)
    acc = dtv.dtype
    rep = H // G
    xf = x.to(acc)
    Bh = B.to(acc).repeat_interleave(rep, dim=2)  # (batch, L, H, N)
    Ch = C.to(acc).repeat_interleave(rep, dim=2)
    Af = A.to(acc)
    S = (torch.zeros((batch, H, P, N), dtype=acc, device=x.device)
         if initial_state is None else initial_state.to(acc))
    ys = []
    for t in range(L):
        a = torch.exp(dtv[:, t] * Af)                          # (b, H)
        dBx = (dtv[:, t, :, None] * xf[:, t])[..., None] * Bh[:, t, :, None, :]
        S = a[:, :, None, None] * S + dBx
        ys.append(torch.einsum("bhpn,bhn->bhp", S, Ch[:, t]))
    y = _skip_gate(torch.stack(ys, dim=1), x, D, z).to(x.dtype)
    return (y, S) if return_last_state else y


def _ssd_chunked(x, dt, A, B, C, D, z, dt_bias, dt_softplus, initial_state,
                 return_last_state, chunk):
    batch, L, H, P = x.shape
    dtv, G, N = _prep(x, dt, A, B, C, D, dt_bias, dt_softplus)
    f32 = dtv.dtype
    Hg, Q = H // G, int(chunk)
    pad = (-L) % Q
    nc = (L + pad) // Q
    mm = x.dtype if x.dtype in (torch.bfloat16, torch.float16) else f32
    x_in = x
    # zero-pad dt after softplus: a padded step decays by 1 and adds nothing
    if pad:
        x, dtv, B, C = (F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
                        for a in (x, dtv, B, C))

    # head-major chunk views: (b, nc, G, Hg, Q, ...) so B/C broadcast over Hg
    xh = x.reshape(batch, nc, Q, G, Hg, P).permute(0, 1, 3, 4, 2, 5)
    dth = dtv.reshape(batch, nc, Q, G, Hg).permute(0, 1, 3, 4, 2)
    Bg = B.reshape(batch, nc, Q, G, N).permute(0, 1, 3, 2, 4)  # (b,nc,G,Q,N)
    Cg = C.reshape(batch, nc, Q, G, N).permute(0, 1, 3, 2, 4)
    Ag = A.to(f32).reshape(G, Hg)
    cum = torch.cumsum(dth * Ag[..., None], dim=-1)            # (b,nc,G,Hg,Q) <= 0

    # intra-chunk: Y = ((C Bᵀ) ⊙ M) X, M[t, s] = exp(cum_t - cum_s) dt_s
    cb = torch.matmul(Cg.to(f32), Bg.to(f32).transpose(-1, -2))  # (b,nc,G,Q,Q)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    seg = cum[..., :, None] - cum[..., None, :]                # (b,nc,G,Hg,t,s)
    decay = torch.exp(torch.where(mask, seg, float("-inf")))  # 0 above the diagonal
    del seg
    scores = (cb[:, :, :, None] * decay * dth[..., None, :]).to(mm)
    del decay
    y_intra = torch.matmul(scores, xh.to(mm))                  # (b,nc,G,Hg,Q,P)
    del scores

    # chunk aggregates: S_c = Xᵀ (B · exp(cum_last - cum) dt), fp32 out
    dte = (torch.exp(cum[..., -1:] - cum) * dth).to(mm).to(f32)
    bw = Bg.to(f32)[:, :, :, None] * dte[..., None]            # (b,nc,G,Hg,Q,N)
    s_chunk = torch.matmul(xh.to(mm).to(f32).transpose(-1, -2), bw)  # (..,P,N)
    del bw

    # inter-chunk recurrence in fp32 over the nc aggregates
    a_chunk = torch.exp(cum[..., -1])                          # (b,nc,G,Hg)
    S = (torch.zeros((batch, G, Hg, P, N), dtype=f32, device=x.device)
         if initial_state is None
         else initial_state.to(f32).reshape(batch, G, Hg, P, N))
    prevs = []
    for c in range(nc):
        prevs.append(S)
        S = a_chunk[:, c, :, :, None, None] * S + s_chunk[:, c]
    S_prev = torch.stack(prevs, dim=1)                         # (b,nc,G,Hg,P,N)

    # inter-chunk: Y += (C · exp(cum)) S_prev
    cdec = (Cg.to(f32)[:, :, :, None] * torch.exp(cum)[..., None]).to(mm)
    y_inter = torch.matmul(cdec, S_prev.to(mm).transpose(-1, -2))  # (..,Q,P)

    y = y_intra.to(f32) + y_inter.to(f32)
    y = y.permute(0, 1, 4, 2, 3, 5).reshape(batch, nc * Q, H, P)[:, :L]
    y = _skip_gate(y, x_in, D, z).to(x_in.dtype)
    if return_last_state:
        return y, S.reshape(batch, H, P, N)
    return y


def ssd_scan(x, dt, A, B, C, D: Optional[torch.Tensor] = None,
             z: Optional[torch.Tensor] = None,
             dt_bias: Optional[torch.Tensor] = None, dt_softplus: bool = False,
             initial_state: Optional[torch.Tensor] = None,
             return_last_state: bool = False, backend: str = "auto",
             chunk: int = 128):
    """The SSD scan (shapes: the module docstring).  backend: "auto" and
    "chunked" run the chunked form, "ref" the sequential one.  Returns y in
    x's dtype and, with ``return_last_state``, the fp32 final state."""
    if backend in ("auto", "chunked"):
        return _ssd_chunked(x, dt, A, B, C, D, z, dt_bias, dt_softplus,
                            initial_state, return_last_state, chunk)
    if backend == "ref":
        return ssd_scan_ref(x, dt, A, B, C, D, z, dt_bias, dt_softplus,
                            initial_state, return_last_state)
    raise ValueError(f"unknown backend {backend!r} (auto | chunked | ref)")


def ssd_state_update(state, x, dt, A, B, C, D: Optional[torch.Tensor] = None,
                     z: Optional[torch.Tensor] = None,
                     dt_bias: Optional[torch.Tensor] = None,
                     dt_softplus: bool = False):
    """One decode step.  state (batch, H, P, N); x (batch, H, P); dt (batch,
    H); B, C (batch, G, N); D (H,) or (H, P); z (batch, H, P).  Every shape
    is checked (the JAX function checks none).  Returns ``(y (batch, H, P)
    in x's dtype, the new fp32 state)``."""
    if x.dim() != 3:
        raise ValueError(f"x must be (batch, H, P), got {tuple(x.shape)}")
    batch, H, P = x.shape
    if B.dim() != 3 or tuple(B.shape[:1]) != (batch,):
        raise ValueError(f"B must be ({batch}, G, N), got {tuple(B.shape)}")
    G, N = B.shape[1], B.shape[2]
    if C.shape != B.shape:
        raise ValueError(f"C shape {tuple(C.shape)} != B shape {tuple(B.shape)}")
    if H % G != 0:
        raise ValueError(f"heads {H} not divisible by groups {G}")
    for name, t, want in (("state", state, (batch, H, P, N)),
                          ("dt", dt, (batch, H)), ("A", A, (H,)),
                          ("z", z, (batch, H, P))):
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {want}")
    if D is not None and tuple(D.shape) not in ((H,), (H, P)):
        raise ValueError(f"D shape {tuple(D.shape)} must be ({H},) or ({H},{P})")
    acc = _acc_dtype(x)
    dtv = _dt_values(dt, dt_bias, dt_softplus, H, acc)
    rep = H // G
    a = torch.exp(dtv * A.to(acc))                              # (b, H)
    Bh = B.to(acc).repeat_interleave(rep, dim=1)               # (b, H, N)
    Ch = C.to(acc).repeat_interleave(rep, dim=1)
    dBx = (dtv[..., None] * x.to(acc))[..., None] * Bh[:, :, None, :]
    state = a[:, :, None, None] * state.to(acc) + dBx
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return _skip_gate(y, x, D, z).to(x.dtype), state
