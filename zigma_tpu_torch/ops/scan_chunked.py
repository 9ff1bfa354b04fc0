"""The chunked and associative selective-scan backends, in torch ops.

Counterparts of the jnp backends of ``zigma_tpu/ops/selective_scan.py``
(what the JAX package leaves to XLA, not a Pallas kernel), so plain torch on
any device:

- ``selective_scan_chunked`` (JAX: ``_chunked_core`` / ``_chunked_fwd_impl``
  / ``_chunked_bwd``): a ``torch.autograd.Function`` over chunks of
  ``chunk`` steps (the last padded with steps whose dt is 0, which leave the
  state as it is).  Its forward keeps only the chunk-start states; its
  backward recomputes each chunk's states from its start and walks the
  adjoint ``g_t = dx_t + exp(dt_{t+1} A) g_{t+1}`` through it in reverse,
  last chunk first (``_chunk_adjoint``), seeded by the final state's
  cotangent.  Real or complex64 A / B / C (the S4D-complex mode, ``y = 2
  Re<C, x>``), any d_state, variable (batch, L, N) or grouped (batch, L, G,
  N) B / C -- the groups an axis of every tensor, (batch, L, G, d/G)
  channels against (batch, L, G, N) B / C, in place of the JAX package's
  vmap over ``_grouped_fast_call``'s split -- optional D, z, delta_bias and
  the final state.  Complex runs in torch's complex64: the JAX package's
  real-pair lowering is a TPU workaround and is not ported.
- ``selective_scan_assoc`` (JAX: ``_selective_scan_assoc``): the whole
  sequence at once, (batch, L, d, N) materialised, B / C static (d, N),
  variable or grouped; differentiated by torch autograd, as the JAX one by
  autodiff through ``lax.associative_scan``.

The scan inside a chunk (and the associative backend's over L) is
``scan_pairs``: torch has no associative scan, so it is a log-step
(Hillis-Steele) doubling over the monoid ``(la, b)``, segment ``x -> exp(la)
x + b`` in log-a form: ``(la1, b1) . (la2, b2) = (la1 + la2, b1 exp(la2) +
b2)`` (JAX's ``_scan_combine``).  ceil(log2 n) passes over the whole
(batch, n, ...) block, each a few elementwise ops, rather than a Python loop
over the n steps: on the card a 128-step chunk is 7 passes of a few
launches over the whole block instead of 128 steps of small launches, and
the multipliers stay ``exp`` of sums of ``la`` (at most 1 for a stable A),
with no division or rescaling that could overflow.

Complex gradients.  Torch's gradient of a complex leaf is the conjugate of
JAX's (``jax.grad`` of ``2 Re(k w)`` is ``2k``, torch's ``2 conj(k)``).  The
backward runs the JAX package's algebra (cotangent of a complex w taken as
``dL/dRe w - i dL/dIm w``, under which the chain rule through holomorphic
factors needs no conjugate) and conjugates at the boundary: the final
state's cotangent coming in, the gradients of complex A / B / C going out;
a real leaf takes the real part.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["selective_scan_chunked", "selective_scan_assoc", "scan_pairs"]


def f32(t):
    """t in its compute type: complex64 for a complex tensor, else fp32."""
    return t.to(torch.complex64 if t.is_complex() else torch.float32)


def delta_prep(delta, delta_bias, delta_softplus):
    """(dt, d dt / d pre) in fp32, pre = delta + bias; softplus with torch's
    threshold 20, as the kernels."""
    pre = delta.float()
    if delta_bias is not None:
        pre = pre + delta_bias.float()
    if not delta_softplus:
        return pre, torch.ones_like(pre)
    return F.softplus(pre), torch.sigmoid(pre)


def skip_and_gate(y, u, D, z):
    """``(y + u * D) * silu(z)`` in fp32, each factor only where given;
    returns u's dtype."""
    y = y.float()
    if D is not None:
        y = y + u.float() * D.float()
    if z is not None:
        y = y * F.silu(z.float())
    return y.to(u.dtype)


def check_complex(A, B, C):
    if (B.is_complex() or C.is_complex()) and not A.is_complex():
        raise ValueError("complex B/C require complex A (the reference's "
                         "S4D-complex mode dispatches on A's dtype)")


def scan_pairs(la, b, dim: int = 1):
    """Inclusive scan of ``(la, b)`` along ``dim`` under ``(la1, b1) .
    (la2, b2) = (la1 + la2, b1 exp(la2) + b2)``: returns ``(sum of la up
    to t, the state at t from a zero start)``.  Log-step doubling: after
    the pass with offset s, element t combines the 2s elements up to it."""
    if la.is_complex() and not b.is_complex():
        b = b.to(la.dtype)
    n, s = la.shape[dim], 1
    while s < n:
        head, tail = la.narrow(dim, 0, n - s), la.narrow(dim, s, n - s)
        b = torch.cat([b.narrow(dim, 0, s),
                       b.narrow(dim, 0, n - s) * torch.exp(tail)
                       + b.narrow(dim, s, n - s)], dim)
        la = torch.cat([la.narrow(dim, 0, s), tail + head], dim)
        s *= 2
    return la, b


def _chunk_states(la, b, x0):
    """The states of a chunk (batch, cl, ...) seeded by x0 (batch, ...)."""
    la_cum, xs0 = scan_pairs(la, b)
    return xs0 + torch.exp(la_cum) * x0[:, None]


def _chunk_adjoint(la, dx, g_in):
    """The reverse walk ``g_t = dx_t + exp(la_{t+1}) g_{t+1}`` over a chunk,
    where ``g_in`` is what flows into its last state from after the chunk
    (JAX's ``_chunk_adjoint``): the same scan on the reversed chunk, each
    multiplier shifted one step."""
    la_next = torch.cat([la[:, 1:], torch.zeros_like(la[:, :1])], 1)
    la_cum, g0 = scan_pairs(la_next.flip(1), dx.flip(1))
    return (g0 + torch.exp(la_cum) * g_in[:, None]).flip(1)


def _pad(t, L_pad):
    """t (batch, L, ...) zero-padded along L to L_pad."""
    if t.shape[1] == L_pad:
        return t
    pad = t.new_zeros((t.shape[0], L_pad - t.shape[1], *t.shape[2:]))
    return torch.cat([t, pad], 1)


class _ChunkedScan(torch.autograd.Function):
    """u, delta (batch, L, d); A (d, N); B, C (batch, L, G, N); D, z,
    delta_bias optional.  Returns (out (batch, L, d) in u's dtype, the
    final state (batch, d, N) in A's compute type)."""

    @staticmethod
    def _terms(dt, dtu, Ag, Bc, cl):
        """la = dt A and b = dt u B of a chunk: (batch, cl, G, H, N)."""
        batch, _, G, H, _ = *dt.shape[:2], *Ag.shape
        dt = dt.reshape(batch, cl, G, H, 1)
        la = dt * Ag
        b = dtu.reshape(batch, cl, G, H, 1) * Bc[:, :, :, None, :]
        return la, b

    @staticmethod
    def _y(xs, Cc, cplx):
        y = torch.einsum("blghn,blgn->blgh", xs, Cc.to(xs.dtype))
        return 2.0 * y.real if cplx else y

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, z, delta_bias, chunk: int,
                softplus: bool):
        batch, L, d = u.shape
        G, N = B.shape[2], A.shape[1]
        H = d // G
        cl = min(chunk, L)
        nc = -(-L // cl)
        L_pad = nc * cl
        cplx = A.is_complex()
        dt, _ = delta_prep(delta, delta_bias, softplus)
        dtu = _pad(dt * u.float(), L_pad)
        dt = _pad(dt, L_pad)
        Bf, Cf = _pad(f32(B), L_pad), _pad(f32(C), L_pad)
        Ag = f32(A).reshape(G, H, N)
        x = torch.zeros((batch, G, H, N), dtype=Ag.dtype, device=u.device)
        carries, ys = [], []
        for k in range(nc):
            s = slice(k * cl, (k + 1) * cl)
            la, b = _ChunkedScan._terms(dt[:, s], dtu[:, s], Ag, Bf[:, s], cl)
            xs = _chunk_states(la, b, x)
            carries.append(x)
            ys.append(_ChunkedScan._y(xs, Cf[:, s], cplx))
            x = xs[:, -1]
        y = torch.cat(ys, 1)[:, :L].reshape(batch, L, d)
        ctx.save_for_backward(u, delta, A, B, C, D, z, delta_bias,
                              torch.stack(carries, 1))
        ctx.cfg = (chunk, softplus)
        ctx.set_materialize_grads(False)
        return skip_and_gate(y, u, D, z), x.reshape(batch, d, N)

    @staticmethod
    def backward(ctx, g_out, g_last):
        u, delta, A, B, C, D, z, delta_bias, carries = ctx.saved_tensors
        chunk, softplus = ctx.cfg
        batch, L, d = u.shape
        G, N = B.shape[2], A.shape[1]
        H = d // G
        nc = carries.shape[1]
        cl = min(chunk, L)
        L_pad = nc * cl
        cplx = A.is_complex()
        uf = u.float()
        dt, sig = delta_prep(delta, delta_bias, softplus)
        g = (torch.zeros_like(uf) if g_out is None else g_out.float())
        if z is not None:
            zf = z.float()
            sig_z = torch.sigmoid(zf)
            gyD = g * zf * sig_z  # cotangent of y + u D
        else:
            gyD = g
        dD = (gyD * uf).sum((0, 1)) if D is not None else None
        du_p = _pad(gyD * D.float() if D is not None else torch.zeros_like(uf),
                    L_pad)
        dd_p = uf.new_empty((batch, L_pad, d))
        y_all = torch.empty_like(uf) if z is not None else None
        dtu = _pad(dt * uf, L_pad)
        dtp, uf_p, gy_p = _pad(dt, L_pad), _pad(uf, L_pad), _pad(gyD, L_pad)
        Bf, Cf = _pad(f32(B), L_pad), _pad(f32(C), L_pad)
        Ag = f32(A).reshape(G, H, N)
        dB = carries.new_empty((batch, L_pad, G, N))
        dC = torch.empty_like(dB)
        dA = torch.zeros_like(Ag)
        # the JAX convention's cotangent of the final state
        gx = (torch.zeros_like(carries[:, 0]) if g_last is None
              else g_last.to(carries.dtype).reshape(batch, G, H, N))
        if cplx and g_last is not None:
            gx = gx.conj_physical()
        tap = 2.0 if cplx else 1.0
        for k in reversed(range(nc)):
            s = slice(k * cl, (k + 1) * cl)
            dc, uc = dtp[:, s].reshape(batch, cl, G, H), uf_p[:, s]
            Bc, Cc = Bf[:, s], Cf[:, s]
            la, b = _ChunkedScan._terms(dtp[:, s], dtu[:, s], Ag, Bc, cl)
            xs = _chunk_states(la, b, carries[:, k])
            if y_all is not None:  # for dz
                y = _ChunkedScan._y(xs, Cc, cplx).reshape(batch, cl, d)
                y_all[:, s.start:min(s.stop, L)] = y[:, :min(cl, L - s.start)]
            dy = gy_p[:, s].reshape(batch, cl, G, H).to(xs.dtype)
            dC[:, s] = tap * torch.einsum("blgh,blghn->blgn", dy, xs)
            dx = tap * dy[..., None] * Cc.to(xs.dtype)[:, :, :, None, :]
            gs = _chunk_adjoint(la, dx, gx)
            dla = gs * (xs - b)  # d loss / d la, as gs * a * x_{t-1}
            gB = torch.einsum("blghn,blgn->blgh", gs, Bc.to(gs.dtype))
            dd_A = torch.einsum("blghn,ghn->blgh", dla, Ag)
            if cplx:
                gB, dd_A = gB.real, dd_A.real
            dd_p[:, s] = (dd_A + gB * uc.reshape(batch, cl, G, H)).reshape(
                batch, cl, d)
            du_p[:, s] += (dc * gB).reshape(batch, cl, d)
            dB[:, s] = torch.einsum("blghn,blgh->blgn", gs,
                                    (dc * uc.reshape(batch, cl, G, H))
                                    .to(gs.dtype))
            dA += torch.einsum("blghn,blgh->ghn", dla, dc.to(dla.dtype))
            gx = torch.exp(la[:, 0]) * gs[:, 0]
        dd = dd_p[:, :L] * sig
        du = du_p[:, :L]
        dz = None
        if z is not None:
            out_pre = y_all + uf * D.float() if D is not None else y_all
            dz = (g * out_pre * (sig_z * (1 + zf * (1 - sig_z)))).to(z.dtype)
        dbias = dd.sum((0, 1)) if delta_bias is not None else None
        grads = []
        for leaf, grad in ((A, dA.reshape(d, N)), (B, dB[:, :L]),
                           (C, dC[:, :L])):
            if leaf.is_complex():
                grads.append(grad.conj_physical().to(leaf.dtype))
            else:
                grads.append((grad.real if grad.is_complex() else grad)
                             .to(leaf.dtype))
        return (du.to(u.dtype), dd.to(delta.dtype), *grads,
                None if dD is None else dD.to(D.dtype), dz,
                None if dbias is None else dbias.to(delta_bias.dtype),
                None, None)


def selective_scan_chunked(u, delta, A, B, C,
                           D: Optional[torch.Tensor] = None,
                           z: Optional[torch.Tensor] = None,
                           delta_bias: Optional[torch.Tensor] = None,
                           delta_softplus: bool = False,
                           return_last_state: bool = False,
                           chunk: int = 128):
    """The chunked backend (``backend="chunked"``): u, delta (batch, L, d);
    A (d, N) real or complex; B, C (batch, L, N) or (batch, L, G, N), real
    or (with complex A) complex, of mixed rank too (a 3-D one serves every
    group).  Returns out (batch, L, d) in u's dtype and, with
    ``return_last_state``, the final state (batch, d, N) (complex64 with
    complex A); both differentiable.  Counts its calls in
    ``selective_scan_chunked.calls``."""
    check_complex(A, B, C)
    if B.dim() not in (3, 4) or C.dim() not in (3, 4):
        raise ValueError("chunked backend requires variable B/C of shape "
                         "(B, L, N) or grouped (B, L, G, N)")
    selective_scan_chunked.calls += 1
    G = max(M.shape[2] if M.dim() == 4 else 1 for M in (B, C))
    if u.shape[2] % G:
        raise ValueError(f"d_inner {u.shape[2]} not divisible by {G} B/C "
                         f"groups")
    B4, C4 = (M.unsqueeze(2).expand(*M.shape[:2], G, M.shape[-1])
              if M.dim() == 3 else M for M in (B, C))
    out, x_last = _ChunkedScan.apply(u, delta, A, B4, C4, D, z, delta_bias,
                                     chunk, bool(delta_softplus))
    return (out, x_last) if return_last_state else out


selective_scan_chunked.calls = 0


def _expand_bc(M, d):
    """B / C broadcastable against (batch, L, d, N): static (d, N) ->
    (1, 1, d, N), (batch, L, N) -> (batch, L, 1, N), grouped (batch, L, G,
    N) -> (batch, L, d, N), each group over its d / G consecutive
    channels."""
    M = f32(M)
    if M.dim() == 2:
        return M[None, None]
    if M.dim() == 3:
        return M[:, :, None, :]
    if M.dim() == 4:
        return M.repeat_interleave(d // M.shape[2], dim=2)
    raise ValueError(f"bad B/C shape {tuple(M.shape)}")


def selective_scan_assoc(u, delta, A, B, C,
                         D: Optional[torch.Tensor] = None,
                         z: Optional[torch.Tensor] = None,
                         delta_bias: Optional[torch.Tensor] = None,
                         delta_softplus: bool = False,
                         return_last_state: bool = False):
    """The associative backend (``backend="assoc"``): the whole sequence's
    (batch, L, d, N) terms scanned at once by ``scan_pairs``, differentiated
    by torch autograd.  B, C static (d, N), variable or grouped, real or
    (with complex A) complex.  Returns out (batch, L, d) in u's dtype and,
    with ``return_last_state``, the final state (batch, d, N).  Counts its
    calls in ``selective_scan_assoc.calls``."""
    check_complex(A, B, C)
    selective_scan_assoc.calls += 1
    batch, L, d = u.shape
    for M in (B, C):
        if M.dim() == 4 and d % M.shape[2]:
            raise ValueError(f"d_inner {d} not divisible by {M.shape[2]} "
                             f"B/C groups")
    uf = u.float()
    dt, _ = delta_prep(delta, delta_bias, delta_softplus)
    Bv, Cv = _expand_bc(B, d), _expand_bc(C, d)
    la = dt[..., None] * f32(A)
    b = ((dt * uf)[..., None] * Bv).expand(la.shape)
    _, xs = scan_pairs(la, b)
    y = (xs * Cv).sum(-1)
    if A.is_complex():
        y = 2.0 * y.real
    out = skip_and_gate(y, u, D, z)
    return (out, xs[:, -1]) if return_last_state else out


selective_scan_assoc.calls = 0
