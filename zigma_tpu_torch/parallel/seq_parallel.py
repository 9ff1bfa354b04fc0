"""Sequence-parallel selective scan and SSD: the L axis sharded over ranks.

Counterpart of ``zigma_tpu/parallel/seq_parallel.py``.  The scan's combine
``(a1, b1) o (a2, b2) = (a1 a2, a2 b1 + b2)`` is associative, so each rank
scans its own tokens in two passes:

1. pass 1 scans the shard from a zero state and keeps its final state
   ``x_s`` (``core_full``: K1 returning the final state, K2 seeded by its
   cotangent) and its decay in the log domain, ``log_a = sum_t dt_t A``;
2. every rank's ``(log_a, x_s)`` is gathered (``all_gather_stack``, whose
   backward sums every rank's cotangent), and ``prefix_states`` gives each
   shard its incoming state ``x_in = sum_{r<s} exp(sum_{r<q<s} log_a_q)
   x_r``;
3. pass 2 scans the shard again seeded with ``x_in`` (``core_x0``, or K1
   with the fused gate and a seed; K2 returns ``dx0``), which gives the
   exact outputs.

u, delta, B, C and z are sharded on L; A, D and the bias are replicated, and
their gradients are each rank's part (sum them over the ranks, as data
parallelism does).  ``selective_scan_sharded`` / ``ssd_scan_sharded`` run
the same passes over virtual shards in one process, the stack in place of
the gather: one card shows the kernels on both passes that way, and the
tests hold the prefix algebra without processes.

The mask sits inside the exponent (``-1e30`` where r >= s): an ``exp`` of
the unused branch would overflow, and ``torch.where``'s gradient would turn
the inf into NaN.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from zigma_tpu_torch.ops.selective_scan import (scan_with_grad,
                                                skip_and_gate, _use_ref,
                                                core_full, core_x0)
from zigma_tpu_torch.ops.ssd import ssd_scan
from zigma_tpu_torch.parallel.collectives import all_gather_stack

__all__ = ["prefix_states", "selective_scan_seq_parallel",
           "selective_scan_sharded", "ssd_seq_parallel", "ssd_scan_sharded"]


def prefix_states(log_as, xs):
    """Every shard's incoming state from the stacked shard aggregates.

    log_as (S, ...) shard decays in the log domain, broadcastable against
    xs (S, ...) the shards' final states from a zero seed.  Returns (S, ...)
    like xs: row s is ``sum_{r<s} exp(sum_{r<q<s} log_a_q) x_r`` (row 0 is
    zeros)."""
    S = xs.shape[0]
    cum = torch.cumsum(log_as, 0)
    upto = torch.cat([torch.zeros_like(cum[:1]), cum[:-1]])  # sum_{q<s}
    lower = torch.ones((S, S), dtype=torch.bool, device=xs.device).tril(-1)
    lower = lower.reshape(S, S, *([1] * (log_as.dim() - 1)))
    log_decay = torch.where(lower, upto[:, None] - cum[None], -1e30)
    return (torch.exp(log_decay) * xs[None]).sum(1)


def _dt(delta, bias, softplus, dtype):
    dt = delta.to(dtype)
    if bias is not None:
        dt = dt + bias.to(dtype)
    return F.softplus(dt) if softplus else dt


def _scan_pass1(u, delta, A, B, C, delta_bias, delta_softplus, backend):
    """(log_a, x_last), both (batch, N, d) fp32, of one shard from a zero
    seed."""
    _, x_last = core_full(u, delta, A, B, C, delta_bias, None,
                          delta_softplus, backend)
    sum_dt = _dt(delta, delta_bias, delta_softplus, torch.float32).sum(1)
    return sum_dt[:, None, :] * A.float().t()[None], x_last


def _scan_pass2(u, delta, A, B, C, D, z, delta_bias, x_in, delta_softplus,
                backend):
    """The shard's outputs seeded with its incoming state; the gate is fused
    into the kernel where D and z come together."""
    use_ref = _use_ref(u, backend)
    if D is not None and z is not None:
        return scan_with_grad(u, delta, A, B, C, delta_bias, D, z,
                              delta_softplus, use_ref, x_in)
    y = core_x0(u, delta, A, B, C, delta_bias, x_in, delta_softplus, backend)
    return skip_and_gate(y, u, D, z)


def selective_scan_seq_parallel(u, delta, A, B, C, D=None, z=None,
                                delta_bias=None, delta_softplus: bool = False,
                                group=None, backend: str = "auto"):
    """The selective scan with L sharded over ``group`` (default: the
    world).  Per-rank shapes: u, delta, z (batch, L_s, d); B, C (batch, L_s,
    N); ranks hold consecutive pieces of L in rank order.  Returns this
    rank's (batch, L_s, d) slice of the output in u's dtype."""
    log_a, x_last = _scan_pass1(u, delta, A, B, C, delta_bias,
                                delta_softplus, backend)
    agg = all_gather_stack(torch.stack([log_a, x_last]), group)
    x_in = prefix_states(agg[:, 0], agg[:, 1])[dist.get_rank(group)]
    return _scan_pass2(u, delta, A, B, C, D, z, delta_bias, x_in,
                       delta_softplus, backend)


def _shards(n_shards, L, *tensors):
    if n_shards < 1 or L % n_shards:
        raise ValueError(f"L={L} does not split into {n_shards} equal shards")
    # each shard its own contiguous tensor, as a rank holds it (the
    # kernels take evenly spaced tokens only)
    return [None if t is None
            else [c.contiguous() for c in t.chunk(n_shards, 1)]
            for t in tensors]


def selective_scan_sharded(u, delta, A, B, C, D=None, z=None,
                           delta_bias=None, delta_softplus: bool = False,
                           n_shards: int = 2, backend: str = "auto"):
    """``selective_scan_seq_parallel`` over ``n_shards`` virtual shards of
    L in one process: pass 1 on each, ``prefix_states`` on the stack, pass
    2 on each; returns the whole (batch, L, d) output."""
    us, ds, Bs, Cs, zs = _shards(n_shards, u.shape[1], u, delta, B, C, z)
    aggs = [_scan_pass1(us[s], ds[s], A, Bs[s], Cs[s], delta_bias,
                        delta_softplus, backend) for s in range(n_shards)]
    x_in = prefix_states(torch.stack([a for a, _ in aggs]),
                         torch.stack([x for _, x in aggs]))
    return torch.cat([
        _scan_pass2(us[s], ds[s], A, Bs[s], Cs[s], D,
                    None if zs is None else zs[s], delta_bias, x_in[s],
                    delta_softplus, backend)
        for s in range(n_shards)], dim=1)


def _ssd_pass1(x, dt, A, B, C, dt_bias, dt_softplus, chunk, backend):
    """(log_a (batch, H), the final (batch, H, P, N) state) of one shard
    from a zero seed, in the SSD's accumulation dtype."""
    _, s_last = ssd_scan(x, dt, A, B, C, dt_bias=dt_bias,
                         dt_softplus=dt_softplus, return_last_state=True,
                         backend=backend, chunk=chunk)
    acc = s_last.dtype
    return _dt(dt, dt_bias, dt_softplus, acc).sum(1) * A.to(acc), s_last


def ssd_seq_parallel(x, dt, A, B, C, D=None, z=None, dt_bias=None,
                     dt_softplus: bool = False, group=None, chunk: int = 128,
                     backend: str = "auto"):
    """The Mamba-2 SSD scan (``ops.ssd.ssd_scan``) with L sharded over
    ``group``: the same two passes, the decay a scalar per (batch, head).
    x (batch, L_s, H, P), dt (batch, L_s, H), B, C (batch, L_s, G, N), z
    like x; A, D and dt_bias replicated.  Returns this rank's slice of y."""
    log_a, s_last = _ssd_pass1(x, dt, A, B, C, dt_bias, dt_softplus, chunk,
                               backend)
    log_as = all_gather_stack(log_a, group)
    x_in = prefix_states(log_as[..., None, None],
                         all_gather_stack(s_last, group))
    return ssd_scan(x, dt, A, B, C, D=D, z=z, dt_bias=dt_bias,
                    dt_softplus=dt_softplus,
                    initial_state=x_in[dist.get_rank(group)],
                    backend=backend, chunk=chunk)


def ssd_scan_sharded(x, dt, A, B, C, D=None, z=None, dt_bias=None,
                     dt_softplus: bool = False, n_shards: int = 2,
                     chunk: int = 128, backend: str = "auto"):
    """``ssd_seq_parallel`` over ``n_shards`` virtual shards in one
    process; returns the whole (batch, L, H, P) output."""
    xs, dts, Bs, Cs, zs = _shards(n_shards, x.shape[1], x, dt, B, C, z)
    aggs = [_ssd_pass1(xs[s], dts[s], A, Bs[s], Cs[s], dt_bias, dt_softplus,
                       chunk, backend) for s in range(n_shards)]
    x_in = prefix_states(torch.stack([a for a, _ in aggs])[..., None, None],
                         torch.stack([st for _, st in aggs]))
    return torch.cat([
        ssd_scan(xs[s], dts[s], A, Bs[s], Cs[s], D=D,
                 z=None if zs is None else zs[s], dt_bias=dt_bias,
                 dt_softplus=dt_softplus, initial_state=x_in[s],
                 backend=backend, chunk=chunk)
        for s in range(n_shards)], dim=1)
