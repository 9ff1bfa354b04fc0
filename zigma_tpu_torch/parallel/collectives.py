"""Collectives that autograd differentiates, for tensor and sequence
parallelism over plain local tensors.

The scan kernels are ctypes launches that DTensor dispatch cannot see, so
the tensor-parallel mixers (``parallel/mesh.py``) and the sequence-parallel
scans (``parallel/seq_parallel.py``) run on local shards and place these
ops themselves.  The JAX package gets each of them from XLA's sharding
propagation.  Names follow Megatron-LM's:

- ``copy_to_group``: identity forward, all-reduce (sum) backward.  It goes
  where a replicated tensor enters sharded work (a column-parallel GEMM,
  the local channels of a scan), so that the replicated tensor gets its
  whole gradient, the sum of every rank's part.
- ``reduce_from_group``: all-reduce forward, identity backward.  It closes
  a row-parallel GEMM whose output is used the same way on every rank.
- ``reduce_both``: all-reduce both ways.  It goes where partial sums become
  a replicated tensor that only sharded work reads (``x_proj``'s output,
  whose B, C and dt feed each rank's own channels).
- ``gather_last``: all-gather along the last dim forward, this rank's
  slice backward (the gradient of a replicated result is whole on every
  rank); ``split_last`` is its dual.
- ``all_gather_stack``: the ranks' tensors stacked on a new first dim, whose
  backward sums every rank's cotangent of this rank's row (the sequence-
  parallel prefix exchange, where each rank's loss reads every row).

Every op takes the process group; with a group of one they change no
value.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

__all__ = ["copy_to_group", "reduce_from_group", "reduce_both",
           "gather_last", "split_last", "all_gather_stack",
           "row_parallel_linear"]


def _all_reduce(x, group):
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _gather_last(x, group):
    n = dist.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def _split_last(x, group):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return x.chunk(n, dim=-1)[r].contiguous()


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _split_last(g, ctx.group), None


class _SplitLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _split_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.group), None


class _AllGatherStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.group)
        return g[dist.get_rank(ctx.group)], None


def copy_to_group(x, group):
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    return _ReduceFromGroup.apply(x, group)


def reduce_both(x, group):
    return _ReduceBoth.apply(x, group)


def gather_last(x, group):
    return _GatherLast.apply(x, group)


def split_last(x, group):
    return _SplitLast.apply(x, group)


def all_gather_stack(x, group=None):
    """(n_ranks, *x.shape): every rank's x in rank order."""
    return _AllGatherStack.apply(x, group)


def row_parallel_linear(layer, x, dtype, group):
    """A row-parallel ``nn.Linear`` in ``dtype``: this rank's slice of the
    input features against its columns of the weight, the partial products
    summed over ``group``, the (replicated) bias added once after the
    sum."""
    out = reduce_from_group(F.linear(x.to(dtype), layer.weight.to(dtype)),
                            group)
    return out if layer.bias is None else out + layer.bias.to(dtype)
