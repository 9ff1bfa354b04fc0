"""Pipeline parallelism for the ZigMa block stack: a weight-stationary GPipe
over the ``pipe`` process group.

Counterpart of ``zigma_tpu/parallel/pipeline.py`` (``pipeline_blocks``,
``zigma_pipelined_apply``), where one ``shard_map`` ticks microbatches
around a ``ppermute`` ring.  Here each process is one stage:

- ``split_stage`` keeps a stage's contiguous blocks under their
  one-process names (``blocks.{i}`` in an ``nn.ModuleDict``, each with its
  own scan-path buffers), the embedders on the first stage and ``norm_f``
  with the final layer on the last.  No parameter lives on two stages, so
  there is nothing to sum over ``pipe``; the stack needs ``depth %
  stages == 0`` (the port has no scan over layers to stack).
- ``zigma_pipelined_apply`` runs the model's seams (``ZigMa.embed``,
  ``run_blocks``, ``head``): the first stage embeds the batch, each stage
  runs its blocks on every microbatch in turn and hands (h, residual, c,
  text) to the next by ``send`` / ``recv``, the last stage applies the
  head, and its output is broadcast over ``pipe``, as JAX's masked
  ``psum`` replicates it.
- The hand-offs are autograd functions: a ``recv``'s backward sends the
  gradients of what it received back, a ``send``'s backward receives them.
  One ``loss.backward()`` on every stage then runs the GPipe backward: the
  autograd engine takes the ready node created last first, so every stage
  walks the microbatches from the last to the first and the sends meet
  their receives.  On the stages before the last the returned output is
  the broadcast value plus a zero that leads into the sends, so the loss
  has its true value on every stage and its gradient reaches them.
- ``pipeline_parallelize`` places a training state: the stage of this
  rank, wrapped in DDP over ``data`` (FSDP2 and tensor parallelism are
  refused with the pipeline); ``PipelineLayout`` gathers checkpoints to
  the one-process layout and the EMA to a full model for vis and eval.

Per-block remat, and a ``remat_policy``, apply inside a stage as in one
process.  JAX's refusals stay: per-layer PEs (use_pe 3), stochastic depth
in training, a depth the stages do not divide and a batch the microbatches
do not divide.  The label drop is drawn for the whole batch on every stage
(the stages keep one generator state) and forced on the first.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from zigma_tpu_torch.parallel.mesh import ParallelLayout

__all__ = ["check_pipelinable", "split_stage", "pipeline_blocks",
           "zigma_pipelined_apply", "PipelinedZigMa", "PipelineLayout",
           "pipeline_parallelize"]

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
_META = 4 * 6  # (present, dtype, ndim, 3 dims) for h, residual, c, text


def check_pipelinable(model, n_stages: int, train: bool = False):
    """The JAX refusals (``zigma_pipelined_apply``): ValueError for
    per-layer PEs, stochastic depth in training and a depth the stages do
    not divide."""
    if model.use_pe == 3:
        raise ValueError("use_pe=3 (per-layer PEs) is not supported under "
                         "pipeline parallelism")
    if train and model.drop_path_rate > 0:
        raise ValueError("stochastic depth is not supported under pipeline "
                         "parallelism; set drop_path_rate=0")
    if model.depth % n_stages:
        raise ValueError(f"depth {model.depth} not divisible by pipeline "
                         f"stages {n_stages}")


def split_stage(model, stage: int, n_stages: int):
    """Cut ``model`` (a ZigMa) in place down to pipeline stage ``stage`` of
    ``n_stages``: its ``depth / n_stages`` contiguous blocks under their
    names, the embedders and position tables on stage 0, ``norm_f`` and
    the final layer on the last.  Returns the model."""
    check_pipelinable(model, n_stages)
    per = model.depth // n_stages
    lo = stage * per
    model.blocks = nn.ModuleDict(
        {str(i): model.blocks[i] for i in range(lo, lo + per)})
    if stage > 0:
        for name in ("x_embedder", "t_embedder", "y_embedder", "pos_embed",
                     "pe_table", "temporal_pos_embedding"):
            if hasattr(model, name):
                delattr(model, name)
    if stage < n_stages - 1:
        del model.norm_f, model.final_layer
    model.stage, model.n_stages = stage, n_stages
    return model


def _meta(tensors, device) -> torch.Tensor:
    meta = torch.zeros(_META, dtype=torch.int64)
    for j, t in enumerate(tensors):
        if t is not None:
            meta[6 * j:6 * j + 3 + t.dim()] = torch.tensor(
                [1, _DTYPES.index(t.dtype), t.dim(), *t.shape])
    return meta.to(device)


def _specs(meta: torch.Tensor) -> list:
    """``(shape, dtype)`` or None for each of h, residual, c, text."""
    out = []
    for j in range(4):
        present, code, nd, *dims = meta[6 * j:6 * j + 6].tolist()
        out.append((tuple(dims[:nd]), _DTYPES[code]) if present else None)
    return out


class _Recv(torch.autograd.Function):
    """Receive the present tensors of ``specs`` from global rank ``src``;
    the backward sends their gradients back (zeros where none arrived)."""

    @staticmethod
    def forward(ctx, anchor, src, group, specs):
        ctx.src, ctx.group = src, group
        outs = []
        for shape, dtype in specs:
            t = torch.empty(shape, dtype=dtype, device=anchor.device)
            dist.recv(t, src=src, group=group)
            outs.append(t)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        for g in grads:
            dist.send(g.contiguous(), dst=ctx.src, group=ctx.group)
        return None, None, None, None


class _Send(torch.autograd.Function):
    """Send ``tensors`` to global rank ``dst``; returns a zero scalar whose
    backward receives their gradients from ``dst``."""

    @staticmethod
    def forward(ctx, dst, group, *tensors):
        ctx.dst, ctx.group = dst, group
        ctx.specs = [(t.shape, t.dtype, t.device) for t in tensors]
        for t in tensors:
            dist.send(t.contiguous(), dst=dst, group=group)
        return torch.zeros((), device=tensors[0].device)

    @staticmethod
    def backward(ctx, _):
        grads = []
        for shape, dtype, device in ctx.specs:
            g = torch.empty(shape, dtype=dtype, device=device)
            dist.recv(g, src=ctx.dst, group=ctx.group)
            grads.append(g)
        return (None, None, *grads)


def _chunks(t, M):
    return [None] * M if t is None else list(t.chunk(M))


def pipeline_blocks(model, h, res, c, text, *, group,
                    n_microbatches: Optional[int] = None):
    """Run the block stack of a ``split_stage`` model as a GPipe over
    ``group`` (this process is stage ``rank in group``).

    On the first stage h (B, L, D), res (None or like h), c (B, D) and text
    (None or (B, S, D)) are the stack's inputs for the whole batch, split
    into ``n_microbatches`` (default: one per stage); the other stages
    ignore them and receive each microbatch from the stage before.  Returns
    ``(h, res, trigger)``: on the last stage the stack's outputs for the
    whole batch and None; before it None, None and a zero scalar whose
    backward drives this stage's part of the backward.
    """
    S, s = dist.get_world_size(group), dist.get_rank(group)
    M = int(n_microbatches) if n_microbatches else S
    device = next(model.parameters()).device
    if s == 0:
        if h.shape[0] % M:
            raise ValueError(f"batch {h.shape[0]} not divisible by "
                             f"n_microbatches {M}")
        ins = list(zip(*(_chunks(a, M) for a in (h, res, c, text))))
    else:
        src = dist.get_global_rank(group, s - 1)
        meta = torch.empty(_META, dtype=torch.int64, device=device)
        dist.recv(meta, src=src, group=group)
        specs = _specs(meta)
        anchor = torch.zeros((), device=device,
                             requires_grad=torch.is_grad_enabled())
    dst = dist.get_global_rank(group, s + 1) if s < S - 1 else None
    outs, trigs = [], []
    for m in range(M):
        if s > 0:
            got = iter(_Recv.apply(anchor, src, group,
                                   [sp for sp in specs if sp is not None]))
            ins_m = [None if sp is None else next(got) for sp in specs]
        else:
            ins_m = ins[m]
        hm, rm = model.run_blocks(ins_m[0], ins_m[1], ins_m[2], ins_m[3])
        if dst is None:
            outs.append((hm, rm))
            continue
        hand = (hm, rm, ins_m[2], ins_m[3])
        if m == 0:
            dist.send(_meta(hand, device), dst=dst, group=group)
        trigs.append(_Send.apply(dst, group,
                                 *[t for t in hand if t is not None]))
    if dst is not None:
        return None, None, torch.stack(trigs).sum()
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]),
            None)


def zigma_pipelined_apply(model, x, t, y=None, *, group,
                          n_microbatches: Optional[int] = None,
                          train: bool = False,
                          generator: Optional[torch.Generator] = None):
    """The ZigMa forward of a ``split_stage`` model over the ``pipe`` group
    ``group``, with ``ZigMa.forward``'s arguments: ``embed`` on the first
    stage, ``pipeline_blocks``, ``head`` on the last, the output broadcast
    to every stage.  Numerically the one-process forward (per-sample
    math), microbatch by microbatch.  Every stage calls it with the same
    inputs; under autograd ``loss.backward()`` on every stage gives each
    stage's parameters their gradients."""
    check_pipelinable(model, dist.get_world_size(group), train)
    S, s = dist.get_world_size(group), dist.get_rank(group)
    M = int(n_microbatches) if n_microbatches else S
    if x.shape[0] % M:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"n_microbatches {M}")
    drop_ids = None
    if (train and model.num_classes > 0 and not model.has_text
            and model.class_dropout_prob > 0):
        # LabelEmbedder's own draw, on every stage
        drop_ids = (torch.rand(y.shape, generator=generator, device=y.device)
                    < model.class_dropout_prob).long()
    h = c = text = None
    if s == 0:
        h, c, text = model.embed(x, t, y, train, generator, drop_ids)
    h, res, trigger = pipeline_blocks(model, h, None, c, text, group=group,
                                      n_microbatches=M)
    if trigger is None:
        out = model.head(h, res)
        if S > 1:
            dist.broadcast(out.detach().contiguous(),
                           src=dist.get_global_rank(group, S - 1),
                           group=group)
        return out
    out = torch.empty(x.shape, dtype=model.dtype, device=x.device)
    dist.broadcast(out, src=dist.get_global_rank(group, S - 1), group=group)
    return out + trigger.to(out.dtype)


class PipelinedZigMa(nn.Module):
    """A stage module called as the model (``forward(x, t, y, train,
    generator)``): ``zigma_pipelined_apply`` over ``group``.  What the
    loss calls, and what DDP wraps."""

    def __init__(self, stage, group, n_microbatches: Optional[int] = None):
        super().__init__()
        self.stage, self.group = stage, group
        self.n_microbatches = n_microbatches

    def forward(self, x, t, y=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        return zigma_pipelined_apply(self.stage, x, t, y, group=self.group,
                                     n_microbatches=self.n_microbatches,
                                     train=train, generator=generator)


def _gather_over(obj, group) -> list:
    if dist.get_world_size(group) == 1:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


@dataclass
class PipelineLayout(ParallelLayout):
    """``ParallelLayout`` of a pipelined state: each rank holds its stage
    (``split_stage``) in DDP over ``data``.  ``state_keys`` and
    ``param_names`` are the one-process model's state-dict keys and
    parameter names, in order: the gathered checkpoint's layout."""

    state_keys: list = field(default_factory=list)
    param_names: list = field(default_factory=list)

    @property
    def pipe_group(self):
        return self.mesh["pipe"].get_group()

    def sync_replicated_grads(self):
        """Nothing to do: DDP averaged over ``data``, and no parameter
        lives on two stages."""

    @torch.no_grad()
    def clip_grad_norm_(self, named_params, max_norm: float):
        """The global gradient norm over every stage's parameters (each
        stage's squared norm summed over ``pipe``), clipped in place to
        ``max_norm`` when it is positive; ``clip_grad_norm_``'s arithmetic
        otherwise.  Returns the norm before clipping."""
        grads = [p.grad for _, p in named_params if p.grad is not None]
        local = torch.linalg.vector_norm(
            torch.stack(list(torch._foreach_norm(grads))))
        sq = local.square()
        if dist.get_world_size(self.pipe_group) > 1:
            dist.all_reduce(sq, group=self.pipe_group)
        total = sq.sqrt()
        if max_norm and max_norm > 0:
            coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
            torch._foreach_mul_(grads, coef)
        return total

    def gather_state(self, module: nn.Module) -> dict:
        """The one-process state dict from every stage's part (every rank
        calls)."""
        local = {k: v.detach() for k, v in module.state_dict().items()}
        if dist.get_world_size(self.pipe_group) > 1:
            local = {k: v.cpu() for k, v in local.items()}
        merged = {}
        for part in _gather_over(local, self.pipe_group):
            merged.update(part)
        if set(merged) != set(self.state_keys):
            raise RuntimeError("the stages' state dicts do not make up the "
                               "model's")
        return {k: merged[k] for k in self.state_keys}

    @torch.no_grad()
    def load_state(self, module: nn.Module, full: dict):
        """Load this stage's part of a one-process state dict; the names
        must be the model's exactly."""
        if set(full) != set(self.state_keys):
            raise RuntimeError(
                f"state dict mismatch: missing "
                f"{sorted(set(self.state_keys) - set(full))}, unexpected "
                f"{sorted(set(full) - set(self.state_keys))}")
        own = module.state_dict()
        module.load_state_dict({k: full[k] for k in own}, strict=True)

    def gather_optimizer(self, opt, model: nn.Module) -> dict:
        """``opt.state_dict()`` as a one-process optimizer over the whole
        model's parameters keys it (every rank calls)."""
        osd = opt.state_dict()
        names = [n for n, _ in model.named_parameters()]
        to_model = self._model_index(opt, model)
        multi = dist.get_world_size(self.pipe_group) > 1
        local = {}
        for idx, st in osd["state"].items():
            local[self.param_names.index(names[to_model[idx]])] = {
                k: v.cpu() if multi and torch.is_tensor(v) else v
                for k, v in st.items()}
        state = {}
        for part in _gather_over(local, self.pipe_group):
            state.update(part)
        group = {k: v for k, v in osd["param_groups"][0].items()
                 if k != "params"}
        return {"state": dict(sorted(state.items())),
                "param_groups": [{**group, "params": list(
                    range(len(self.param_names)))}]}

    def load_optimizer(self, opt, model: nn.Module, full: dict):
        """Load this stage's entries of ``gather_optimizer``'s dict."""
        names = [n for n, _ in model.named_parameters()]
        to_opt = {m: i for i, m in enumerate(self._model_index(opt, model))}
        state = {}
        for j, name in enumerate(names):
            st = full["state"].get(self.param_names.index(name))
            if st is not None:
                state[to_opt[j]] = st
        (group,) = [{k: v for k, v in g.items() if k != "params"}
                    for g in full["param_groups"]]
        opt.load_state_dict({"state": state, "param_groups": [
            {**group, "params": list(range(len(names)))}]})


def pipeline_parallelize(model, ema, mesh,
                         n_microbatches: Optional[int] = None
                         ) -> PipelineLayout:
    """Place ``model`` and its EMA copy (whole ZigMas, built alike, before
    any optimizer) on a ``("data", "model", "pipe")`` mesh: both cut to
    this rank's stage (``split_stage``), the model called through
    ``PipelinedZigMa`` in DDP over ``data``."""
    if mesh["model"].size() > 1:
        raise ValueError("parallel.tp and parallel.pp cannot be combined")
    group = mesh["pipe"].get_group()
    S, s = dist.get_world_size(group), dist.get_rank(group)
    check_pipelinable(model, S)
    keys = list(model.state_dict())
    names = [n for n, _ in model.named_parameters()]
    split_stage(model, s, S)
    split_stage(ema, s, S)
    from torch.nn.parallel import DistributedDataParallel as DDP

    dev = next(model.parameters()).device
    ddp = DDP(PipelinedZigMa(model, group, n_microbatches),
              device_ids=[dev] if dev.type == "cuda" else None,
              process_group=mesh["data"].get_group(),
              gradient_as_bucket_view=True, broadcast_buffers=False)
    return PipelineLayout(mesh, {}, False, ddp, state_keys=keys,
                          param_names=names)
