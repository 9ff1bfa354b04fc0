"""Process groups, the device mesh, data parallelism, FSDP2 and tensor
parallelism for the port.

Counterpart of ``zigma_tpu/parallel/mesh.py``.  The reference's only
parallelism is DDP over NCCL through HF Accelerate (train_acc.py:121-123,
249); the JAX package adds FSDP (ZeRO-3) and a tensor-parallel ``model``
axis.  Here:

- ``make_mesh(data, model, pipe)`` is ``init_device_mesh`` with the JAX
  axis names ``("data", "model")``, and ``("data", "model", "pipe")``
  with pipe innermost when ``pipe`` is given (the pipeline,
  ``parallel/pipeline.py``).  ``data_rank(mesh)`` is this process's rank
  and the size of its ``data`` group.
- Each data rank draws its own batch: the global batch is ``data ranks x
  data.batch_size``, the JAX and DDP semantics.  Shards, seeds and draws
  follow the data rank, so the ranks of one model or pipe group read the
  same batch; ``shard_batch`` broadcasts it from each group's first rank
  all the same, and ``same_in_group`` does so for any object (the vis and
  eval batches).
- ``parallelize`` places a model and its EMA copy: tensor parallelism over
  the ``model`` axis first (``apply_tensor_parallel``), then DDP
  (``gradient_as_bucket_view``) or, with ``fsdp``, FSDP2 (``fully_shard`` on
  each ``blocks.{i}``, then on the root) over the ``data`` axis only.
  Parameters below ``fsdp_min_size`` elements are FSDP2's
  ``ignored_params``: whole on every rank, their gradients averaged here
  (``ParallelLayout.sync_replicated_grads``) as DDP averages them.
- Tensor parallelism is Megatron-style on plain local shards with the
  collectives of ``parallel/collectives.py``: the scan kernels are ctypes
  launches that DTensor cannot see, so they get d_inner / tp channels as
  ordinary tensors.  The rules (``tp_rules``) are the JAX ``_TP_RULES``
  over the reference names: each Mamba-1 mixer's ``in_proj`` column-
  parallel, with this rank's rows of both halves ``[x; z]`` (a contiguous
  shard would give one rank all of x and the other all of z); every
  branch's conv, ``dt_proj``, ``A_log`` and ``D`` split on d_inner and
  ``x_proj`` row-parallel; ``out_proj`` row-parallel.  A Mamba-2 mixer
  splits ``in_proj``'s outputs (gathered whole after the GEMM) and
  ``out_proj``'s inputs, and keeps the SSD's parameters whole, as the JAX
  rules do.  Cross-attention splits its heads (``to_q`` / ``to_k`` /
  ``to_v`` by rows, ``to_out.0`` row-parallel).
- Checkpoints stay in the reference layout whatever the placement: the
  ``ParallelLayout`` gathers full tensors (FSDP2's ``full_tensor``, then
  ``tp_unshard``) and loads them back (this rank's rows), for the
  optimizer's moments too, under ``Optimizer.state_dict``'s integer keys.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["init_process_group", "make_mesh", "data_rank", "shard_batch",
           "same_in_group", "replicate", "tp_rules", "tp_shard", "tp_unshard",
           "apply_tensor_parallel", "ParallelLayout", "parallelize"]


def init_process_group(device: torch.device, launched: bool) -> bool:
    """Join or start the process group; True when this call started it.

    launched: the launcher's standard variables (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) give the rendezvous (``env://``);
    otherwise a group of this one process (an in-memory store).  The
    backend is NCCL on CUDA and gloo on the CPU.  A group the caller
    initialised already is used as it is."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    kw = dict(device_id=device) if device.type == "cuda" else {}
    if launched:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    return True


def make_mesh(data: int = -1, model: int = 1, pipe: Optional[int] = None,
              device_type: Optional[str] = None):
    """A ``("data", "model")`` device mesh over the process group's ranks
    (rank = data_index * model + model_index), or with ``pipe`` (one
    included) ``("data", "model", "pipe")``, pipe innermost (rank =
    (data_index * model + model_index) * pipe + pipe_index); ``data=-1``
    takes the ranks the other axes leave."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group "
                           "(init_process_group)")
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    inner = model * (pipe or 1)
    if data == -1:
        if model < 1 or (pipe or 1) < 1 or n % inner:
            raise ValueError(f"{n} processes do not split into model={model}"
                             f" x pipe={pipe or 1}")
        data = n // inner
    if data * inner != n:
        raise ValueError(f"mesh {data}x{model}x{pipe or 1} != {n} processes")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if pipe is None:
        return init_device_mesh(device_type, (data, model),
                                mesh_dim_names=("data", "model"))
    return init_device_mesh(device_type, (data, model, pipe),
                            mesh_dim_names=("data", "model", "pipe"))


def data_rank(mesh=None) -> tuple:
    """``(rank, size)`` of this process in ``mesh``'s ``data`` group: what
    shards and seeds follow.  Without a mesh every process of the process
    group is a data rank, and without a process group this one is ``(0,
    1)``."""
    if mesh is not None:
        return mesh["data"].get_local_rank(), mesh["data"].size()
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _inner_groups(mesh) -> list:
    """The model and pipe groups of ``mesh`` with more than one rank."""
    return [mesh[d].get_group() for d in mesh.mesh_dim_names
            if d != "data" and mesh[d].size() > 1]


def shard_batch(batch: dict, mesh) -> dict:
    """This process's part of the global batch: its own, which the ranks of
    one model (or pipe) group share; they take their first rank's all the
    same (in place, by broadcast)."""
    for group in _inner_groups(mesh):
        src = dist.get_global_rank(group, 0)
        for v in batch.values():
            dist.broadcast(v, src=src, group=group)
    return batch


def same_in_group(obj, mesh):
    """``obj`` as the first rank of this process's model (and pipe) group
    has it, on every rank of the group (pickled, so numpy batches of any
    size pass)."""
    if mesh is None:
        return obj
    for group in _inner_groups(mesh):
        box = [obj]
        dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                                   group=group)
        obj = box[0]
    return obj


@torch.no_grad()
def replicate(module: nn.Module, group=None) -> nn.Module:
    """Every parameter and buffer broadcast from the group's first rank."""
    src = 0 if group is None else dist.get_global_rank(group, 0)
    for t in (*module.parameters(), *module.buffers()):
        dist.broadcast(t.data, src=src, group=group)
    return module


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

# (regex over a parameter's name inside its module, (dim, parts)): split
# ``dim`` into ``parts`` equal blocks and take this rank's 1/tp of each
_MAMBA_RULES = [
    (r"in_proj\.(weight|bias)", (0, 2)),
    (r"out_proj\.weight", (1, 1)),
    (r"conv1d(_b)?(_list\.\d+)?\.(weight|bias)", (0, 1)),
    (r"x_proj(_b)?(_list\.\d+)?\.weight", (1, 1)),
    (r"dt_proj(_b)?(_list\.\d+)?\.(weight|bias)", (0, 1)),
    (r"A(_b)?_log(_list\.\d+)?", (0, 1)),
    (r"D(_b)?(_list\.\d+)?", (0, 1)),
]
_MAMBA2_RULES = [(r"in_proj\.(weight|bias)", (0, 1)),
                 (r"out_proj\.weight", (1, 1))]
_ATTN_RULES = [(r"to_[qkv]\.weight", (0, 1)), (r"to_out\.0\.weight", (1, 1))]


def _module_rules(m):
    from zigma_tpu_torch.models.mamba import Mamba
    from zigma_tpu_torch.models.mamba2 import Mamba2
    from zigma_tpu_torch.models.zigma import CrossAttention

    for cls, rules in ((Mamba, _MAMBA_RULES), (Mamba2, _MAMBA2_RULES),
                       (CrossAttention, _ATTN_RULES)):
        if isinstance(m, cls):
            return rules
    return None


def tp_rules(model: nn.Module) -> dict:
    """``{parameter name: (dim, parts)}`` for every parameter tensor
    parallelism splits; the rest stays whole on every rank."""
    out = {}
    for mname, m in model.named_modules():
        rules = _module_rules(m)
        if rules is None:
            continue
        for pname, _ in m.named_parameters():
            for pattern, spec in rules:
                if re.fullmatch(pattern, pname):
                    out[f"{mname}.{pname}" if mname else pname] = spec
                    break
    return out


def _slice(t, dim, parts, rank, tp):
    if t.shape[dim] % (parts * tp):
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"into {parts} x tp={tp}")
    return torch.cat([b.chunk(tp, dim)[rank] for b in t.chunk(parts, dim)],
                     dim)


def tp_shard(state: dict, rules: dict, rank: int, tp: int) -> dict:
    """This rank's slices of a full state dict (the rest unchanged)."""
    return {k: _slice(v, *rules[k], rank, tp) if k in rules else v
            for k, v in state.items()}


def tp_unshard(state: dict, rules: dict, group) -> dict:
    """The full tensors of every rank's ``tp_shard`` slices, gathered over
    ``group`` (every rank calls, in the same key order)."""
    tp = dist.get_world_size(group)
    out = dict(state)
    for k, v in state.items():
        if k not in rules:
            continue
        dim, parts = rules[k]
        pieces = [torch.empty_like(v) for _ in range(tp)]
        dist.all_gather(pieces, v.contiguous(), group=group)
        blocks = [p.chunk(parts, dim) for p in pieces]
        out[k] = torch.cat([blocks[r][j] for j in range(parts)
                            for r in range(tp)], dim)
    return out


def apply_tensor_parallel(model: nn.Module, group) -> dict:
    """Split ``model``'s mixers and cross-attention over ``group`` in place:
    each parameter of ``tp_rules`` keeps this rank's slice, and each such
    module learns its group.  Raises ValueError, before anything changes,
    when the group's size does not divide d_inner, the number of heads or
    a Mamba-2 ``in_proj``'s outputs.  Returns the rules."""
    from zigma_tpu_torch.models.mamba import Mamba
    from zigma_tpu_torch.models.mamba2 import Mamba2
    from zigma_tpu_torch.models.zigma import CrossAttention

    tp, rank = dist.get_world_size(group), dist.get_rank(group)
    for name, m in model.named_modules():
        sizes = ({"d_inner": m.d_inner} if isinstance(m, Mamba) else
                 {"d_inner": m.d_inner,
                  "in_proj outputs": m.in_proj.out_features}
                 if isinstance(m, Mamba2) else
                 {"heads": m.heads} if isinstance(m, CrossAttention) else {})
        for what, n in sizes.items():
            if n % tp:
                raise ValueError(f"parallel.tp={tp} does not divide {name}'s "
                                 f"{what} ({n})")
    rules = tp_rules(model)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for k, spec in rules.items():
            params[k].data = _slice(params[k].data, *spec, rank, tp).clone()
    for m in model.modules():
        if _module_rules(m) is not None:
            m.tp_group = group
            if isinstance(m, CrossAttention):
                m.heads //= tp
    return rules


# ---------------------------------------------------------------------------
# placement of a training state
# ---------------------------------------------------------------------------


def _local_shard(full, like):
    """This rank's local tensor of ``full`` under the DTensor ``like``'s
    placements (torch.chunk's split, as DTensor's ``Shard``)."""
    out = full
    for mesh_dim, pl in enumerate(like.placements):
        if pl.is_shard():
            n = like.device_mesh.size(mesh_dim)
            r = like.device_mesh.get_local_rank(mesh_dim)
            chunks = out.chunk(n, pl.dim)
            out = chunks[r] if r < len(chunks) else out.narrow(pl.dim, 0, 0)
    local = like.to_local()
    if out.shape != local.shape:
        raise RuntimeError(f"shard {tuple(out.shape)} != local "
                           f"{tuple(local.shape)}")
    return out


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


@dataclass
class ParallelLayout:
    """Where a training state's tensors live across the processes.

    mesh: the ``("data", "model")`` device mesh; tp_rules: the tensor-
    parallel split of each parameter name (empty without tensor
    parallelism); fsdp: parameters and EMA sharded by FSDP2 over ``data``;
    module: what the loss calls (the DDP wrapper, or the model itself under
    FSDP2); replicated: the parameters FSDP2 leaves whole
    (``fsdp_min_size``), whose gradients ``sync_replicated_grads``
    averages."""

    mesh: object
    tp_rules: dict
    fsdp: bool
    module: nn.Module
    replicated: list = field(default_factory=list)

    @property
    def data_group(self):
        return self.mesh["data"].get_group()

    @property
    def tp_group(self):
        return self.mesh["model"].get_group()

    def sync_replicated_grads(self):
        """Average the gradients of ``replicated`` over ``data`` (one
        coalesced all-reduce)."""
        grads = [p.grad for p in self.replicated if p.grad is not None]
        n = dist.get_world_size(self.data_group)
        if not grads or n == 1:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.data_group)
        flat /= n
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))

    @torch.no_grad()
    def clip_grad_norm_(self, named_params, max_norm: float):
        """The global gradient norm, clipped to ``max_norm`` in place when
        it is positive: each parameter's squares summed over the ranks its
        gradient is split over (``data`` for FSDP2's shards, ``model`` for
        the tensor-parallel rules) and each whole one counted once.  The
        arithmetic is ``clip_grad_norm_``'s (per-tensor norms, the norm of
        their stack, ``max_norm / (norm + 1e-6)`` clamped at 1), so with
        one process it gives its bits.  Returns the norm before clipping,
        a plain 0-dim tensor."""
        named = [(n, p.grad) for n, p in named_params if p.grad is not None]
        names = [n for n, _ in named]
        is_shard = [_is_dtensor(g) for _, g in named]
        grads = [g.to_local() if s else g for (_, g), s in zip(named, is_shard)]
        norms = list(torch._foreach_norm(grads))
        for group, idx in (
                (self.data_group, [i for i, s in enumerate(is_shard) if s]),
                (self.tp_group, [i for i, n in enumerate(names)
                                 if n in self.tp_rules])):
            if idx:
                sq = torch.stack([norms[i] for i in idx]) ** 2
                dist.all_reduce(sq, group=group)
                for j, i in enumerate(idx):
                    norms[i] = sq[j].sqrt()
        total = torch.linalg.vector_norm(torch.stack(norms))
        if max_norm and max_norm > 0:
            coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
            torch._foreach_mul_(grads, coef)
        return total

    # -- full (reference-layout) state -------------------------------------

    def gather_state(self, module: nn.Module) -> dict:
        """``module``'s full state dict (every rank calls)."""
        sd = {k: v.full_tensor() if _is_dtensor(v) else v
              for k, v in module.state_dict().items()}
        return tp_unshard(sd, self.tp_rules, self.tp_group) if \
            self.tp_rules else sd

    @torch.no_grad()
    def load_state(self, module: nn.Module, full: dict):
        """Load a full state dict into ``module``'s local tensors; the
        names must match exactly."""
        own = module.state_dict()
        if set(own) != set(full):
            raise RuntimeError(
                f"state dict mismatch: missing {sorted(set(own) - set(full))}"
                f", unexpected {sorted(set(full) - set(own))}")
        sd = self._tp_local(full)
        for k, t in own.items():
            src = sd[k].to(device=t.device, dtype=t.dtype)
            if _is_dtensor(t):
                t.to_local().copy_(_local_shard(src, t))
            else:
                t.copy_(src)

    def _tp_local(self, full: dict) -> dict:
        if not self.tp_rules:
            return full
        g = self.tp_group
        return tp_shard(full, self.tp_rules, dist.get_rank(g),
                        dist.get_world_size(g))

    def param_groups(self, model: nn.Module) -> list:
        """The optimizer's parameter groups: FSDP2's shards and the
        parameters it leaves whole apart (one foreach kernel takes one
        tensor kind), else all of ``model.parameters()`` in one."""
        params = list(model.parameters())
        whole = [p for p in params if not _is_dtensor(p)]
        if len(whole) in (0, len(params)):
            return [{"params": params}]
        return [{"params": [p for p in params if _is_dtensor(p)]},
                {"params": whole}]

    @staticmethod
    def _model_index(opt, model: nn.Module) -> list:
        """The position in ``model.parameters()`` of each of ``opt``'s
        parameters, in ``opt.state_dict()``'s order."""
        pos = {id(p): i for i, p in enumerate(model.parameters())}
        return [pos[id(p)] for g in opt.param_groups for p in g["params"]]

    def gather_optimizer(self, opt, model: nn.Module) -> dict:
        """``opt.state_dict()`` with full tensors, as a one-process
        optimizer over ``model.parameters()`` (one group) keys it (every
        rank calls)."""
        osd = opt.state_dict()
        to_model = self._model_index(opt, model)
        names = [n for n, _ in model.named_parameters()]
        state = {}
        for idx in sorted(osd["state"]):
            name, st = names[to_model[idx]], {}
            for key, v in osd["state"][idx].items():
                if _is_dtensor(v):
                    v = v.full_tensor()
                if name in self.tp_rules and torch.is_tensor(v) and v.dim():
                    v = tp_unshard({name: v}, self.tp_rules,
                                   self.tp_group)[name]
                st[key] = v
            state[to_model[idx]] = st
        group = {k: v for k, v in osd["param_groups"][0].items()
                 if k != "params"}
        return {"state": dict(sorted(state.items())),
                "param_groups": [{**group, "params": list(range(len(names)))}]}

    def load_optimizer(self, opt, model: nn.Module, full: dict):
        """Load ``gather_optimizer``'s dict (or a one-process optimizer's)
        into ``opt``, each moment cut to its parameter's local piece."""
        from torch.distributed.tensor import DTensor

        named = list(model.named_parameters())
        to_opt = {m: i for i, m in enumerate(self._model_index(opt, model))}
        state = {}
        for idx, st in full["state"].items():
            name, p = named[int(idx)]
            local = {}
            for key, v in st.items():
                if torch.is_tensor(v) and v.dim():
                    v = self._tp_local({name: v}).get(name, v)
                    if _is_dtensor(p):
                        v = DTensor.from_local(
                            _local_shard(v.to(p.device), p), p.device_mesh,
                            p.placements, run_check=False, shape=p.shape,
                            stride=p.stride())
                local[key] = v
            state[to_opt[int(idx)]] = local
        (group,) = [{k: v for k, v in g.items() if k != "params"}
                    for g in full["param_groups"]]
        groups, start = [], 0
        for g in opt.param_groups:
            n = len(g["params"])
            groups.append({**group, "params": list(range(start, start + n))})
            start += n
        opt.load_state_dict({"state": state, "param_groups": groups})


def parallelize(model: nn.Module, ema: nn.Module, mesh, tensor_parallel: bool,
                fsdp: bool, fsdp_min_size: int = 65536) -> ParallelLayout:
    """Place ``model`` and its EMA copy on ``mesh`` (both built alike, on
    this rank's device, before any optimizer): tensor parallelism over
    ``model`` when asked (any size, one included), then FSDP2 over
    ``data`` when ``fsdp``, else DDP over ``data``.  ``fsdp_min_size``:
    parameters with fewer elements stay whole (0: shard everything)."""
    rules = {}
    if tensor_parallel:
        group = mesh["model"].get_group()
        rules = apply_tensor_parallel(model, group)
        apply_tensor_parallel(ema, group)
    elif mesh["model"].size() > 1:
        raise ValueError("a model axis larger than one needs "
                         "tensor_parallel=True")
    data_mesh = mesh["data"]
    if fsdp:
        from torch.distributed.fsdp import fully_shard

        floor = max(int(fsdp_min_size), 1)
        layout = None
        for m in (model, ema):
            whole = {p for p in m.parameters() if p.numel() < floor}
            for block in m.blocks:
                fully_shard(block, mesh=data_mesh, ignored_params=whole)
            # the EMA reshards after its forwards too (vis and eval
            # sampling), so that its update always meets shards
            fully_shard(m, mesh=data_mesh, ignored_params=whole,
                        reshard_after_forward=m is ema)
            if m is model:
                layout = ParallelLayout(
                    mesh, rules, True, model,
                    [p for p in model.parameters() if p.numel() < floor])
        return layout
    from torch.nn.parallel import DistributedDataParallel as DDP

    dev = next(model.parameters()).device
    # the model's buffers are its constant scan-path tables: nothing to
    # broadcast before each forward
    ddp = DDP(model, device_ids=[dev] if dev.type == "cuda" else None,
              process_group=data_mesh.get_group(),
              gradient_as_bucket_view=True, broadcast_buffers=False)
    return ParallelLayout(mesh, rules, False, ddp)
