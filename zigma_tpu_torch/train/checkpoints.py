"""Training checkpoints in the reference's own layout.

The reference saves one torch dict ``{model, ema, opt, args, train_steps,
best_fid}`` as ``{ckpt_dir}/{step:07d}.pt`` (train_acc.py:492-505); the port
writes exactly that, so ``cli.sample.load_state_dict`` reads the ``ema`` of
a checkpoint this trainer wrote with no converter.  ``latest_checkpoint``
picks the largest step number, as the JAX package does (the reference picks
the newest file by mtime).  ``restore_checkpoint`` restores all of it:
weights, EMA, the optimizer's moments and step counts, the step and
best_fid.  Across processes (``TrainState.layout``) the file is the same:
full tensors under the one-process names, whatever DDP, FSDP2 or tensor
parallelism hold on each rank.  A file written with a capturable AdamW (a
chained run on the card) and one written without load into either.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_checkpoint"]

_STEP_RE = re.compile(r"^(\d{7,})\.pt$")


def save_checkpoint(ckpt_dir: str, state, args: Optional[dict] = None) -> str:
    """Write ``{ckpt_dir}/{state.step:07d}.pt``; returns its path.

    With a ``state.layout`` every rank must call: the full tensors are
    gathered on every rank, rank 0 writes the file, and a barrier holds the
    others until it is whole."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"{state.step:07d}.pt")
    layout = state.layout
    if layout is None:
        model, ema = state.model.state_dict(), state.ema.state_dict()
        opt = state.opt.state_dict()
    else:
        model, ema = (layout.gather_state(state.model),
                      layout.gather_state(state.ema))
        opt = layout.gather_optimizer(state.opt, state.model)
    if layout is None or dist.get_rank() == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        torch.save({"model": model, "ema": ema, "opt": opt, "args": args,
                    "train_steps": state.step,
                    "best_fid": state.best_fid}, path)
    if layout is not None:
        dist.barrier()
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The largest-step ``.pt`` in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [f for f in os.listdir(ckpt_dir) if _STEP_RE.match(f)]
    if not steps:
        return None
    best = max(steps, key=lambda f: int(_STEP_RE.match(f).group(1)))
    return os.path.join(os.path.abspath(ckpt_dir), best)


def restore_checkpoint(path: str, state):
    """Load a checkpoint written by ``save_checkpoint`` into ``state`` (in
    place) and return it.  The file is unpickled in full (it carries the
    run's args), so load only checkpoints you trust."""
    device = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=False)
    capturable = [g.get("capturable", False) for g in state.opt.param_groups]
    if state.layout is None:
        state.model.load_state_dict(ckpt["model"])
        state.ema.load_state_dict(ckpt["ema"])
        state.opt.load_state_dict(ckpt["opt"])
    else:  # the full tensors on every rank, each keeping its own piece
        state.layout.load_state(state.model, ckpt["model"])
        state.layout.load_state(state.ema, ckpt["ema"])
        state.layout.load_optimizer(state.opt, state.model, ckpt["opt"])
    # the file's parameter groups carry its writer's ``capturable``: keep
    # this optimizer's, with each step count where it keeps them (on the
    # parameter's device when capturable, else on the host)
    for group, cap in zip(state.opt.param_groups, capturable):
        group["capturable"] = cap
        for p in group["params"]:
            st = state.opt.state.get(p, {})
            if torch.is_tensor(st.get("step")):
                st["step"] = st["step"].to(p.device if cap else "cpu")
    state.step = int(ckpt["train_steps"])
    state.best_fid = float(ckpt["best_fid"])
    return state
