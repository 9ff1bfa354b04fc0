"""Training checkpoints in the reference's own layout.

The reference saves one torch dict ``{model, ema, opt, args, train_steps,
best_fid}`` as ``{ckpt_dir}/{step:07d}.pt`` (train_acc.py:492-505); the port
writes exactly that, so ``cli.sample.load_state_dict`` reads the ``ema`` of
a checkpoint this trainer wrote with no converter.  ``latest_checkpoint``
picks the largest step number, as the JAX package does (the reference picks
the newest file by mtime).  ``restore_checkpoint`` restores all of it:
weights, EMA, the optimizer's moments and step counts, the step and
best_fid.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_checkpoint"]

_STEP_RE = re.compile(r"^(\d{7,})\.pt$")


def save_checkpoint(ckpt_dir: str, state, args: Optional[dict] = None) -> str:
    """Write ``{ckpt_dir}/{state.step:07d}.pt``; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(ckpt_dir), f"{state.step:07d}.pt")
    torch.save({"model": state.model.state_dict(),
                "ema": state.ema.state_dict(),
                "opt": state.opt.state_dict(),
                "args": args,
                "train_steps": state.step,
                "best_fid": state.best_fid}, path)
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
    state.model.load_state_dict(ckpt["model"])
    state.ema.load_state_dict(ckpt["ema"])
    state.opt.load_state_dict(ckpt["opt"])
    state.step = int(ckpt["train_steps"])
    state.best_fid = float(ckpt["best_fid"])
    return state
