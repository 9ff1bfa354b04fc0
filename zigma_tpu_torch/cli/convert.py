"""Checkpoint conversion: a reference ``.pt`` -> a port checkpoint to
fine-tune from.

    python -m zigma_tpu_torch.cli.convert --ckpt faceshq1024_0060000.pt \
        --out ./converted model=s1024_zigzag8_b2 [--which ema] [k=v ...]

Counterpart of ``zigma_tpu/cli/convert.py``.  The reference releases
checkpoints as torch dicts ``{model, ema, opt, args, train_steps,
best_fid}`` (train_acc.py:492-505); ``cli.sample`` reads them as they are.
This CLI takes the ``--which`` weights (``module.`` prefixes stripped),
checks every name and shape against the model the config groups build (a
missing, extra or mis-shaped name exits with the list, rather than
fine-tuning from garbage) and writes a complete step-0 checkpoint
``{out}/0000000.pt`` through ``train.checkpoints.save_checkpoint``: the
weights as model and EMA, a fresh AdamW, ``train_steps`` 0 and the
``best_fid`` of a fresh run, so ``python -m zigma_tpu_torch.cli.train
ckpt={out}/0000000.pt`` fine-tunes from it.  The model is built on the
card unless ``device=cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys

import torch

from zigma_tpu_torch.cli.sample import DEFAULT_CONFIG_DIR, build_model
from zigma_tpu_torch.config import config_to_dict, load_config
from zigma_tpu_torch.device import resolve_device
from zigma_tpu_torch.train import TrainState, save_checkpoint

__all__ = ["read_reference_weights", "main"]


def read_reference_weights(path: str, which: str = "ema") -> dict:
    """The ``which`` state dict of a reference ``.pt`` (a bare state dict
    as it is), ``module.`` prefixes stripped.  The file is unpickled in
    full (reference checkpoints carry their args): convert only files you
    trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and ("ema" in ckpt or "model" in ckpt):
        if which not in ckpt:
            raise SystemExit(f"{path} has no {which!r} weights "
                             f"(keys: {sorted(ckpt)})")
        ckpt = ckpt[which]
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in ckpt.items()}


def main(argv=None) -> str:
    """Convert; returns the written checkpoint's path."""
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", required=True, help="reference .pt checkpoint")
    ap.add_argument("--out", required=True, help="output checkpoint directory")
    ap.add_argument("--which", default="ema", choices=["ema", "model"],
                    help="which weights to take from the .pt dict")
    ap.add_argument("--config-dir", default=DEFAULT_CONFIG_DIR)
    args, overrides = ap.parse_known_args(argv)

    cfg = load_config(args.config_dir, "default", overrides)
    model = build_model(cfg, device=resolve_device(cfg.get("device")))
    weights = read_reference_weights(args.ckpt, args.which)
    template = model.state_dict()
    errors = []
    for k, v in template.items():
        got = weights.get(k)
        if got is None:
            errors.append(f"missing in .pt: {k}")
        elif tuple(got.shape) != tuple(v.shape):
            errors.append(f"shape mismatch {k}: {tuple(got.shape)} vs "
                          f"model {tuple(v.shape)}")
    errors += [f"unexpected in .pt: {k}" for k in weights
               if k not in template]
    if errors:
        raise SystemExit("conversion mismatch:\n  " + "\n  ".join(errors))
    model.load_state_dict(weights, strict=True)

    state = TrainState.create(  # EMA == model, fresh AdamW, step 0
        model, lr=float(cfg.optim.get("lr", 1e-4)),
        weight_decay=float(cfg.optim.get("wd", 0.0)))
    path = save_checkpoint(args.out, state, config_to_dict(cfg))
    n = sum(v.numel() for v in template.values())
    print(f"converted {args.ckpt} [{args.which}] ({n / 1e6:.2f}M params) "
          f"-> {path}")
    print(f"fine-tune with: python -m zigma_tpu_torch.cli.train ckpt={path} "
          + " ".join(overrides))
    return path


if __name__ == "__main__":
    main()
