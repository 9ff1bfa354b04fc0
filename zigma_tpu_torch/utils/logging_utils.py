"""Logging and metric sinks (wandb optional).

Own copy of ``zigma_tpu/utils/logging_utils.py``'s ``create_logger``, the
JSONL part of ``MetricLogger``, ``array_to_image_grid`` and
``write_video_grid``: every record
lands in ``{run_dir}/metrics.jsonl``; wandb mirrors it only when asked for
and installed.  The port runs one process, so there is no rank gate.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

import numpy as np

__all__ = ["create_logger", "MetricLogger", "array_to_image_grid",
           "write_video_grid"]


def create_logger(log_dir: Optional[str] = None,
                  name: str = "zigma_torch") -> logging.Logger:
    """stdout + ``{log_dir}/log.txt``."""
    logger = logging.getLogger(name)
    logger.handlers.clear()
    logger.propagate = False
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("[%(asctime)s] %(message)s",
                            datefmt="%Y-%m-%d %H:%M:%S")
    handlers = [logging.StreamHandler()]
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(log_dir, "log.txt")))
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


class MetricLogger:
    """JSONL metric stream, with an optional wandb mirror."""

    def __init__(self, run_dir: str, use_wandb: bool = False,
                 wandb_kwargs: Optional[dict] = None):
        os.makedirs(run_dir, exist_ok=True)
        self.run_dir = run_dir
        self._fh = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(**(wandb_kwargs or {}))
            except ImportError:
                logging.getLogger("zigma_torch").warning(
                    "wandb requested but not installed; JSONL only")

    def log(self, step: int, **metrics):
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            rec[k] = (float(v) if isinstance(
                v, (int, float, np.floating, np.integer, np.bool_)) else v)
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self):
        self._fh.close()


def array_to_image_grid(x: np.ndarray, pad: int = 2) -> np.ndarray:
    """(B, C, H, W) in [-1, 1] -> one (H', W', 3) uint8 grid image."""
    x = np.asarray(x)
    x = np.clip((x + 1) / 2, 0, 1)
    B, C, H, W = x.shape
    cols = int(np.ceil(np.sqrt(B)))
    rows = int(np.ceil(B / cols))
    grid = np.ones((rows * (H + pad) - pad, cols * (W + pad) - pad, 3))
    for i in range(B):
        r, c = divmod(i, cols)
        img = np.transpose(x[i], (1, 2, 0))
        if C == 1:
            img = np.repeat(img, 3, axis=-1)
        elif C > 3:
            img = img[..., :3]
        grid[r * (H + pad):r * (H + pad) + H,
             c * (W + pad):c * (W + pad) + W] = img
    return (grid * 255).astype(np.uint8)


def write_video_grid(videos: np.ndarray, path: str, fps: int = 4) -> str:
    """(B, T, C, H, W) in [-1, 1] -> one animated GIF whose frame t is the
    grid of the B samples at time t (PIL).  Returns ``path``."""
    from PIL import Image

    v = np.asarray(videos)
    if v.ndim != 5:
        raise ValueError(f"expected (B, T, C, H, W) videos, got {v.shape}")
    frames = [Image.fromarray(array_to_image_grid(v[:, t]))
              for t in range(v.shape[1])]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   duration=max(int(1000 / fps), 1), loop=0)
    return path
