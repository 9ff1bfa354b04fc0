"""Logging and metric sinks (wandb optional).

Own copy of ``zigma_tpu/utils/logging_utils.py``'s ``create_logger``,
``MetricLogger`` (the JSONL stream and ``log_media``), ``array_to_image_grid``,
``write_video_grid`` and ``pos_embed_similarity_grid``: every record lands
in ``{run_dir}/metrics.jsonl``; wandb mirrors records and vis files only
when asked for and installed.  The trainer makes a logger on rank 0 alone,
so there is no rank gate here.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

import numpy as np

__all__ = ["create_logger", "MetricLogger", "array_to_image_grid",
           "write_video_grid", "pos_embed_similarity_grid"]


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

    def log_media(self, step: int, path: str, key: str = "samples"):
        """Mirror a vis file to wandb when it is on: ``wandb.Video`` for an
        animated file (``.gif``, ``.mp4``, ``.webm``), ``wandb.Image``
        otherwise; without wandb nothing (the file is the artifact)."""
        if self._wandb is None:
            return
        media = (self._wandb.Video(path)
                 if path.endswith((".gif", ".mp4", ".webm"))
                 else self._wandb.Image(path))
        self._wandb.log({key: media}, step=step)

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


def pos_embed_similarity_grid(pos_embed: np.ndarray, img_dim: int,
                              anchors: int = 16) -> np.ndarray:
    """Cosine-similarity maps of a learned position table: for a grid of
    anchor tokens, the similarity of the anchor's embedding to every
    token's, on the (img_dim, img_dim) token grid.

    pos_embed: (L, D) with L == img_dim**2 (a leading length-1 axis is
    squeezed).  Returns an (H', W', 3) uint8 grid image of ``anchors``
    maps (``array_to_image_grid`` of the maps in [-1, 1])."""
    pe = np.asarray(pos_embed, np.float32)
    if pe.ndim == 3 and pe.shape[0] == 1:
        pe = pe[0]
    L, _ = pe.shape
    if L != img_dim * img_dim:
        raise ValueError(f"pos_embed length {L} != {img_dim}^2")
    pe = pe / np.maximum(np.linalg.norm(pe, axis=-1, keepdims=True), 1e-8)
    side = int(np.ceil(np.sqrt(anchors)))
    coords = np.linspace(0, img_dim - 1, side).round().astype(int)
    maps = [(pe @ pe[r * img_dim + c]).reshape(img_dim, img_dim)
            for r in coords for c in coords]
    return array_to_image_grid(np.stack(maps)[:, None])
