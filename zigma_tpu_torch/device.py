"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU
(``device=cpu`` on the CLI, ``device="cpu"`` in the API).  Asking for CUDA
on a machine without it raises; nothing carries on on the CPU instead.
Under a launcher each process takes the card of its ``LOCAL_RANK``.

TF32 is off for both matmuls and cuDNN convolutions, so every float32
comparison on the card is a float32 one (PyTorch's default leaves cuDNN
convolutions in TF32).
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

__all__ = ["resolve_device", "set_precision_flags"]


def set_precision_flags() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means CUDA.  Raises if CUDA is asked for and absent.  Under
    a launcher (``LOCAL_RANK`` set, as ``torchrun`` sets it) CUDA without an
    index is ``cuda:{LOCAL_RANK}``, made the current device before anything
    is allocated."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev}: the port runs on cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was asked for but torch.cuda.is_available() is "
            f"false; pass device=cpu to run the plain CPU versions")
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    set_precision_flags()
    return dev
