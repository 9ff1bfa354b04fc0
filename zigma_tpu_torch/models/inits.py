"""Weight initialisers shared by the port's modules.

Counterpart of ``zigma_tpu/models/inits.py``.  Weights are PyTorch
``(out, in)``; the fan-in is ``weight.shape[1]``.  Every initialiser takes an
explicit ``torch.Generator`` (None draws from the default one).

- ``torch_linear_init_``: torch's ``nn.Linear`` default for the weight,
  U(+-1/sqrt(fan_in)).
- ``rescaled_linear_init_``: the same divided by sqrt(n_layer), the GPT-2
  residual-projection rescale the reference applies to each out_proj.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["uniform_", "normal_", "torch_linear_init_", "rescaled_linear_init_"]


@torch.no_grad()
def uniform_(t: torch.Tensor, bound: float,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def normal_(t: torch.Tensor, std: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return t.normal_(0.0, std, generator=generator)


def torch_linear_init_(weight: torch.Tensor,
                       generator: Optional[torch.Generator] = None):
    return uniform_(weight, weight.shape[1] ** -0.5, generator)


@torch.no_grad()
def rescaled_linear_init_(weight: torch.Tensor, n_layer: int,
                          generator: Optional[torch.Generator] = None):
    torch_linear_init_(weight, generator)
    return weight.div_(math.sqrt(n_layer))
