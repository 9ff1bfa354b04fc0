"""Weights and inputs made from ``--seed``, on the device, by the benchmark.

Both the program and the reference get these tensors; neither makes its
own.  Every parameter is drawn in a few large calls (one normal and one
uniform vector over all of them, from a generator on the device) and shaped
by the model family's rule on its name (``families/<family>.py``), from
its share of the two vectors, in the order of the model's parameters.
"""

from __future__ import annotations

import math

import torch

__all__ = ["generator", "make_weights", "normal", "uniform"]


def generator(device, seed: int, stream: int) -> torch.Generator:
    """A generator for one stream of draws of a run (weights, data, ...)."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (2 ** 63))


def normal(shape, gen, device):
    return torch.randn(shape, generator=gen, device=device)


def uniform(shape, gen, device):
    return torch.rand(shape, generator=gen, device=device)


@torch.no_grad()
def make_weights(shapes: dict, cfg: dict, seed: int, device, rule) -> dict:
    """float32 weights for ``shapes`` ({name: shape}), from ``seed``: each
    ``rule(name, shape, normal draws, uniform draws, cfg)``."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = generator(device, seed, 0)
    n_all = normal((total,), gen, device)
    u_all = uniform((total,), gen, device)
    out, at = {}, 0
    for name, shape in shapes.items():
        k = math.prod(shape)
        out[name] = rule(name, tuple(shape), n_all[at:at + k].view(shape),
                         u_all[at:at + k].view(shape), cfg).contiguous()
        at += k
    return out
