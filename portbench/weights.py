"""Weights and inputs made from ``--seed``, on the device, by the benchmark.

Both the program and the reference get these tensors; neither makes its
own.  Every parameter is drawn in a few large calls (one normal and one
uniform vector over all of them, from a generator on the device) and shaped
by a rule on its name, after the published initialisers, with the zero-init
ones (adaLN, biases, position tables) given 0.02 of normal noise so that
every gate is open and every parameter has a gradient.  A parameter that no
rule knows raises: a new model brings its rule.
"""

from __future__ import annotations

import math
import re

import torch

__all__ = ["generator", "make_weights", "normal", "uniform"]

PERTURB = 0.02


def generator(device, seed: int, stream: int) -> torch.Generator:
    """A generator for one stream of draws of a run (weights, data, ...)."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (2 ** 63))


def normal(shape, gen, device):
    return torch.randn(shape, generator=gen, device=device)


def uniform(shape, gen, device):
    return torch.rand(shape, generator=gen, device=device)


def _rule(name: str, shape, n, u, cfg):
    """A parameter from its share ``n`` of normal and ``u`` of uniform
    draws."""
    fan_in = math.prod(shape[1:]) if len(shape) > 1 else 1
    sym = 2 * u - 1
    if re.search(r"\.A_log$", name):
        return torch.log(torch.arange(1, shape[1] + 1, device=n.device,
                                      dtype=torch.float32)).expand(shape) \
            + PERTURB * n
    if re.search(r"\.D$", name) or re.search(r"(^|\.)norm(_f)?\.weight$", name):
        return 1.0 + PERTURB * n
    if name.endswith("dt_proj.bias"):  # inverse softplus of dt in [1e-3, 0.1]
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        return dt + torch.log(-torch.expm1(-dt))
    if name.endswith("dt_proj.weight"):
        return sym * shape[1] ** -0.5
    if "conv1d" in name:
        return sym * (1.0 / shape[-1] if name.endswith("weight")
                      else 1.0 / 4) ** 0.5
    if name == "x_embedder.proj.weight":
        return sym * math.sqrt(6.0 / (fan_in + shape[0]))
    if name.endswith("out_proj.weight"):
        return sym * fan_in ** -0.5 / math.sqrt(cfg["depth"])
    if re.search(r"(in_proj|x_proj|final_layer\.linear)\.weight$", name):
        return sym * fan_in ** -0.5
    if re.search(r"(adaLN_modulation\.1|t_embedder\.mlp\.\d)\.weight$", name) \
            or name.endswith(".bias") or name in (
                "pos_embed", "temporal_pos_embedding",
                "y_embedder.embedding_table.weight"):
        return PERTURB * n
    raise KeyError(f"no weight rule for parameter {name!r}")


@torch.no_grad()
def make_weights(shapes: dict, cfg: dict, seed: int, device) -> dict:
    """float32 weights for ``shapes`` ({name: shape}), from ``seed``."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = generator(device, seed, 0)
    n_all = normal((total,), gen, device)
    u_all = uniform((total,), gen, device)
    out, at = {}, 0
    for name, shape in shapes.items():
        k = math.prod(shape)
        out[name] = _rule(name, tuple(shape), n_all[at:at + k].view(shape),
                          u_all[at:at + k].view(shape), cfg).contiguous()
        at += k
    return out
