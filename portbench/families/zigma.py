"""ZigMa (``zigma_tpu_torch.models.zigma``): latent flow-matching diffusion,
adaLN blocks around a Mamba-1 scan along zigzag paths, for images and
video.  The family a configuration file belongs to when it names none."""

from __future__ import annotations

import math
import re

import torch

from portbench import reference, weights as W

__all__ = ["build", "model_kwargs", "input_shape", "conditions", "rule",
           "scan_shapes", "forward_terms", "forward_flops", "reference"]

PERTURB = 0.02


def model_kwargs(cfg: dict) -> dict:
    """The program's ZigMa arguments for a configuration file."""
    keys = ("in_channels", "embed_dim", "depth", "img_dim", "patch_size",
            "num_classes", "class_dropout_prob", "drop_path_rate",
            "norm_epsilon", "scan_type", "use_pe", "use_checkpoint",
            "video_frames", "tpe")
    kw = {k: cfg[k] for k in keys if k in cfg}
    kw["ssm_cfg"] = {k: cfg[k] for k in ("d_state", "d_conv", "expand")
                     if k in cfg}
    kw["dtype"] = {"bf16": torch.bfloat16, "fp32": torch.float32}[
        cfg["mixed_precision"]]
    return kw


def input_shape(cfg: dict, batch: int) -> tuple:
    """Latents (batch, C, H, W), or (batch, frames, C, H, W) for video."""
    shape = (batch, cfg["in_channels"], cfg["img_dim"], cfg["img_dim"])
    if cfg.get("video_frames", 0):
        shape = (batch, cfg["video_frames"], *shape[1:])
    return shape


def conditions(cfg: dict, n: int, batch: int, gen, device) -> dict:
    """Class labels (n, batch) of a class-conditional model; else none."""
    if cfg.get("num_classes", -1) <= 0:
        return {}
    return {"y": torch.randint(0, cfg["num_classes"], (n, batch),
                               generator=gen, device=device)}


def build(cfg: dict, seed: int, device):
    """The program's model with the benchmark's weights loaded, and those
    weights (float32, on the CPU) for the reference."""
    from zigma_tpu_torch.models.zigma import ZigMa
    model = ZigMa(**model_kwargs(cfg), device=device)
    made = W.make_weights({k: tuple(v.shape)
                           for k, v in model.state_dict().items()},
                          cfg, seed, device, rule)
    model.load_state_dict(made)
    weights = {k: v.to("cpu", copy=True) for k, v in made.items()}
    del made
    if torch.device(device).type == "cuda":
        # the peak from here on is the program's: the draws above are not
        torch.cuda.reset_peak_memory_stats()
    return model, weights


def rule(name: str, shape, n, u, cfg):
    """A parameter from its share ``n`` of normal and ``u`` of uniform
    draws, after the published initialisers; the zero-init ones (adaLN,
    biases, position tables) get ``PERTURB`` of normal noise, so that every
    gate is open and every parameter has a gradient."""
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


def scan_shapes(cfg: dict, batch: int) -> list:
    """(batch, L, d_inner, d_state) of every layer's scan in one forward:
    a video layer folds the frames ('s' each frame's tokens, 't' each
    token's frames)."""
    side = cfg["img_dim"] // cfg["patch_size"]
    frames = cfg.get("video_frames", 0)
    d, n = cfg.get("expand", 2) * cfg["embed_dim"], cfg.get("d_state", 16)
    if not frames:
        return [(batch, side * side, d, n)] * cfg["depth"]
    pattern = cfg["scan_type"].split("_", 1)[1]
    return [(batch * frames, side * side, d, n) if ch == "s"
            else (batch * side * side, frames, d, n)
            for ch in (pattern * cfg["depth"])[:cfg["depth"]]]


def forward_terms(cfg: dict, batch: int) -> dict:
    """Multiply-add FLOPs (2 a multiply-add) of one forward by term: the
    patch embedding, the timestep MLP, each block's adaLN, in_proj, causal
    conv taps, x_proj, dt_proj, scan (9 a state and step) and out_proj, and
    the final layer.  Elementwise work is not counted."""
    E, depth, ps = cfg["embed_dim"], cfg["depth"], cfg["patch_size"]
    C, frames = cfg["in_channels"], max(cfg.get("video_frames", 0), 1)
    d, n = cfg.get("expand", 2) * E, cfg.get("d_state", 16)
    R, W_ = math.ceil(E / 16), cfg.get("d_conv", 4)
    tokens = batch * frames * (cfg["img_dim"] // ps) ** 2
    return {"patch_embed": 2 * tokens * C * ps * ps * E,
            "timestep_mlp": 2 * batch * (256 * E + E * E),
            "adaLN": depth * 2 * batch * E * 3 * E,
            "in_proj": depth * 2 * tokens * E * 2 * d,
            "conv": depth * 2 * tokens * d * W_,
            "x_proj": depth * 2 * tokens * d * (R + 2 * n),
            "dt_proj": depth * 2 * tokens * R * d,
            "scan": depth * 9 * tokens * d * n,
            "out_proj": depth * 2 * tokens * d * E,
            "final_layer": 2 * tokens * E * ps * ps * C}


def forward_flops(cfg: dict, batch: int) -> int:
    """The FLOPs of one forward, all of ``forward_terms``."""
    return sum(forward_terms(cfg, batch).values())
