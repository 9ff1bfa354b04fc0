"""The yardstick's arithmetic: the H100's peaks, the operations and bytes of
the two scan kernels, the least time the card could take for them, and the
FLOPs of a ZigMa forward counted from its shapes.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, without
sparsity, at the 700 W limit).  The kernels' work is each input byte read
once and each output byte written once, the operations of the algorithm
(9 fp32 FLOPs a state and step forward, 25 backward) and the
transcendentals the special-function units evaluate (one exp a state and
step, softplus's exp and log1p and the gate's exp or sigmoid a channel and
step), whatever kernel does the work.
"""

from __future__ import annotations

import math

__all__ = ["PEAK", "SFU_OPS_PER_CLK_PER_SM", "k1_work", "k2_work",
           "least_seconds", "forward_terms", "forward_flops", "scan_shapes"]

PEAK = {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes_per_sec": 3.35e12}
# special-function unit results per clock per SM, compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput)
SFU_OPS_PER_CLK_PER_SM = 16
CARRY_EVERY = 128  # steps between the chunk-start states a forward keeps


def k1_work(batch, L, D, N, item, carries=False):
    """(bytes, fp32 FLOPs, transcendentals) of the forward scan with the
    fused gate: u, delta, z in and y out at ``item`` bytes; B, C; A, the
    delta bias and D in fp32; the final state in fp32; with ``carries`` the
    chunk-start states a training forward keeps for the backward."""
    n_bytes = (4 * batch * L * D * item + 2 * batch * L * N * item
               + D * N * 4 + 2 * D * 4 + batch * N * D * 4)
    if carries:
        n_bytes += batch * -(-L // CARRY_EVERY) * N * D * 4
    return n_bytes, 9 * batch * L * D * N, batch * L * D * N + 3 * batch * L * D


def k2_work(batch, L, D, N, item):
    """(bytes, fp32 FLOPs, transcendentals) of the backward scan: u, delta,
    z, the output's cotangent in and du, ddelta, dz out; B, C in and dB, dC
    out; the chunk-start states; A, bias, D in and their gradients out; the
    seed state's gradient out."""
    n_bytes = (7 * batch * L * D * item + 4 * batch * L * N * item
               + batch * -(-L // CARRY_EVERY) * N * D * 4
               + 2 * (D * N * 4 + 2 * D * 4) + batch * N * D * 4)
    return n_bytes, 25 * batch * L * D * N, batch * L * D * N + 4 * batch * L * D


def least_seconds(work, n_sms: int, sm_clock_mhz: float) -> float:
    """The least time for (bytes, fp32 FLOPs, transcendentals): the larger
    of the bytes over the memory rate and the operations, each type over
    its own peak (transcendentals at the SM clock's maximum)."""
    n_bytes, flops, transc = work
    return max(n_bytes / PEAK["hbm_bytes_per_sec"],
               flops / PEAK["fp32_flops"],
               transc / (SFU_OPS_PER_CLK_PER_SM * n_sms * sm_clock_mhz * 1e6))


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
    R, W = math.ceil(E / 16), cfg.get("d_conv", 4)
    tokens = batch * frames * (cfg["img_dim"] // ps) ** 2
    return {"patch_embed": 2 * tokens * C * ps * ps * E,
            "timestep_mlp": 2 * batch * (256 * E + E * E),
            "adaLN": depth * 2 * batch * E * 3 * E,
            "in_proj": depth * 2 * tokens * E * 2 * d,
            "conv": depth * 2 * tokens * d * W,
            "x_proj": depth * 2 * tokens * d * (R + 2 * n),
            "dt_proj": depth * 2 * tokens * R * d,
            "scan": depth * 9 * tokens * d * n,
            "out_proj": depth * 2 * tokens * d * E,
            "final_layer": 2 * tokens * E * ps * ps * C}


def forward_flops(cfg: dict, batch: int) -> int:
    """The FLOPs of one forward, all of ``forward_terms``."""
    return sum(forward_terms(cfg, batch).values())
