"""The yardstick's arithmetic that depends on the hardware and the kernels
alone: the H100's peaks, the operations and bytes of the two scan kernels
and the least time the card could take for them.  What a model's forward
runs (its FLOPs, its scans' shapes) is its family's (``families/``).

The peaks are NVIDIA's data sheet for the H100 SXM (dense, without
sparsity, at the 700 W limit).  The kernels' work is each input byte read
once and each output byte written once, the operations of the algorithm
(9 fp32 FLOPs a state and step forward, 25 backward) and the
transcendentals the special-function units evaluate (one exp a state and
step, softplus's exp and log1p and the gate's exp or sigmoid a channel and
step), whatever kernel does the work.
"""

from __future__ import annotations

__all__ = ["PEAK", "SFU_OPS_PER_CLK_PER_SM", "k1_work", "k2_work",
           "least_seconds"]

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
