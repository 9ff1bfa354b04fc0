"""Inference-time parameter cast.

Counterpart of ``zigma_tpu/utils/inference.py::cast_params_for_inference``.
The port's modules store float32 parameters and cast each GEMM / conv weight
to the compute dtype where it is used (flax's ``nn.Dense(dtype=...)``).  For
serving that cast can be done once: ``cast_for_inference`` converts, in
place, exactly the parameters whose use sites consume them in the compute
dtype, so the model computes the same values as before.

Kept float32, as in the JAX package (and the reference's CUDA dtypes):
A_log, D, the dt_proj bias and the Mamba-2 dt bias (consumed by the fp32
scans), norm weights and biases (the Mamba-2 gated norm's too),
pos_embed, the use_pe 3 tables, temporal_pos_embedding, and the embedders
(timestep / label / text / patch), which feed the conditioning path.  The
cross-attention's GEMM weights are cast.

The rule table is exhaustive: a float32 parameter it does not know raises
instead of being guessed.
"""

from __future__ import annotations

import re

import torch
from torch import nn

__all__ = ["cast_for_inference", "inference_dtype_rule"]

_KEEP = (
    r"^(x_embedder|t_embedder|y_embedder)\.",
    r"^(pos_embed|temporal_pos_embedding)$",
    r"^pos_embed_layers\.\d+$",
    r"(^|\.)(norm|norm_f)\.(weight|bias)$",
    r"\.mixer\.(A|A_b)_log$",
    r"\.mixer\.A_b_log_list\.\d+$",
    r"\.mixer\.(D|D_b)$",
    r"\.mixer\.D_b_list\.\d+$",
    r"\.mixer\.dt_proj(_b|_b_list\.\d+)?\.bias$",
    r"\.mixer\.(dt|dt_b)_bias$",
)
_CAST = (
    r"\.mixer\.(in_proj|out_proj)\.(weight|bias)$",
    r"\.mixer\.(conv1d|conv1d_b|conv1d_b_list\.\d+)\.(weight|bias)$",
    r"\.mixer\.(x_proj|x_proj_b|x_proj_b_list\.\d+)\.weight$",
    r"\.mixer\.dt_proj(_b|_b_list\.\d+)?\.weight$",
    r"\.adaLN_modulation\.1\.(weight|bias)$",
    r"^final_layer\.linear\.(weight|bias)$",
    r"\.msa\.(to_q|to_k|to_v|to_out\.0)\.(weight|bias)$",
)


def inference_dtype_rule(name: str) -> str:
    """'keep' or 'cast' for a ZigMa parameter name; raises on a name the
    table does not know."""
    if any(re.search(p, name) for p in _KEEP):
        return "keep"
    if any(re.search(p, name) for p in _CAST):
        return "cast"
    raise ValueError(
        f"cast_for_inference: unrecognised parameter {name!r}; add it to the "
        f"keep/cast rule table in zigma_tpu_torch/utils/inference.py")


@torch.no_grad()
def cast_for_inference(model: nn.Module, dtype: torch.dtype = torch.bfloat16):
    """Cast the compute-dtype parameters of ``model`` to ``dtype`` in place
    and return the model.  For inference only: the cast drops the float32
    master copy."""
    for name, p in model.named_parameters():
        if p.dtype == torch.float32 and inference_dtype_rule(name) == "cast":
            p.data = p.data.to(dtype)
    return model
