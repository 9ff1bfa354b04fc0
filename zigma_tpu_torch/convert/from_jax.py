"""JAX (flax) ZigMa params -> the port's state dict.

The inverse of ``zigma_tpu/convert/torch_zigma.py::convert_state_dict``:
takes the flax tree as numpy arrays (``{"params": ...}`` or bare) and returns
a state dict with the reference torch names, which ``ZigMa.load_state_dict``
takes as it is.  Both block layouts are read: per-layer ``blocks_{i}`` and
the stacked ``blocks`` of a scan-over-layers model (leading depth axis; the
JAX default at depth >= 8, so the flagship's params look like that).

Layout rules: flax Dense kernel (in, out) -> torch weight (out, in); flax
Conv kernel (kh, kw, in, out) -> (out, in, kh, kw); depthwise conv taps
(d, w) -> (d, 1, w); the ``scan_b`` branch -> the ``_b`` parameter names.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["state_dict_from_jax"]


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _dense(sd: dict, name: str, tree: dict):
    sd[f"{name}.weight"] = _tensor(np.asarray(tree["kernel"]).T)
    if "bias" in tree:
        sd[f"{name}.bias"] = _tensor(tree["bias"])


def _branch(sd: dict, pre: str, br: dict, s: str):
    sd[f"{pre}.A{s}_log"] = _tensor(br["A_log"])
    sd[f"{pre}.D{s}"] = _tensor(br["D"])
    sd[f"{pre}.conv1d{s}.weight"] = _tensor(np.asarray(br["conv1d_weight"])[:, None, :])
    if "conv1d_bias" in br:
        sd[f"{pre}.conv1d{s}.bias"] = _tensor(br["conv1d_bias"])
    sd[f"{pre}.x_proj{s}.weight"] = _tensor(np.asarray(br["x_proj_kernel"]).T)
    sd[f"{pre}.dt_proj{s}.weight"] = _tensor(np.asarray(br["dt_proj_kernel"]).T)
    sd[f"{pre}.dt_proj{s}.bias"] = _tensor(br["dt_proj_bias"])


def _block(sd: dict, pre: str, blk: dict):
    known = {"norm_weight", "norm_bias", "adaLN", "mixer"}
    if set(blk) - known:
        raise NotImplementedError(
            f"{pre}: {sorted(set(blk) - known)} (text cross-attention and "
            f"other block extras land in a later slice of the port)")
    sd[f"{pre}.norm.weight"] = _tensor(blk["norm_weight"])
    if "norm_bias" in blk:
        sd[f"{pre}.norm.bias"] = _tensor(blk["norm_bias"])
    _dense(sd, f"{pre}.adaLN_modulation.1", blk["adaLN"])
    mixer = blk["mixer"]
    extra = set(mixer) - {"in_proj", "out_proj", "scan", "scan_b"}
    if extra:
        raise NotImplementedError(f"{pre}.mixer: {sorted(extra)} (parallelN "
                                  f"lands in a later slice of the port)")
    _dense(sd, f"{pre}.mixer.in_proj", mixer["in_proj"])
    _dense(sd, f"{pre}.mixer.out_proj", mixer["out_proj"])
    _branch(sd, f"{pre}.mixer", mixer["scan"], "")
    if "scan_b" in mixer:
        _branch(sd, f"{pre}.mixer", mixer["scan_b"], "_b")


def _unstack(tree, i: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def state_dict_from_jax(params: dict) -> dict:
    """flax ZigMa params (numpy leaves) -> port state dict (torch tensors)."""
    p = dict(params.get("params", params))
    sd: dict = {}
    xe = p.pop("x_embedder")["proj"]
    sd["x_embedder.proj.weight"] = _tensor(
        np.transpose(np.asarray(xe["kernel"]), (3, 2, 0, 1)))
    sd["x_embedder.proj.bias"] = _tensor(xe["bias"])
    te = p.pop("t_embedder")
    _dense(sd, "t_embedder.mlp.0", te["mlp_0"])
    _dense(sd, "t_embedder.mlp.2", te["mlp_2"])
    if "y_embedder" in p:
        ye = p.pop("y_embedder")
        if "embedding" not in ye:
            raise NotImplementedError("text y_embedder lands in a later slice")
        sd["y_embedder.embedding_table.weight"] = _tensor(
            ye["embedding"]["embedding"])
    if "pos_embed" in p:
        sd["pos_embed"] = _tensor(p.pop("pos_embed"))

    if "blocks" in p:  # stacked scan-over-layers layout
        stacked = p.pop("blocks")
        depth = np.asarray(stacked["norm_weight"]).shape[0]
        for i in range(depth):
            _block(sd, f"blocks.{i}", _unstack(stacked, i))
    i = 0
    while f"blocks_{i}" in p:
        _block(sd, f"blocks.{i}", p.pop(f"blocks_{i}"))
        i += 1

    sd["norm_f.weight"] = _tensor(p.pop("norm_f_weight"))
    if "norm_f_bias" in p:
        sd["norm_f.bias"] = _tensor(p.pop("norm_f_bias"))
    fl = p.pop("final_layer")
    if set(fl) != {"linear"}:
        raise NotImplementedError("a conditioned FinalLayer lands in a later slice")
    _dense(sd, "final_layer.linear", fl["linear"])
    if p:
        raise NotImplementedError(
            f"unconverted JAX params {sorted(p)} (temporal PE, per-layer PE "
            f"and other extras land in a later slice of the port)")
    return sd
