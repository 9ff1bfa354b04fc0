"""JAX (flax) ZigMa params -> the port's state dict.

The inverse of ``zigma_tpu/convert/torch_zigma.py::convert_state_dict``:
takes the flax tree as numpy arrays (``{"params": ...}`` or bare) and returns
a state dict with the reference torch names, which ``ZigMa.load_state_dict``
takes as it is.  Both block layouts are read: per-layer ``blocks_{i}`` and
the stacked ``blocks`` of a scan-over-layers model (leading depth axis; the
JAX default at depth >= 8, so the flagship's params look like that).

Layout rules: flax Dense kernel (in, out) -> torch weight (out, in); flax
Conv kernel (kh, kw, in, out) -> (out, in, kh, kw); depthwise conv taps
(d, w) -> (d, 1, w); the ``scan_b`` branch -> the ``_b`` parameter names,
the parallelN branches ``scan_b{j}`` -> the reference's ``*_b_list.{j}``
names (``A_b_log_list.{j}``, ``conv1d_b_list.{j}.weight``, ...).  The label
table is copied whole, with its null-class row where the model has one.
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


def _branch(sd: dict, pre: str, br: dict, s: str, j: str = ""):
    """One scan branch: ``s`` is '' or '_b' (v2), ``j`` '.{j}' of a
    parallelN branch, whose names end in ``_b_list.{j}``."""
    A, D, conv, x_proj, dt_proj = (
        (f"A{s}_log", f"D{s}", f"conv1d{s}", f"x_proj{s}", f"dt_proj{s}")
        if not j else (f"A_b_log_list{j}", f"D_b_list{j}", f"conv1d_b_list{j}",
                       f"x_proj_b_list{j}", f"dt_proj_b_list{j}"))
    sd[f"{pre}.{A}"] = _tensor(br["A_log"])
    sd[f"{pre}.{D}"] = _tensor(br["D"])
    sd[f"{pre}.{conv}.weight"] = _tensor(np.asarray(br["conv1d_weight"])[:, None, :])
    if "conv1d_bias" in br:
        sd[f"{pre}.{conv}.bias"] = _tensor(br["conv1d_bias"])
    sd[f"{pre}.{x_proj}.weight"] = _tensor(np.asarray(br["x_proj_kernel"]).T)
    sd[f"{pre}.{dt_proj}.weight"] = _tensor(np.asarray(br["dt_proj_kernel"]).T)
    sd[f"{pre}.{dt_proj}.bias"] = _tensor(br["dt_proj_bias"])


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
    mixer = dict(blk["mixer"])
    _dense(sd, f"{pre}.mixer.in_proj", mixer.pop("in_proj"))
    _dense(sd, f"{pre}.mixer.out_proj", mixer.pop("out_proj"))
    _branch(sd, f"{pre}.mixer", mixer.pop("scan"), "")
    if "scan_b" in mixer:
        _branch(sd, f"{pre}.mixer", mixer.pop("scan_b"), "_b")
    j = 0
    while f"scan_b{j}" in mixer:  # parallelN
        _branch(sd, f"{pre}.mixer", mixer.pop(f"scan_b{j}"), "", f".{j}")
        j += 1
    if mixer:
        raise ValueError(f"{pre}.mixer: unknown JAX params {sorted(mixer)}")


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
    for key in ("pos_embed", "temporal_pos_embedding"):
        if key in p:
            sd[key] = _tensor(p.pop(key))

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
            f"unconverted JAX params {sorted(p)} (per-layer PE and other "
            f"extras land in a later slice of the port)")
    return sd
