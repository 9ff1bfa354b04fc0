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

Text models: the Dense ``y_embedder`` -> the Linear ``y_embedder``; each
block's ``msa`` (``to_q``, ``to_k``, ``to_v``, ``to_out``) ->
``blocks.{i}.msa.{to_q,to_k,to_v,to_out.0}``, the reference names.
use_pe 3: the per-layer ``pos_embed_{i}`` tables, or the stacked
``(depth, 1, n_pe, embed)`` ``pos_embed_layers`` of a scan-over-layers
model, -> ``pos_embed_layers.{i}``.

Mamba-2 mixers (a block whose mixer has ``ssd``; the reference has no
Mamba-2, so the names are the public ``mamba_ssm`` Mamba2 module's):

    in_proj / out_proj (Dense)      -> mixer.in_proj / mixer.out_proj
    norm_weight                     -> mixer.norm.weight
    ssd.conv1d_weight (c, w)        -> mixer.conv1d.weight (c, 1, w)
    ssd.conv1d_bias                 -> mixer.conv1d.bias
    ssd.A_log, ssd.dt_bias, ssd.D   -> mixer.A_log, mixer.dt_bias, mixer.D
    ssd_b.*                         -> the same with ``_b`` after the first
                                       word: conv1d_b, A_b_log, dt_b_bias, D_b
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


def _ssd_branch(sd: dict, pre: str, br: dict, s: str):
    """One Mamba-2 direction: ``s`` is '' or '_b'."""
    sd[f"{pre}.conv1d{s}.weight"] = _tensor(
        np.asarray(br["conv1d_weight"])[:, None, :])
    if "conv1d_bias" in br:
        sd[f"{pre}.conv1d{s}.bias"] = _tensor(br["conv1d_bias"])
    sd[f"{pre}.A{s}_log"] = _tensor(br["A_log"])
    sd[f"{pre}.dt{s}_bias"] = _tensor(br["dt_bias"])
    sd[f"{pre}.D{s}"] = _tensor(br["D"])


def _block(sd: dict, pre: str, blk: dict):
    known = {"norm_weight", "norm_bias", "adaLN", "mixer", "msa"}
    if set(blk) - known:
        raise ValueError(f"{pre}: unknown JAX params {sorted(set(blk) - known)}")
    sd[f"{pre}.norm.weight"] = _tensor(blk["norm_weight"])
    if "norm_bias" in blk:
        sd[f"{pre}.norm.bias"] = _tensor(blk["norm_bias"])
    _dense(sd, f"{pre}.adaLN_modulation.1", blk["adaLN"])
    if "msa" in blk:
        for name in ("to_q", "to_k", "to_v"):
            _dense(sd, f"{pre}.msa.{name}", blk["msa"][name])
        _dense(sd, f"{pre}.msa.to_out.0", blk["msa"]["to_out"])
    mixer = dict(blk["mixer"])
    _dense(sd, f"{pre}.mixer.in_proj", mixer.pop("in_proj"))
    _dense(sd, f"{pre}.mixer.out_proj", mixer.pop("out_proj"))
    if "ssd" in mixer:  # Mamba-2
        sd[f"{pre}.mixer.norm.weight"] = _tensor(mixer.pop("norm_weight"))
        _ssd_branch(sd, f"{pre}.mixer", mixer.pop("ssd"), "")
        if "ssd_b" in mixer:
            _ssd_branch(sd, f"{pre}.mixer", mixer.pop("ssd_b"), "_b")
        if mixer:
            raise ValueError(f"{pre}.mixer: unknown JAX params {sorted(mixer)}")
        return
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
        if "embedding" in ye:  # class labels
            sd["y_embedder.embedding_table.weight"] = _tensor(
                ye["embedding"]["embedding"])
        else:  # text: a Dense of the caption features
            _dense(sd, "y_embedder", ye)
    for key in ("pos_embed", "temporal_pos_embedding"):
        if key in p:
            sd[key] = _tensor(p.pop(key))
    if "pos_embed_layers" in p:  # use_pe 3, stacked (depth, 1, n_pe, embed)
        for i, pe in enumerate(np.asarray(p.pop("pos_embed_layers"))):
            sd[f"pos_embed_layers.{i}"] = _tensor(pe)
    i = 0
    while f"pos_embed_{i}" in p:  # use_pe 3, one table a layer
        sd[f"pos_embed_layers.{i}"] = _tensor(p.pop(f"pos_embed_{i}"))
        i += 1

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
        raise ValueError(f"unconverted JAX params {sorted(p)}")
    return sd
