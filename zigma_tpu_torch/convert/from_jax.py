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

The SD-VAE (``vae_state_dict_from_jax``, trees of
``zigma_tpu/data/vae_jax.py``) and the CLIP text tower
(``clip_state_dict_from_jax``, trees of ``data/clip_jax.py``) go to the
diffusers / Hugging Face names the port's modules carry (``data/sd_vae.py``,
``data/clip_text.py``).

The metric nets (``inception_state_dict_from_jax``,
``dinov2_state_dict_from_jax``, ``i3d_state_dict_from_jax``,
``lpips_state_dicts_from_jax``) take the trees that the JAX nets'
``random_params`` and ``load_torch_state_dict`` build
(``zigma_tpu/metrics/{inception,dinov2,i3d,lpips}_jax.py``) and give the
torch-fidelity, dinov2 hub, pytorch-i3d and torchvision / lpips names of
``metrics/{inception,dinov2,i3d,lpips}.py``: convolutions HWIO -> OIHW and
DHWIO -> OIDHW, BatchNorm scale / bias / mean / var -> ``bn.weight``,
``bn.bias``, ``bn.running_mean``, ``bn.running_var``; DINOv2's Linear
weights are (out, in) on both sides.

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

__all__ = ["state_dict_from_jax", "vae_state_dict_from_jax",
           "clip_state_dict_from_jax", "inception_state_dict_from_jax",
           "dinov2_state_dict_from_jax", "i3d_state_dict_from_jax",
           "lpips_state_dicts_from_jax"]


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


# ------------------------------------------------------------ SD-VAE, CLIP ---

def _vae_conv(sd: dict, name: str, p: dict):
    sd[f"{name}.weight"] = _tensor(np.transpose(np.asarray(p["w"]), (3, 2, 0, 1)))
    sd[f"{name}.bias"] = _tensor(p["b"])


def _affine(sd: dict, name: str, p: dict):
    sd[f"{name}.weight"] = _tensor(p["scale"])
    sd[f"{name}.bias"] = _tensor(p["bias"])


def _vae_resnet(sd: dict, name: str, p: dict):
    _affine(sd, f"{name}.norm1", p["norm1"])
    _vae_conv(sd, f"{name}.conv1", p["conv1"])
    _affine(sd, f"{name}.norm2", p["norm2"])
    _vae_conv(sd, f"{name}.conv2", p["conv2"])
    if "shortcut" in p:
        _vae_conv(sd, f"{name}.conv_shortcut", p["shortcut"])


def _vae_mid(sd: dict, name: str, p: dict):
    _vae_resnet(sd, f"{name}.resnets.0", p["res1"])
    _vae_resnet(sd, f"{name}.resnets.1", p["res2"])
    a, pre = p["attn"], f"{name}.attentions.0"
    _affine(sd, f"{pre}.group_norm", a["norm"])
    for jax_name, name_ in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                            ("proj", "to_out.0")):
        sd[f"{pre}.{name_}.weight"] = _tensor(np.asarray(a[jax_name]["w"]).T)
        sd[f"{pre}.{name_}.bias"] = _tensor(a[jax_name]["b"])


def vae_state_dict_from_jax(params: dict) -> dict:
    """``vae_jax`` params (numpy leaves) -> the diffusers ``AutoencoderKL``
    state dict of ``data.sd_vae``: conv kernels HWIO -> OIHW, attention
    (in, out) -> Linear (out, in)."""
    sd: dict = {}
    for part, n_res, level in (("encoder", 2, "down"), ("decoder", 3, "up")):
        p, pre = params[part], part
        _vae_conv(sd, f"{pre}.conv_in", p["conv_in"])
        _vae_mid(sd, f"{pre}.mid_block", p["mid"])
        _affine(sd, f"{pre}.conv_norm_out", p["norm_out"])
        _vae_conv(sd, f"{pre}.conv_out", p["conv_out"])
        i = 0
        while f"{level}{i}_res0" in p:
            blk = f"{pre}.{level}_blocks.{i}"
            for j in range(n_res):
                _vae_resnet(sd, f"{blk}.resnets.{j}", p[f"{level}{i}_res{j}"])
            if f"{level}{i}_conv" in p:
                _vae_conv(sd, f"{blk}.{level}samplers.0.conv",
                          p[f"{level}{i}_conv"])
            i += 1
    _vae_conv(sd, "quant_conv", params["quant_conv"])
    _vae_conv(sd, "post_quant_conv", params["post_quant_conv"])
    return sd


def clip_state_dict_from_jax(params: dict) -> dict:
    """``clip_jax`` params (numpy leaves) -> the ``CLIPTextModel`` names of
    ``data.clip_text`` (no ``text_model.`` prefix).  The JAX tower keeps its
    weights as torch does (``x @ w.T``), so they copy as they are."""
    sd = {"embeddings.token_embedding.weight": _tensor(params["token_embedding"]),
          "embeddings.position_embedding.weight":
              _tensor(params["position_embedding"])}
    _affine(sd, "final_layer_norm", params["final_ln"])
    i = 0
    while f"block{i}" in params:
        b, pre = params[f"block{i}"], f"encoder.layers.{i}"
        _affine(sd, f"{pre}.layer_norm1", b["ln1"])
        _affine(sd, f"{pre}.layer_norm2", b["ln2"])
        for jax_name, name in (("q", "q_proj"), ("k", "k_proj"),
                               ("v", "v_proj"), ("out", "out_proj")):
            sd[f"{pre}.self_attn.{name}.weight"] = _tensor(
                b["attn"][f"{jax_name}_w"])
            sd[f"{pre}.self_attn.{name}.bias"] = _tensor(
                b["attn"][f"{jax_name}_b"])
        for fc in ("fc1", "fc2"):
            sd[f"{pre}.mlp.{fc}.weight"] = _tensor(b[f"{fc}_w"])
            sd[f"{pre}.mlp.{fc}.bias"] = _tensor(b[f"{fc}_b"])
        i += 1
    return sd


# -------------------------------------------------------------- metric nets --

def _conv_bn(sd: dict, conv: str, bn: str, p: dict, perm):
    sd[f"{conv}.weight"] = _tensor(np.transpose(np.asarray(p["w"]), perm))
    sd[f"{bn}.weight"] = _tensor(p["bn_scale"])
    sd[f"{bn}.bias"] = _tensor(p["bn_bias"])
    sd[f"{bn}.running_mean"] = _tensor(p["bn_mean"])
    sd[f"{bn}.running_var"] = _tensor(p["bn_var"])


def inception_state_dict_from_jax(params: dict) -> dict:
    """``inception_jax`` params -> torch-fidelity FID-Inception names."""
    from zigma_tpu_torch.metrics.inception import CONV_SPECS

    sd: dict = {}
    for name in CONV_SPECS:
        _conv_bn(sd, f"{name}.conv", f"{name}.bn", params[name], (3, 2, 0, 1))
    sd["fc.weight"] = _tensor(params["fc"]["w"])
    sd["fc.bias"] = _tensor(params["fc"]["b"])
    return sd


def dinov2_state_dict_from_jax(params: dict) -> dict:
    """``dinov2_jax`` params -> the dinov2 hub names (no ``mask_token``)."""
    sd = {"patch_embed.proj.weight": _tensor(np.transpose(
              np.asarray(params["patch_embed"]["w"]), (3, 2, 0, 1))),
          "patch_embed.proj.bias": _tensor(params["patch_embed"]["b"]),
          "cls_token": _tensor(params["cls_token"]),
          "pos_embed": _tensor(params["pos_embed"])}
    _affine(sd, "norm", params["norm"])
    i = 0
    while f"block{i}" in params:
        b, pre = params[f"block{i}"], f"blocks.{i}"
        _affine(sd, f"{pre}.norm1", b["norm1"])
        _affine(sd, f"{pre}.norm2", b["norm2"])
        for jax_name, name in (("qkv", "qkv"), ("proj", "proj")):
            sd[f"{pre}.attn.{name}.weight"] = _tensor(b["attn"][f"{jax_name}_w"])
            sd[f"{pre}.attn.{name}.bias"] = _tensor(b["attn"][f"{jax_name}_b"])
        for fc in ("fc1", "fc2"):
            sd[f"{pre}.mlp.{fc}.weight"] = _tensor(b[f"mlp_{fc}_w"])
            sd[f"{pre}.mlp.{fc}.bias"] = _tensor(b[f"mlp_{fc}_b"])
        sd[f"{pre}.ls1.gamma"] = _tensor(b["ls1"])
        sd[f"{pre}.ls2.gamma"] = _tensor(b["ls2"])
        i += 1
    return sd


def i3d_state_dict_from_jax(params: dict) -> dict:
    """``i3d_jax`` params -> pytorch-i3d names."""
    from zigma_tpu_torch.metrics.i3d import UNIT_SPECS

    sd: dict = {}
    for name in UNIT_SPECS:
        _conv_bn(sd, f"{name}.conv3d", f"{name}.bn", params[name],
                 (4, 3, 0, 1, 2))
    sd["logits.conv3d.weight"] = _tensor(np.transpose(
        np.asarray(params["logits"]["w"]), (4, 3, 0, 1, 2)))
    sd["logits.conv3d.bias"] = _tensor(params["logits"]["b"])
    return sd


def lpips_state_dicts_from_jax(params: dict):
    """``lpips_jax`` params -> (torchvision AlexNet ``features.*`` state
    dict, lpips ``alex.pth`` heads ``lin{i}.model.1.weight``)."""
    alex, heads = {}, {}
    for i, fi in enumerate((0, 3, 6, 8, 10)):
        _vae_conv(alex, f"features.{fi}", params[f"conv{i}"])
    i = 0
    while f"lin{i}" in params:
        w = np.asarray(params[f"lin{i}"]["w"])
        heads[f"lin{i}.model.1.weight"] = _tensor(w.reshape(1, -1, 1, 1))
        i += 1
    return alex, heads
