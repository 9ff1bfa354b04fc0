"""The StyleGAN-V ``i3d_torchscript.pt`` FVD detector's weights as a state
dict of the port's ``InceptionI3d``.

Counterpart of ``zigma_tpu/convert/torchscript_i3d.py``.  The reference's
gating FVD loads this archive and calls it with ``rescale=False,
resize=False, return_features=True`` (reference:
utils/torchmetric_fvd.py:169-186).  The network inside is the
Kinetics-400 Inception-v1 I3D of ``metrics/i3d.py``; the archive is read
with ``torch.jit.load`` and never run.  Two mappings, tried in order:

1. **By name**: pytorch-i3d's names (``Mixed_3b.b1a.conv3d.weight``,
   ``...bn.running_mean``) after normalising separators, case and
   ``module.`` / ``detector.`` / ``model.`` prefixes.
2. **By order and shape**: a TorchScript state dict keeps the modules'
   registration order.  The flat tensor list is cut at every 5-D conv
   weight; a unit's trailing 1-D tensors are its BN fields in torch's order
   (weight, bias, running_mean, running_var) or the logits bias.  Units are
   matched by conv shape, greedily in registration order (duplicate shapes
   exist; pytorch-i3d registers ``logits`` before the trunk).

Both end in the shape check of ``InceptionI3d``'s own state dict, so a
non-I3D archive fails instead of giving features.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from zigma_tpu_torch.metrics import i3d

__all__ = ["convert_torchscript_i3d", "state_dict_from_torchscript"]


def state_dict_from_torchscript(path: str) -> Dict[str, np.ndarray]:
    """``torch.jit.load`` a TorchScript archive (or ``torch.load`` a raw
    state dict) and return its ordered {name: ndarray} state dict."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _piergiaj_keys():
    for name in i3d.UNIT_SPECS:
        yield f"{name}.conv3d.weight"
        for f in ("weight", "bias", "running_mean", "running_var"):
            yield f"{name}.bn.{f}"
    yield "logits.conv3d.weight"
    yield "logits.conv3d.bias"


def _normalize_names(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Key spelling to pytorch-i3d's where it maps: prefixes dropped, '/'
    read as '.', case and separators ignored."""
    canon = {re.sub(r"[^a-z0-9]+", "", k.lower()): k
             for k in _piergiaj_keys()}
    out = {}
    for k, v in sd.items():
        k2 = k
        for prefix in ("module.", "detector.", "model."):
            if k2.startswith(prefix):
                k2 = k2[len(prefix):]
        key = re.sub(r"[^a-z0-9]+", "", k2.replace("/", ".").lower())
        out[canon.get(key, k2)] = v
    return out


def _by_name(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The pytorch-i3d keys of ``sd`` (``num_batches_tracked`` and other
    extras dropped); KeyError when one is missing."""
    sd = _normalize_names(sd)
    missing = [k for k in _piergiaj_keys() if k not in sd]
    if missing:
        raise KeyError(f"missing {len(missing)} keys, e.g. {missing[:4]}")
    return {k: sd[k] for k in _piergiaj_keys()}


def _by_order(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    units: list = []  # [conv_w, [1-D tensors], matched]
    for v in sd.values():
        v = np.asarray(v)
        if v.ndim == 5:
            units.append([v, [], False])
        elif v.ndim == 1 and v.size > 1 and units:
            units[-1][1].append(v)
        # scalars (num_batches_tracked) and what precedes the first conv
        # are ignored
    expected = list(i3d.UNIT_SPECS.items())
    if len(units) != len(expected) + 1:
        raise KeyError(
            f"expected {len(expected) + 1} conv units in the archive, "
            f"found {len(units)} — not an InceptionI3d graph?")

    def take(shape):
        for unit in units:
            if not unit[2] and unit[0].shape == shape:
                unit[2] = True
                return unit
        raise KeyError(f"no unmatched conv unit of shape {shape}")

    out = {}
    for name, (cin, cout, (kt, kh, kw), _) in expected:
        w, ones, _ = take((cout, cin, kt, kh, kw))
        bn = [t for t in ones if t.shape == (cout,)]
        if len(bn) < 4:
            raise KeyError(f"{name}: found {len(bn)} BN tensors, need 4")
        out[f"{name}.conv3d.weight"] = w
        for f, t in zip(("weight", "bias", "running_mean", "running_var"),
                        bn):
            out[f"{name}.bn.{f}"] = t
    w, ones, _ = take((i3d.NUM_CLASSES, 1024, 1, 1, 1))
    bias = [t for t in ones if t.shape == (i3d.NUM_CLASSES,)]
    if not bias:
        raise KeyError("logits conv has no bias vector")
    out["logits.conv3d.weight"], out["logits.conv3d.bias"] = w, bias[0]
    return out


def convert_torchscript_i3d(source) -> Dict[str, torch.Tensor]:
    """Archive path / torch module / state dict -> a float32 state dict that
    ``metrics.i3d.InceptionI3d`` loads with ``strict=True``."""
    if isinstance(source, str):
        sd = state_dict_from_torchscript(source)
    elif hasattr(source, "state_dict"):
        sd = {k: v.detach().cpu().numpy()
              for k, v in source.state_dict().items()}
    else:
        sd = {k: np.asarray(getattr(v, "numpy", lambda: v)())
              for k, v in source.items()}
    try:
        out = _by_name(sd)
    except KeyError:
        out = _by_order(sd)
    want = {k: tuple(v.shape) for k, v in i3d.InceptionI3d().state_dict()
            .items() if not k.endswith("num_batches_tracked")}
    for k, s in want.items():
        got = tuple(np.shape(out[k]))
        if got != s:
            raise ValueError(f"{k}: shape {got} != expected {s}")
    return {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in
            out.items()}
