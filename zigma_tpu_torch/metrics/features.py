"""Pluggable feature extractors for the Fréchet / KID / PRDC / IS metrics.

Counterpart of ``zigma_tpu/metrics/features.py``.  The metric maths is
exact; the feature net is a plug-in, because pretrained weights may be
absent (nothing is ever downloaded).  Resolution order of ``get_extractor``:

1. A callable registered with ``register_extractor``.
2. The port's own nets (``metrics/{inception,dinov2,i3d}.py``) from a
   locally cached torch state dict: the file named by the environment
   variable (``ZIGMA_INCEPTION_WEIGHTS``, ``ZIGMA_DINOV2_WEIGHTS``,
   ``ZIGMA_I3D_WEIGHTS``), then a matching ``.pt`` / ``.pth`` under the
   torch hub cache (``torch.hub.get_dir()``) and, for Inception,
   ``~/.cache/torch_fidelity``.
3. A cached TorchScript archive run as it is (Inception, I3D), on the
   device.  The StyleGAN-V I3D archive (``ZIGMA_I3D_TORCHSCRIPT`` or a
   TorchScript ``*i3d*`` file in the hub cache) is read into the port's I3D
   by ``convert.torchscript_i3d`` instead.  The JAX package's second DINOv2
   route, ``torch.hub.load`` of the hub repository, can fetch from the
   network and is not ported: DINOv2 has the state-dict route only.
4. Otherwise ``get_extractor`` raises: a FID computed with another net is
   not comparable to published numbers.

Every net runs on the device it is resolved for (``device``; None means
CUDA through ``resolve_device``); no route falls back to the CPU.  A
resolved net is a ``NetExtractor``: callable on numpy, with its net, its
device and the seconds it spent (host copies apart) for the CLIs' timing.

Input contract (the same for every route of a name):

- ``inception*`` / ``dinov2``: (B, C, H, W) uint8 or float in [0, 255];
- ``i3d*``: (B, T, H, W, C) uint8 videos in [0, 255].
"""

from __future__ import annotations

import os
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from zigma_tpu_torch.device import resolve_device

__all__ = ["register_extractor", "get_extractor", "available_extractors",
           "patch_statistics_extractor", "video_patch_statistics_extractor",
           "NetExtractor"]

_REGISTRY: dict = {}   # name -> callable, registered by the caller
_RESOLVED: dict = {}   # (name, device) -> NetExtractor from local weights


def register_extractor(name: str, fn: Callable[[np.ndarray], np.ndarray]):
    """Register a feature extractor: (B, C, H, W) uint8/float -> (B, F)."""
    _REGISTRY[name] = fn


def available_extractors():
    return sorted(_REGISTRY)


class NetExtractor:
    """numpy in, numpy out, through ``fn`` on ``device`` in chunks of
    ``batch``.  ``fn`` takes the chunk as a tensor on the device (uint8 or
    float, as given) and returns (b, F) features there.  ``seconds`` and
    ``copy_seconds`` add up the time of the net (preprocessing on the
    device included) and of the host <-> device copies; ``reset_timers``
    zeroes them."""

    def __init__(self, name: str, net: torch.nn.Module, fn: Callable,
                 device, batch: int, image: bool = True):
        self.name, self.net, self.fn = name, net, fn
        self.device = torch.device(device)
        self.batch, self.image = batch, image
        self.reset_timers()

    def reset_timers(self):
        self.seconds = 0.0
        self.copy_seconds = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def __call__(self, arr) -> np.ndarray:
        arr = np.asarray(arr)
        if self.image and arr.ndim == 3:
            arr = arr[None]
        outs = []
        for i in range(0, arr.shape[0], self.batch):
            t0 = time.perf_counter()
            x = torch.from_numpy(np.ascontiguousarray(
                arr[i:i + self.batch])).to(self.device)
            self._sync()
            t1 = time.perf_counter()
            y = self.fn(x)
            self._sync()
            t2 = time.perf_counter()
            outs.append(y.float().cpu().numpy())
            t3 = time.perf_counter()
            self.seconds += t2 - t1
            self.copy_seconds += (t1 - t0) + (t3 - t2)
        return np.concatenate(outs, axis=0)


def patch_statistics_extractor(patch: int = 8):
    """Weight-free fallback features (mean/std over a patch grid).

    NOT comparable to Inception features — intended only for smoke tests
    and relative tracking during training when no pretrained weights exist.
    """

    def extract(imgs: np.ndarray) -> np.ndarray:
        x = np.asarray(imgs, np.float64)
        if x.ndim == 3:
            x = x[None]
        B, C, H, W = x.shape
        ph, pw = H // patch, W // patch
        x = x[:, :, : ph * patch, : pw * patch]
        x = x.reshape(B, C, ph, patch, pw, patch)
        mean = x.mean(axis=(3, 5)).reshape(B, -1)
        std = x.std(axis=(3, 5)).reshape(B, -1)
        return np.concatenate([mean, std], axis=1)

    return extract


def video_patch_statistics_extractor(patch: int = 8):
    """Weight-free video features: per-frame patch statistics pooled over
    time plus mean |temporal delta| (so motion differences register, which
    frame-pooled statistics alone would miss).

    Input: (B, T, H, W, C) videos (the VideoMetric extractor contract).
    NOT comparable to I3D FVD features — the degraded-tracking analogue of
    ``patch_statistics_extractor`` for video runs without cached weights.
    """
    frame_fn = patch_statistics_extractor(patch)

    def extract(videos: np.ndarray) -> np.ndarray:
        v = np.asarray(videos, np.float64)
        if v.ndim != 5:
            raise ValueError(
                f"expected (B, T, H, W, C) videos, got shape {v.shape}")
        B, T = v.shape[:2]
        # (B, T, H, W, C) -> (B*T, C, H, W) for the image extractor
        frames = v.transpose(0, 1, 4, 2, 3).reshape(
            B * T, v.shape[4], v.shape[2], v.shape[3])
        f = frame_fn(frames).reshape(B, T, -1)
        delta = (np.abs(np.diff(f, axis=1)).mean(axis=1) if T > 1
                 else np.zeros_like(f[:, 0]))
        return np.concatenate([f.mean(axis=1), delta], axis=1)

    return extract


# ---------------------------------------------------------------------------
# weight-cache probing
# ---------------------------------------------------------------------------

FIDELITY_CACHE = os.path.join("~", ".cache", "torch_fidelity")


def _weight_candidates(env_var: Optional[str], match: Callable[[str], bool],
                       extra_roots: Iterable[str] = (),
                       suffixes=(".pt", ".pth")) -> Iterable[str]:
    """The env-var override first, then every matching file under the
    torch hub cache (and ``extra_roots``)."""
    explicit = os.environ.get(env_var) if env_var else None
    if explicit:
        yield explicit
    roots = [os.path.expanduser(r) for r in extra_roots]
    roots.append(torch.hub.get_dir())
    for r in roots:
        if not os.path.isdir(r):
            continue
        for root, _, files in os.walk(r):
            for f in sorted(files):
                if match(f.lower()) and f.endswith(suffixes):
                    yield os.path.join(root, f)


def _load_state_dict(path: str) -> dict:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if not isinstance(sd, dict):
        raise ValueError(f"{path} holds no state dict")
    return sd


def _load_net(env_var: str, match: Callable[[str], bool], build: Callable,
              extra_roots: Iterable[str] = ()):
    """``build(state_dict)`` of the first candidate that loads cleanly
    (TorchScript archives and unrelated checkpoints fail and are
    skipped), or None."""
    for cand in _weight_candidates(env_var, match, extra_roots):
        try:
            return build(_load_state_dict(cand))
        except Exception:
            continue
    return None


def _jit_candidates(match: Callable[[str], bool], device,
                    extra_roots: Iterable[str] = ()):
    for cand in _weight_candidates(None, match, extra_roots,
                                   suffixes=(".pt", ".pts", ".pth")):
        try:
            yield torch.jit.load(cand, map_location=device).eval()
        except Exception:
            continue  # a raw state dict (.pth), not TorchScript


def _net_inception(feature: str, device) -> Optional[NetExtractor]:
    """The port's FID InceptionV3 from a local raw state dict.  feature:
    '2048' (FID/KID/PRDC), '768' (sFID), 'logits_unbiased' (IS)."""
    from zigma_tpu_torch.metrics import inception

    net = _load_net("ZIGMA_INCEPTION_WEIGHTS", lambda f: "inception" in f,
                    lambda sd: inception.from_state_dict(sd, device),
                    extra_roots=[FIDELITY_CACHE])
    return None if net is None else inception.inception_extractor(
        net, feature=feature)


def _jit_inception(device) -> Optional[NetExtractor]:
    """A torch-fidelity / StyleGAN FID-Inception TorchScript archive, fed
    uint8 images on ``device``."""
    for net in _jit_candidates(lambda f: "inception" in f, device,
                               extra_roots=[FIDELITY_CACHE]):
        return NetExtractor("inception:torchscript", net,
                            lambda x: net(x.to(torch.uint8)), device, 64)
    return None


def _net_dinov2(device) -> Optional[NetExtractor]:
    """The port's DINOv2 ViT-L/14 from a local state dict
    (``dinov2_vitl14_pretrain.pth`` family)."""
    from zigma_tpu_torch.metrics import dinov2

    net = _load_net("ZIGMA_DINOV2_WEIGHTS",
                    lambda f: "dinov2" in f and "vitl14" in f,
                    lambda sd: dinov2.from_state_dict(sd, "vitl14", device))
    return None if net is None else dinov2.dinov2_extractor(net)


def _net_i3d(device) -> Optional[NetExtractor]:
    """The port's InceptionI3d from a local raw state dict
    (``i3d_pretrained_400`` family): the videogpt FVD flavour."""
    from zigma_tpu_torch.metrics import i3d

    net = _load_net("ZIGMA_I3D_WEIGHTS", lambda f: "i3d" in f,
                    lambda sd: i3d.from_state_dict(sd, device))
    return None if net is None else i3d.i3d_extractor(net)


def _jit_i3d(device) -> Optional[NetExtractor]:
    """An I3D TorchScript archive run as it is, behind the videogpt
    preprocessing."""
    from zigma_tpu_torch.metrics import i3d

    for net in _jit_candidates(lambda f: "i3d" in f, device):
        return NetExtractor("i3d:torchscript", net,
                            lambda v: net(i3d.fvd_preprocess(v)), device, 8,
                            image=False)
    return None


def _net_i3d_styleganv(device) -> Optional[NetExtractor]:
    """The StyleGAN-V FVD flavour: weights from a local
    ``i3d_torchscript.pt`` archive read into the port's I3D, and the gating
    preprocessing (aspect-distorting 224 resize, values left in [0, 255])."""
    from zigma_tpu_torch.convert.torchscript_i3d import convert_torchscript_i3d
    from zigma_tpu_torch.metrics import i3d

    explicit = os.environ.get("ZIGMA_I3D_TORCHSCRIPT")
    for cand in _weight_candidates("ZIGMA_I3D_TORCHSCRIPT",
                                   lambda f: "i3d" in f):
        # a cache-scan candidate must be a TorchScript archive: the raw
        # videogpt state dict would otherwise pair videogpt weights with
        # the styleganv preprocessing.  A file named by the variable is
        # trusted as styleganv.
        if cand != explicit:
            try:
                cand = torch.jit.load(cand, map_location="cpu")
            except Exception:
                continue
        try:
            sd = convert_torchscript_i3d(cand)
            net = i3d.from_state_dict(sd, device)
        except Exception:
            continue
        return i3d.styleganv_extractor(net)
    return None


def get_extractor(name: str = "inception", device=None) -> Callable:
    """Resolve a named extractor on ``device`` (None: CUDA); see the module
    docstring for the order and the per-name input contracts."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name == "patch_stats":
        fn = patch_statistics_extractor()
        _REGISTRY[name] = fn
        return fn
    device = resolve_device(device)
    key = (name, str(device))
    if key in _RESOLVED:
        return _RESOLVED[key]
    fn = None
    if name in ("inception", "inception_sfid", "inception_logits"):
        feature = {"inception": "2048", "inception_sfid": "768",
                   "inception_logits": "logits_unbiased"}[name]
        fn = _net_inception(feature, device)
        if fn is None and name == "inception":
            fn = _jit_inception(device)
    elif name == "dinov2":
        fn = _net_dinov2(device)
    elif name == "i3d":
        fn = _net_i3d(device) or _jit_i3d(device)
    elif name == "i3d_styleganv":
        fn = _net_i3d_styleganv(device)
    if fn is not None:
        _RESOLVED[key] = fn
        return fn
    raise RuntimeError(
        f"feature extractor {name!r} is unavailable: no registered callable "
        f"and no local pretrained weights found. Register one with "
        f"zigma_tpu_torch.metrics.register_extractor({name!r}, fn) — fn maps "
        f"(B, C, H, W) images to (B, F) features. For smoke tests use "
        f"'patch_stats' (weight-free, NOT comparable to published FID).")
