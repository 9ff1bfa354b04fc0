"""MyMetric facade: choice-gated metric container with the reference's API.

API parity with the reference (reference: my_metrics.py:13-115):

    metric = MyMetric(choices=["fid", "kid"], extractor=...)
    metric.update_real(imgs_uint8)   # (B, C, H, W) uint8 or [0,255] float
    metric.update_fake(samples)
    result = metric.compute()        # {"fid": ..., "kid": ..., "kid_std": ...}
    metric.reset()

Distributed: ``compute(sync=True)`` all-gathers the feature statistics
across the ``torch.distributed`` processes when a process group is
initialised (the torchmetrics ``sync_on_compute=True`` equivalent,
my_metrics.py:22); without one the local arrays are the whole set.

Counterpart of ``zigma_tpu/metrics/facade.py``: the same containers and
arithmetic, with ``torch.distributed`` (``all_gather_object``) where the JAX
package uses ``multihost_utils.process_allgather``, and each container's
nets resolved on its ``device`` (None: CUDA).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from zigma_tpu_torch.metrics.distributional import inception_score, kid, prdc
from zigma_tpu_torch.metrics.frechet import RunningMoments, frechet_distance

__all__ = ["MyMetric", "VideoMetric", "to_uint8_images"]


def to_uint8_images(arr: np.ndarray) -> np.ndarray:
    """[-1, 1] float images -> uint8 [0, 255], the reference's conversion
    before every metric update (train_acc.py:45, sample_acc.py:319,384-385).
    The feature extractors' input contract is uint8/[0,255] (features.py)."""
    return np.clip(127.5 * np.asarray(arr, np.float32) + 128.0,
                   0, 255).astype(np.uint8)

_KNOWN = ("fid", "sfid", "kid", "is", "prdc", "fdd", "fvd")


def _world_size() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _all_gather(obj) -> list:
    """Every process's ``obj``, in rank order."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


class MyMetric:
    """Image-quality metric container.

    choices: subset of fid/sfid/kid/is/prdc/fdd (fvd via VideoMetric).
    extractor: (B, C, H, W) -> (B, F) feature callable (see features.py).
    logits_extractor: only needed for "is".
    device: where the canonical nets run (None: CUDA).
    """

    def __init__(self, choices: Sequence[str] = ("fid",),
                 extractor: Optional[Callable] = None,
                 logits_extractor: Optional[Callable] = None,
                 kid_subset_size: int = 50, prdc_k: int = 5,
                 max_stored: int = 50_000,
                 stream_extractors: Optional[dict] = None, device=None):
        unknown = set(choices) - set(_KNOWN)
        if unknown:
            raise ValueError(f"unknown metric choices: {unknown}")
        self.choices = list(choices)

        # Each Frechet-family choice needs ITS OWN feature net (fid: 2048-d
        # Inception pool, sfid: spatial Mixed-6e slice, fdd: DINOv2, fvd:
        # I3D) and its own moments, exactly like the reference's separate
        # torchmetrics (my_metrics.py:24-57).  An explicitly passed
        # ``extractor`` overrides ALL image streams (custom/smoke use);
        # otherwise each choice resolves its canonical net.
        from zigma_tpu_torch.metrics.features import get_extractor

        if "fvd" in choices and extractor is None and type(self) is MyMetric:
            raise ValueError(
                "fvd needs video-shaped features: use VideoMetric (or pass "
                "an explicit video extractor)")
        self._stream_of = {}   # choice -> stream name
        self.extractors = {}   # stream name -> callable
        main = extractor
        for c in self.choices:
            if c == "is":
                continue
            own = (stream_extractors or {}).get(c)
            if own is not None and c in ("sfid", "fdd"):
                # per-choice net override: keeps sfid/fdd on their own
                # canonical streams even when the MAIN stream was replaced
                # (e.g. degraded to patch statistics with DINOv2 cached)
                stream = c
                self.extractors.setdefault(stream, own)
            elif extractor is None and c in ("sfid", "fdd"):
                stream = c
                self.extractors.setdefault(
                    stream,
                    get_extractor({"sfid": "inception_sfid",
                                   "fdd": "dinov2"}[c], device))
            else:
                stream = "main"
                if main is None:
                    main = get_extractor("inception", device)
                self.extractors.setdefault(stream, main)
            self._stream_of[c] = stream
        if not self.extractors:  # "is"-only containers still accept updates
            self.extractors["main"] = (main if main is not None
                                       else get_extractor("inception", device))
        self.extractor = self.extractors.get("main")  # back-compat attr
        self.logits_extractor = logits_extractor
        self.kid_subset_size = kid_subset_size
        self.prdc_k = prdc_k
        self.max_stored = max_stored
        self.reset()

    # -- accumulation -------------------------------------------------------

    def reset(self):
        self.real_feats: list = []
        self.fake_feats: list = []
        self.fake_logits: list = []
        self.n_real = 0
        self.n_fake = 0
        self.real_mom: dict = {}   # stream -> RunningMoments
        self.fake_mom: dict = {}

    def _feats(self, imgs, stream="main"):
        f = np.asarray(self.extractors[stream](np.asarray(imgs)))
        assert f.ndim == 2, f.shape
        return f

    def _need_raw(self):
        return any(c in self.choices for c in ("kid", "prdc"))

    def _update(self, imgs, moments: dict) -> Optional[np.ndarray]:
        """Run every stream's extractor once, fold into ``moments``;
        returns the main-stream features (for kid/prdc raw storage)."""
        imgs = np.asarray(imgs)
        main_f = None
        for stream in self.extractors:
            f = self._feats(imgs, stream)
            if stream not in moments:
                moments[stream] = RunningMoments(f.shape[1])
            moments[stream].update(f)
            if stream == "main":
                main_f = f
        return main_f

    def update_real(self, imgs):
        f = self._update(imgs, self.real_mom)
        self.n_real += np.asarray(imgs).shape[0]
        if f is not None and self._need_raw() and self.n_real <= self.max_stored:
            self.real_feats.append(f)

    def update_fake(self, imgs):
        f = self._update(imgs, self.fake_mom)
        self.n_fake += np.asarray(imgs).shape[0]
        if f is not None and self._need_raw() and self.n_fake <= self.max_stored:
            self.fake_feats.append(f)
        if "is" in self.choices:
            if self.logits_extractor is None:
                raise RuntimeError("'is' requires a logits_extractor")
            self.fake_logits.append(np.asarray(self.logits_extractor(imgs)))

    # -- compute -------------------------------------------------------------

    def _gather(self, arrays: list, dim: Optional[int] = None) -> np.ndarray:
        if arrays:
            local = np.concatenate(arrays, axis=0)
        else:
            # the empty placeholder keeps the feature dim of the others
            if dim is None:
                mom = (self.fake_mom.get("main") or self.real_mom.get("main"))
                dim = mom.dim if mom else 1
            local = np.zeros((0, dim), np.float64)
        if _world_size() <= 1:
            return local
        return np.concatenate(
            [np.asarray(a).reshape(-1, local.shape[-1])
             for a in _all_gather(local)], axis=0)

    @staticmethod
    def _merged(mom: RunningMoments) -> RunningMoments:
        merged = RunningMoments(mom.dim)
        for st in _all_gather(mom.state()):
            merged.n += int(st["n"])
            merged.sum += st["sum"]
            merged.outer += st["outer"]
        return merged

    def compute(self, sync: bool = True) -> dict:
        real_mom, fake_mom = self.real_mom, self.fake_mom
        if sync and _world_size() > 1 and real_mom:
            real_mom = {k: self._merged(v) for k, v in real_mom.items()}
            fake_mom = {k: self._merged(v) for k, v in fake_mom.items()}

        out = {}
        for c in ("fid", "sfid", "fdd", "fvd"):
            if c in self.choices:
                stream = self._stream_of[c]
                mu_r, cov_r = real_mom[stream].finalize()
                mu_f, cov_f = fake_mom[stream].finalize()
                out[c] = frechet_distance(mu_r, cov_r, mu_f, cov_f)
        if "kid" in self.choices or "prdc" in self.choices:
            real = self._gather(self.real_feats) if sync else (
                np.concatenate(self.real_feats) if self.real_feats else
                np.zeros((0, 1)))
            fake = self._gather(self.fake_feats) if sync else (
                np.concatenate(self.fake_feats) if self.fake_feats else
                np.zeros((0, 1)))
            if "kid" in self.choices:
                m, s = kid(real, fake, subset_size=self.kid_subset_size)
                out["kid"], out["kid_std"] = m, s
            if "prdc" in self.choices:
                out.update(prdc(real, fake, nearest_k=self.prdc_k))
        if "is" in self.choices:
            if sync:
                dim = (self.fake_logits[0].shape[-1]
                       if self.fake_logits else None)
                logits = self._gather(self.fake_logits, dim=dim)
            else:
                logits = np.concatenate(self.fake_logits, axis=0)
            m, s = inception_score(logits)
            out["is"], out["is_std"] = m, s
        return out


class VideoMetric(MyMetric):
    """FVD-style container: videos (B, T, H, W, C) -> video features
    (the i3d extractor contract, features.py; MetricSuite transposes its
    (B, T, C, H, W) CLI layout before updating this container).

    The reference reshapes videos through a 224-resize then I3D
    (my_metrics.py:58-69); here the extractor owns that mapping:
    extractor(videos) -> (B, F); the inherited update/compute machinery is
    shape-agnostic.

    flavor pins WHICH FVD is computed — the two detectors in the wild give
    different numbers:

    - ``"styleganv"``: the reference's gating metric — the StyleGAN-V
      TorchScript weights + the my_metrics.py:58-69 preprocessing
      (aspect-distorting 224 resize, values left in [0, 255]).
    - ``"videogpt"``: the pytorch-i3d state-dict weights + the
      videogpt fvd.py:21-60 preprocessing (shorter-side resize + center
      crop + [-1, 1]).

    With neither flavor nor extractor given, styleganv is preferred and
    videogpt is the logged fallback.  ``compute()`` names the flavor in
    the result key (``fvd_styleganv`` / ``fvd_videogpt`` / ``fvd_custom``)
    alongside plain ``fvd``, so downstream numbers are never ambiguous.
    """

    def __init__(self, extractor: Optional[Callable] = None,
                 flavor: Optional[str] = None, device=None, **kw):
        if extractor is not None:
            self.flavor = flavor or "custom"
        else:
            from zigma_tpu_torch.metrics.features import get_extractor

            names = {"styleganv": "i3d_styleganv", "videogpt": "i3d"}
            if flavor is not None:
                if flavor not in names:
                    raise ValueError(
                        f"unknown FVD flavor {flavor!r}; expected one of "
                        f"{sorted(names)} (or pass an explicit extractor)")
                extractor = get_extractor(names[flavor], device)
                self.flavor = flavor
            else:
                try:
                    extractor = get_extractor("i3d_styleganv", device)
                    self.flavor = "styleganv"
                except RuntimeError:
                    import logging

                    extractor = get_extractor("i3d", device)  # raises too
                    self.flavor = "videogpt"
                    logging.getLogger(__name__).warning(
                        "no i3d_torchscript.pt cached; FVD falls back to "
                        "the videogpt detector — numbers are NOT comparable "
                        "to the reference's styleganv-flavor FVD")
        super().__init__(choices=["fvd"], extractor=extractor, device=device,
                         **kw)

    def compute(self, sync: bool = True):
        out = super().compute(sync=sync)
        if "fvd" in out:
            out[f"fvd_{self.flavor}"] = out["fvd"]
        return out
