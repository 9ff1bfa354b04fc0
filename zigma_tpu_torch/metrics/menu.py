"""The CLIs' metric-menu construction with per-choice degradation.

The reference builds its evaluation metric set in its train / sample
scripts:

- in-training (reference: train_acc.py:398-405):
  video  -> ``MyMetric(choices=["fid", "fvd"], video_frame=T)``
  images -> ``MyMetric(choices=["fid", "is", "kid", "prdc", "sfid", "fdd"])``
- offline sampling (reference: sample_acc.py:82-90):
  video  -> ``MyMetric(choices=["fvd"])``, else ``["fid"]``
- its FVD branch receives FOLDED frames ``(b t, c, h, w)`` and rearranges
  back to video with ``video_frame`` (reference: my_metrics.py:58-69); the
  image metrics in the same container see per-frame updates.

This rebuild keeps image metrics (``MyMetric``) and FVD (``VideoMetric``)
as separate containers (facade.py) and composes them here.  The suite's
update contract is the CLIs' natural array layout — ``(B, C, H, W)``
images or ``(B, T, C, H, W)`` videos, uint8 pixels (or float latents in
the degraded patch-stats mode) — and the suite does the frame
folding/layout mapping internally.

Degradation policy (this environment may have no pretrained weights; the
reference simply crashes without them):

- fid/kid/prdc ride the main feature stream: canonical Inception when
  cached, else the weight-free patch-statistics extractor (warned; NOT
  comparable to published numbers).
- is/sfid/fdd are DEFINED by their specific networks (Inception logits,
  Mixed-6e slice, DINOv2); when those are unavailable the choice is
  dropped with a warning instead of silently computing something else.
- fvd uses the canonical I3D detector when cached; on latents or without
  weights it degrades to weight-free video patch statistics (temporal
  deltas included) so video runs still track a motion-aware number.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np

from zigma_tpu_torch.metrics.facade import MyMetric, VideoMetric
from zigma_tpu_torch.metrics.features import (
    get_extractor,
    patch_statistics_extractor,
    video_patch_statistics_extractor,
)

__all__ = ["MetricSuite", "build_metric_suite", "validate_choices",
           "REFERENCE_IMAGE_MENU", "REFERENCE_VIDEO_MENU"]

# the reference's in-training menus (train_acc.py:398-405)
REFERENCE_IMAGE_MENU = ("fid", "is", "kid", "prdc", "sfid", "fdd")
REFERENCE_VIDEO_MENU = ("fid", "fvd")


class MetricSuite:
    """Composed image + video metric container with the MyMetric API.

    update_real/update_fake accept (B, C, H, W) images or (B, T, C, H, W)
    videos; videos are folded to frames for the image container (the
    reference feeds per-frame updates, my_metrics.py:58-69) and passed as
    (B, T, H, W, C) to the video container (the VideoMetric extractor
    contract).
    """

    def __init__(self, image: Optional[MyMetric] = None,
                 video: Optional[VideoMetric] = None,
                 dropped: Sequence[str] = ()):
        self.image = image
        self.video = video
        self.dropped = tuple(dropped)

    @property
    def empty(self) -> bool:
        return self.image is None and self.video is None

    @property
    def choices(self):
        out = list(self.image.choices) if self.image is not None else []
        if self.video is not None:
            out.append("fvd")
        return out

    @staticmethod
    def _split(arr):
        arr = np.asarray(arr)
        if arr.ndim == 5:  # (B, T, C, H, W)
            frames = arr.reshape((-1,) + arr.shape[2:])
            videos = arr.transpose(0, 1, 3, 4, 2)  # -> (B, T, H, W, C)
            return frames, videos
        return arr, None

    def update_real(self, arr):
        frames, videos = self._split(arr)
        if self.image is not None:
            self.image.update_real(frames)
        if self.video is not None and videos is not None:
            self.video.update_real(videos)

    def update_fake(self, arr):
        frames, videos = self._split(arr)
        if self.image is not None:
            self.image.update_fake(frames)
        if self.video is not None and videos is not None:
            self.video.update_fake(videos)

    def compute(self, sync: bool = True) -> dict:
        out = {}
        if self.image is not None:
            out.update(self.image.compute(sync=sync))
        if self.video is not None:
            out.update(self.video.compute(sync=sync))
        return out

    def reset(self):
        if self.image is not None:
            self.image.reset()
        if self.video is not None:
            self.video.reset()


def _probe(name: str, device=None):
    try:
        return get_extractor(name, device)
    except RuntimeError:
        return None


def validate_choices(choices: Optional[Sequence[str]] = None,
                     video: bool = False) -> list:
    """Config-time validation of a metric-choice list: raises ValueError
    on unknown names or 'fvd' in an image run.  The CLIs call this at
    startup so a typo'd ``eval_metrics`` fails before training, not at
    the first eval boundary thousands of steps in.  None selects the
    reference's menu for the run kind.  Returns the validated list."""
    if choices is None:
        choices = REFERENCE_VIDEO_MENU if video else REFERENCE_IMAGE_MENU
    choices = list(choices)
    unknown = set(choices) - {"fid", "sfid", "kid", "is", "prdc", "fdd",
                              "fvd"}
    if unknown:
        raise ValueError(f"unknown metric choices: {sorted(unknown)}")
    if "fvd" in choices and not video:
        raise ValueError(
            "metric 'fvd' requires a video run (5-D samples); it cannot "
            "be computed for an image config (reference sample_acc.py:82-90 "
            "builds it only for video runs)")
    return choices


def build_metric_suite(*, choices: Optional[Sequence[str]] = None,
                       video: bool = False, in_pixels: bool = True,
                       logger: Optional[logging.Logger] = None,
                       kid_subset_size: int = 50,
                       prdc_k: int = 5, device=None) -> MetricSuite:
    """Build the evaluation metric set the way the reference's scripts do.

    choices: explicit metric list; None selects the reference's menu for
      the run kind (REFERENCE_VIDEO_MENU for video, REFERENCE_IMAGE_MENU
      otherwise).
    video: whether updates will be (B, T, C, H, W) videos ("fvd" on an
      image run is a config error and raises).
    in_pixels: updates are uint8 pixels (VAE-decoded).  False = raw float
      latents: every choice degrades/drops per the module docstring.
    device: where the canonical nets run (None: CUDA).

    Returns a MetricSuite; ``suite.empty`` when nothing survived,
    ``suite.dropped`` names the choices that degraded away.
    """
    log = logger or logging.getLogger(__name__)
    choices = validate_choices(choices, video=video)

    image_choices = [c for c in choices if c != "fvd"]
    kept, dropped = [], []
    extractor = None       # None -> MyMetric resolves canonical nets
    logits_extractor = None

    main_needed = any(c in image_choices for c in ("fid", "kid", "prdc"))
    degraded_main = False
    if main_needed:
        if not in_pixels or _probe("inception", device) is None:
            extractor = patch_statistics_extractor()
            degraded_main = True
            log.warning(
                "fid/kid/prdc tracking weight-free patch statistics%s — "
                "NOT comparable to published numbers",
                "" if in_pixels else " on raw latents")

    stream_extractors = {}
    for c in image_choices:
        if c in ("fid", "kid", "prdc"):
            kept.append(c)
            continue
        # is/sfid/fdd are defined by their nets; no degraded substitute.
        # Gating is per-choice: each probes its OWN net — fdd stays
        # canonical when DINOv2 is cached even if the main fid stream
        # degraded for lack of Inception weights
        if not in_pixels:
            dropped.append(c)
            continue
        need = {"is": "inception_logits", "sfid": "inception_sfid",
                "fdd": "dinov2"}[c]
        fn = _probe(need, device)
        if fn is None:
            dropped.append(c)
        else:
            kept.append(c)
            if c == "is":
                logits_extractor = fn
            elif degraded_main:
                # main extractor override would otherwise hijack this
                # choice's stream (facade.py extractor contract)
                stream_extractors[c] = fn
    for c in dropped:
        log.warning("metric %r dropped: its feature net is unavailable "
                    "(weights not cached%s)", c,
                    "" if in_pixels else " / raw-latent inputs")

    image = None
    if kept:
        image = MyMetric(choices=kept, extractor=extractor,
                         logits_extractor=logits_extractor,
                         kid_subset_size=kid_subset_size, prdc_k=prdc_k,
                         stream_extractors=stream_extractors or None,
                         device=device)

    video_metric = None
    if "fvd" in choices:
        if in_pixels:
            try:
                video_metric = VideoMetric(device=device)
            except RuntimeError:
                pass
        if video_metric is None:
            log.warning(
                "fvd tracking weight-free video patch statistics%s — NOT "
                "comparable to published FVD",
                "" if in_pixels else " on raw latents")
            video_metric = VideoMetric(
                extractor=video_patch_statistics_extractor(),
                flavor="patch_stats")

    return MetricSuite(image=image, video=video_metric, dropped=dropped)
