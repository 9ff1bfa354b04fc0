"""Video/image transform utilities and offline feature-prep dataset.

Own numpy + PIL copy of ``zigma_tpu/data/video.py`` (the reference's
torchvision-based video pipeline, datasets/video_utils.py:15-587).  Videos
are numpy arrays (T, C, H, W); images are (C, H, W) or PIL.

The reference's ``DatasetFromCSV`` (video_utils.py:470-560) couples frame
reading with on-the-fly SD-VAE encoding on CUDA, an offline feature-prep
step; here the same role is ``FeaturePrepDataset`` with a pluggable
``encode_fn`` (the VAE lives behind ``zigma_tpu_torch.data.vae``) and a
pluggable ``read_video_fn`` (default ``read_video_cv2``; OpenCV is imported
only when a video is read).
"""

from __future__ import annotations

import csv
import random
from typing import Callable, Optional, Sequence

import numpy as np

__all__ = [
    "center_crop_arr",
    "crop_video",
    "resize_video",
    "resize_scale_video",
    "center_crop_video",
    "center_crop_short_edge",
    "random_shift_crop",
    "normalize_video",
    "hflip_video",
    "to_float_video",
    "UCFCenterCropVideo",
    "CenterCropResizeVideo",
    "RandomHorizontalFlipVideo",
    "TemporalRandomCrop",
    "Compose",
    "get_transforms_video",
    "get_transforms_image",
    "FeaturePrepDataset",
    "read_video_cv2",
]


def read_video_cv2(path, *, rgb: bool = True) -> np.ndarray:
    """Decode a video container (mp4/avi/mov/...) to (T, C, H, W) uint8.

    The real-container decode path the reference gets from
    ``torchvision.io.read_video``/``av`` (datasets/video_utils.py:470-560),
    built on OpenCV's ``VideoCapture``.  Frames come out BGR from OpenCV; ``rgb=True`` (default)
    flips to RGB to match the reference's torchvision semantics.
    """
    import cv2  # deferred: keep the module importable without OpenCV

    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise IOError(f"cv2 could not open video {path!r}")
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[..., ::-1] if rgb else frame)
    cap.release()
    if not frames:
        raise ValueError(f"no decodable frames in {path!r}")
    return np.ascontiguousarray(
        np.stack(frames).transpose(0, 3, 1, 2))  # (T, H, W, C) -> (T, C, H, W)


def _resize_frame(frame_chw: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Bilinear resize one (C, H, W) float frame via PIL."""
    from PIL import Image

    h, w = size
    chans = []
    for c in frame_chw:
        img = Image.fromarray(c.astype(np.float32), mode="F")
        chans.append(np.asarray(img.resize((w, h), Image.BILINEAR)))
    return np.stack(chans)


def center_crop_arr(pil_image, image_size: int) -> np.ndarray:
    """ADM-style center crop (video_utils.py:15-35 / utils/train_utils.py:80-100):
    iterative 2x BOX downsize to <2*target, BICUBIC to scale, center crop."""
    from PIL import Image

    while min(*pil_image.size) >= 2 * image_size:
        pil_image = pil_image.resize(
            tuple(x // 2 for x in pil_image.size), resample=Image.BOX)
    scale = image_size / min(*pil_image.size)
    pil_image = pil_image.resize(
        tuple(round(x * scale) for x in pil_image.size), resample=Image.BICUBIC)
    arr = np.array(pil_image)
    crop_y = (arr.shape[0] - image_size) // 2
    crop_x = (arr.shape[1] - image_size) // 2
    return arr[crop_y:crop_y + image_size, crop_x:crop_x + image_size]


# --- functional clip ops (video_utils.py:48-196), clip = (T, C, H, W) ------


def crop_video(clip, i, j, h, w):
    return clip[..., i:i + h, j:j + w]


def resize_video(clip, target_size, _mode="bilinear"):
    return np.stack([_resize_frame(f, tuple(target_size)) for f in clip])


def resize_scale_video(clip, target_size, _mode="bilinear"):
    """Scale so the SHORT side hits min(target) (video_utils.py:68-78)."""
    H, W = clip.shape[-2:]
    scale = min(target_size) / min(H, W)
    return resize_video(clip, (round(H * scale), round(W * scale)))


def center_crop_video(clip, crop_size):
    th, tw = (crop_size, crop_size) if isinstance(crop_size, int) else crop_size
    H, W = clip.shape[-2:]
    if H < th or W < tw:
        raise ValueError("clip smaller than crop size")
    return crop_video(clip, (H - th) // 2, (W - tw) // 2, th, tw)


def center_crop_short_edge(clip):
    H, W = clip.shape[-2:]
    s = min(H, W)
    return crop_video(clip, (H - s) // 2, (W - s) // 2, s, s)


def random_shift_crop(clip, rng: Optional[random.Random] = None):
    rng = rng or random
    H, W = clip.shape[-2:]
    s = min(H, W)
    i = rng.randint(0, H - s) if H != s else 0
    j = rng.randint(0, W - s) if W != s else 0
    return crop_video(clip, i, j, s, s)


def to_float_video(clip_uint8):
    return np.asarray(clip_uint8, np.float32) / 255.0


def normalize_video(clip, mean, std):
    mean = np.asarray(mean, np.float32).reshape(1, -1, 1, 1)
    std = np.asarray(std, np.float32).reshape(1, -1, 1, 1)
    return (clip - mean) / std


def hflip_video(clip):
    return clip[..., ::-1]


# --- transform classes (video_utils.py:198-467) -----------------------------


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class UCFCenterCropVideo:
    """Short-edge scale then center crop (video_utils.py:279-316)."""

    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, clip):
        clip = resize_scale_video(clip, self.size)
        return center_crop_video(clip, self.size)


class CenterCropResizeVideo:
    """Center crop to short edge then resize (video_utils.py:237-276)."""

    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, clip):
        return resize_video(center_crop_short_edge(clip), self.size)


class RandomHorizontalFlipVideo:
    def __init__(self, p: float = 0.5, rng: Optional[random.Random] = None):
        self.p = p
        self.rng = rng or random

    def __call__(self, clip):
        return hflip_video(clip) if self.rng.random() < self.p else clip


class TemporalRandomCrop:
    """Random [begin, end) window of the given size (video_utils.py:453-467)."""

    def __init__(self, size: int, rng: Optional[random.Random] = None):
        self.size = size
        self.rng = rng or random

    def __call__(self, total_frames: int):
        rand_end = max(0, total_frames - self.size - 1)
        begin = self.rng.randint(0, rand_end) if rand_end > 0 else 0
        return begin, min(begin + self.size, total_frames)


def get_transforms_video(resolution: int = 256) -> Compose:
    """(video_utils.py:562-573): to float, random hflip, UCF center crop,
    normalize to [-1, 1]."""
    return Compose([
        to_float_video,
        RandomHorizontalFlipVideo(),
        UCFCenterCropVideo(resolution),
        lambda c: normalize_video(c, [0.5, 0.5, 0.5], [0.5, 0.5, 0.5]),
    ])


def get_transforms_image(image_size: int = 256, flip: bool = True,
                         rng: Optional[random.Random] = None) -> Compose:
    """(video_utils.py:576-587) for PIL input -> (C, H, W) in [-1, 1].

    ``flip=False`` for OFFLINE feature prep: a random flip baked into
    precomputed latents would make shards nondeterministic and freeze the
    augmentation (the reference flips per-epoch on raw pixels)."""
    rng = rng or random

    def prep(pil_image):
        arr = center_crop_arr(pil_image, image_size)
        if flip and rng.random() < 0.5:
            arr = arr[:, ::-1]
        arr = np.transpose(arr, (2, 0, 1)).astype(np.float32) / 255.0
        return (arr - 0.5) / 0.5

    return Compose([prep])


class FeaturePrepDataset:
    """CSV-driven video -> latent feature preparation
    (the reference's DatasetFromCSV, video_utils.py:470-560).

    csv rows: path, text, cls_id.  ``read_video_fn(path) -> (T, C, H, W)
    uint8`` (default: ``read_video_cv2`` — real container decode) and
    ``encode_fn(frames_float) -> latents`` are injectable — the reference
    hardcodes torchvision.io and a CUDA SD-VAE.
    """

    def __init__(self, csv_path: str, read_video_fn: Optional[Callable] = None,
                 encode_fn: Optional[Callable] = None, num_frames: int = 16,
                 frame_interval: int = 1, transform: Optional[Callable] = None,
                 seed: int = 0):
        with open(csv_path) as f:
            self.samples = list(csv.reader(f))
        self.read_video_fn = read_video_fn or read_video_cv2
        self.encode_fn = encode_fn
        self.num_frames = num_frames
        self.transform = transform or get_transforms_video()
        rng = random.Random(seed)
        self.temporal_sample = TemporalRandomCrop(
            num_frames * frame_interval, rng=rng)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index: int) -> dict:
        path, text, cls_id = self.samples[index][:3]
        vframes = np.asarray(self.read_video_fn(path))
        start, end = self.temporal_sample(len(vframes))
        if end - start < self.num_frames:
            raise ValueError(f"video {path} too short: {len(vframes)} frames")
        idx = np.linspace(start, end - 1, self.num_frames).astype(int)
        video = self.transform(vframes[idx])
        try:  # the reference never converts the id column; tolerate strings
            cls_val = int(cls_id)
        except (TypeError, ValueError):
            cls_val = cls_id
        out = {"video": video, "text": text, "cls_id": cls_val}
        if self.encode_fn is not None:
            out["frame_feature256"] = np.asarray(self.encode_fn(video))
        return out
