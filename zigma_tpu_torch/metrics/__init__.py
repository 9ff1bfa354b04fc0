"""Sample-quality metrics and their feature nets (counterpart of
``zigma_tpu/metrics``): FID / sFID / KID / IS / PRDC / FDD / FVD, PSNR /
SSIM / LPIPS, the Inception, DINOv2, I3D and AlexNet-LPIPS nets as torch
modules, and the CLIs' metric menu."""

from zigma_tpu_torch.metrics.frechet import RunningMoments, frechet_distance
from zigma_tpu_torch.metrics.distributional import inception_score, kid, prdc
from zigma_tpu_torch.metrics.pixel import psnr, ssim, video_metric_per_timestep
from zigma_tpu_torch.metrics.features import (
    NetExtractor,
    available_extractors,
    get_extractor,
    patch_statistics_extractor,
    register_extractor,
    video_patch_statistics_extractor,
)
from zigma_tpu_torch.metrics.facade import MyMetric, VideoMetric, to_uint8_images
from zigma_tpu_torch.metrics.menu import (MetricSuite, build_metric_suite,
                                          validate_choices)
# the nets' modules (``metrics.lpips`` is the module; its distance is
# ``metrics.lpips.lpips``)
from zigma_tpu_torch.metrics import dinov2, i3d, inception, lpips

__all__ = [
    "RunningMoments",
    "frechet_distance",
    "inception_score",
    "kid",
    "prdc",
    "psnr",
    "ssim",
    "video_metric_per_timestep",
    "NetExtractor",
    "available_extractors",
    "get_extractor",
    "patch_statistics_extractor",
    "register_extractor",
    "video_patch_statistics_extractor",
    "MyMetric",
    "VideoMetric",
    "MetricSuite",
    "build_metric_suite",
    "validate_choices",
    "to_uint8_images",
    "inception",
    "i3d",
    "dinov2",
    "lpips",
]
