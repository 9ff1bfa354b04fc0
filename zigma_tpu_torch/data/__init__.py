"""The data path: webdataset shards, video transforms, the SD-VAE codec and
the CLIP text tower (counterpart of ``zigma_tpu/data``)."""

from zigma_tpu_torch.data.vae import (LATENT_SCALE, IdentityCodec, LatentCodec,
                                      VAECodec, decode_maybe_video, get_codec)
from zigma_tpu_torch.data.video import (
    Compose,
    FeaturePrepDataset,
    TemporalRandomCrop,
    UCFCenterCropVideo,
    center_crop_arr,
    get_transforms_image,
    get_transforms_video,
)
from zigma_tpu_torch.data.wds import (
    WebDataModuleFromConfig,
    WebDatasetReader,
    brace_expand,
    default_decoder,
    dict_collation_fn,
    list_shards,
    make_image_transform,
    split_by_host,
    tar_samples,
)

__all__ = [
    "LATENT_SCALE",
    "IdentityCodec",
    "LatentCodec",
    "VAECodec",
    "get_codec",
    "decode_maybe_video",
    "Compose",
    "FeaturePrepDataset",
    "TemporalRandomCrop",
    "UCFCenterCropVideo",
    "center_crop_arr",
    "get_transforms_image",
    "get_transforms_video",
    "WebDataModuleFromConfig",
    "WebDatasetReader",
    "brace_expand",
    "default_decoder",
    "dict_collation_fn",
    "list_shards",
    "make_image_transform",
    "split_by_host",
    "tar_samples",
]
