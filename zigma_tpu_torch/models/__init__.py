from zigma_tpu_torch.models.embedders import (CaptionEmbedder, LabelEmbedder,
                                              PatchEmbed, TimestepEmbedder,
                                              get_2d_sincos_pos_embed)
from zigma_tpu_torch.models.mamba import Mamba, MambaCache
from zigma_tpu_torch.models.mamba2 import Mamba2, Mamba2Cache
from zigma_tpu_torch.models.zigma import (ZIGMA_PRESETS, CrossAttention,
                                          FinalLayer, ZigMa, ZigMaBlock,
                                          zigma_flops, zigma_model)

__all__ = ["CaptionEmbedder", "LabelEmbedder", "PatchEmbed",
           "TimestepEmbedder", "get_2d_sincos_pos_embed", "Mamba",
           "MambaCache", "Mamba2", "Mamba2Cache", "ZIGMA_PRESETS",
           "CrossAttention", "FinalLayer", "ZigMa", "ZigMaBlock",
           "zigma_flops", "zigma_model"]
