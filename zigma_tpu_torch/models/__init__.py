from zigma_tpu_torch.models.mamba import Mamba
from zigma_tpu_torch.models.mamba2 import Mamba2
from zigma_tpu_torch.models.zigma import (ZIGMA_PRESETS, CrossAttention,
                                          FinalLayer, ZigMa, ZigMaBlock,
                                          zigma_flops)

__all__ = ["Mamba", "Mamba2", "ZIGMA_PRESETS", "CrossAttention", "FinalLayer",
           "ZigMa", "ZigMaBlock", "zigma_flops"]
