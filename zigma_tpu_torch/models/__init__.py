from zigma_tpu_torch.models.mamba import Mamba
from zigma_tpu_torch.models.zigma import (ZIGMA_PRESETS, FinalLayer, ZigMa,
                                          ZigMaBlock, zigma_flops)

__all__ = ["Mamba", "ZIGMA_PRESETS", "FinalLayer", "ZigMa", "ZigMaBlock",
           "zigma_flops"]
