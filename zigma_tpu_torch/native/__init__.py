from zigma_tpu_torch.native.tar_reader import (NativeTar, available,
                                               native_tar_samples)

__all__ = ["NativeTar", "available", "native_tar_samples"]
