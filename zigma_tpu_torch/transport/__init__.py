from zigma_tpu_torch.transport.integrators import odeint_fixed
from zigma_tpu_torch.transport.transport import (ModelType, PathType, Sampler,
                                                 Transport, WeightType,
                                                 create_transport)

__all__ = ["odeint_fixed", "ModelType", "PathType", "Sampler", "Transport",
           "WeightType", "create_transport"]
