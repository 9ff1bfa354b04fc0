from zigma_tpu_torch.transport.integrators import (odeint_dopri5,
                                                   odeint_fixed, sdeint)
from zigma_tpu_torch.transport.transport import (ModelType, PathType, Sampler,
                                                 Transport, WeightType,
                                                 create_transport)

__all__ = ["odeint_dopri5", "odeint_fixed", "sdeint", "ModelType", "PathType",
           "Sampler", "Transport", "WeightType", "create_transport"]
