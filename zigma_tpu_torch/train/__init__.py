from zigma_tpu_torch.train.checkpoints import (latest_checkpoint,
                                               restore_checkpoint,
                                               save_checkpoint)
from zigma_tpu_torch.train.state import (LATENT_SCALE, CapturedChain,
                                         TrainState, create_optimizer,
                                         make_diffusion_loss_fn, train_chain,
                                         train_step, update_ema)

__all__ = ["LATENT_SCALE", "TrainState", "create_optimizer",
           "make_diffusion_loss_fn", "train_step", "train_chain",
           "CapturedChain", "update_ema", "latest_checkpoint",
           "restore_checkpoint", "save_checkpoint"]
