from zigma_tpu_torch.convert.from_jax import (clip_state_dict_from_jax,
                                              state_dict_from_jax,
                                              vae_state_dict_from_jax)

__all__ = ["state_dict_from_jax", "vae_state_dict_from_jax",
           "clip_state_dict_from_jax"]
