from zigma_tpu_torch.convert.from_jax import state_dict_from_jax

__all__ = ["state_dict_from_jax"]
