from zigma_tpu_torch.utils.inference import cast_for_inference

__all__ = ["cast_for_inference"]
